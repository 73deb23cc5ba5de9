"""Symbol→Symbol graph-rewrite pass framework (GL6xx provenance contract).

Counterpart of ``mxnet_tpu/analysis/rewrite.py``, whole: a pass manager
that rewrites a Symbol into an equivalent, cleaner Symbol at bind time,
with every change provenance-tracked and statically verifiable.

Passes (run to fixpoint, ``MXNET_GRAPHREWRITE_ROUNDS`` budget):

* ``const_fold``   — subgraphs whose leaves are all init ops (``_zeros``,
  ``_arange``, ...) evaluate ONCE, on the CPU through the port's plain ops,
  into a ``_graph_const`` node; the executor uploads that literal to the
  bind's device once and never recomputes the subgraph.
* ``cse``          — common-subexpression elimination over a canonical
  node-signature hash ``(op, frozen attrs, input entries)``; stateful ops
  (aux, rng) and program-output nodes never merge.
* ``canonicalize`` — normalizes computationally-identical spellings into
  the forms ``ops/fusion_patterns.py`` matchers expect (``x*x`` →
  ``square``, positive reduction axes → negative, bare ``relu`` →
  ``Activation``, ``1/sqrt`` → ``rsqrt``, scalar-identity/_copy elision).
* ``bf16``         — dtype legalization (opt-in,
  ``MXNET_GRAPHREWRITE_BF16=1``): cast-sandwiches the operands declared in
  ``ops/infer_meta.py`` ``bf16_slots``. A graph pass only. A planned conv
  then gets bfloat16 x and w with no BN prologue to fold (a Cast stands
  between), and its inference forward runs the stats-free kernel's bf16
  form, as the JAX package runs its kernel on those operands. Every kernel
  takes bfloat16 (its bf16 form: the conv+BN, ``matmul_bias_act``,
  flash-attention and LayerNorm kernels forward and backward, and
  ``matmul_stats``), so a cast reaches a kernel on the card wherever it
  reaches one in the graph.
* ``dce``          — sweeps nodes the other passes orphaned.

Every firing emits a provenance record ``{pass, rule, action, node,
origins}``; ``verify_rewrite`` checks them statically (GL601-GL605).

Gate: ``MXNET_GRAPHREWRITE=0|on|verify`` (default ``0``), as in the JAX
package, with one departure: under ``0`` every bind still runs ``cse``,
``mul_self_to_square`` and ``dce`` (``_ALWAYS_ON``). The transformer zoo's
LayerNorm is written naively on purpose (a duplicate mean and centre, and
``x*x`` for the square), and only after those rules does it match the
``norm_residual`` pattern whose kernel the port's paths launch, so a
failure of them raises; under ``on|verify`` a failed pipeline binds the
original graph, as in the JAX package. Telemetry:
``rewrite.runs``, ``rewrite.nodes_folded/merged/removed``,
``rewrite.casts_inserted``, ``rewrite.fallbacks`` and a ``rewrite.pass``
span per pass.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..base import MXNetError, np_dtype
from ..ops.infer_meta import get_meta
from ..symbol import Symbol, _Node, _freeze, _topo_order
from .diagnostics import Diagnostic, Report
from .. import telemetry as _tm

__all__ = ["rewrite", "verify_rewrite", "graphrewrite_mode", "RewritePass",
           "RewriteResult", "rewrite_pass_names", "pattern_site_counts",
           "rewrite_for_bind"]

_LOG = logging.getLogger("mxnet_tpu.graphrewrite")

#: constant-fold result cap: a folded literal larger than this stays
#: unfolded (a resident literal would trade a cheap recompute for memory)
_FOLD_CAP_BYTES = 64 << 20


# --------------------------------------------------------------------- env
_warned_modes = set()


# copied from mxnet_tpu/analysis/rewrite.py (graphrewrite_mode; backend-free)
def graphrewrite_mode() -> Optional[str]:
    """The ``MXNET_GRAPHREWRITE`` knob: ``None`` (off, the default),
    ``"on"`` (rewrite at bind), or ``"verify"`` (rewrite + GL6xx verifier
    per bind, raising on GL601/GL602/GL604). Boolean-style truthy values
    mean ``on``; anything unrecognized warns once and stays off."""
    raw = os.environ.get("MXNET_GRAPHREWRITE", "0").strip().lower()
    if raw == "verify":
        return "verify"
    if raw in ("on", "1", "true"):
        return "on"
    if raw not in ("", "0", "false", "off") and raw not in _warned_modes:
        _warned_modes.add(raw)
        _LOG.warning("MXNET_GRAPHREWRITE=%r is not a recognized mode "
                     "(0|on|verify); graph rewrites stay OFF", raw)
    return None


def _bf16_enabled() -> bool:
    return os.environ.get("MXNET_GRAPHREWRITE_BF16", "0").strip() == "1"


def _max_rounds() -> int:
    raw = os.environ.get("MXNET_GRAPHREWRITE_ROUNDS", "").strip()
    try:
        v = int(raw) if raw else 4
        return v if v > 0 else 4
    except ValueError:
        return 4


# ------------------------------------------------------------ working graph
class _RGraph:
    """The mutable working copy one rewrite pipeline operates on.

    Cloned from the input Symbol so rewrites never touch the caller's
    graph. Tracks every pass-created node (``created``) and every
    provenance record (``records``); ``live`` is the node set as of the
    last DCE sweep."""

    def __init__(self, symbol: Symbol, shapes=None, types=None):
        mapping = {}
        for node in symbol._topo():
            clone = _Node(node.op, node.name, dict(node.attrs),
                          [(mapping[id(i)], oi) for i, oi in node.inputs])
            mapping[id(node)] = clone
        self.outputs: List[Tuple[_Node, int]] = [
            (mapping[id(n)], oi) for n, oi in symbol._outputs]
        self.shapes = dict(shapes or {})
        self.types = dict(types or {})
        self.records: List[dict] = []
        self.created: Dict[int, _Node] = {}
        self.live: List[_Node] = self.topo()
        self.counts = {"folded": 0, "merged": 0, "removed": 0, "casts": 0}
        self._infer_cache = None

    def _heads(self):
        seen, heads = set(), []
        for node, _ in self.outputs:
            if id(node) not in seen:
                seen.add(id(node))
                heads.append(node)
        return heads

    def topo(self) -> List[_Node]:
        return _topo_order(self._heads())

    def output_ids(self):
        return {id(n) for n, _ in self.outputs}

    def symbol(self) -> Symbol:
        return Symbol(list(self.outputs))

    def invalidate(self):
        self._infer_cache = None

    def infer(self):
        """(entry_shape, entry_dtype) tables for the CURRENT graph, via the
        lint propagation pass (an uninferrable node reads None). Cached
        until ``invalidate()``."""
        if self._infer_cache is None:
            from .manager import GraphContext
            from .shape_lint import propagate

            ctx = GraphContext(self.symbol(), shape_hints=self.shapes,
                               type_hints=self.types, strict_shapes=False)
            propagate(ctx)
            self._infer_cache = (ctx.entry_shape, ctx.entry_dtype)
        return self._infer_cache

    def new_node(self, op, name, attrs, inputs) -> _Node:
        node = _Node(op, name, dict(attrs or {}), list(inputs))
        self.created[id(node)] = node
        return node

    def apply_entry_map(self, entry_map, skip_nodes=()):
        """Rewire every input edge and output head through ``entry_map``
        ({(id(old), oi): (new_node, new_oi)}), following chains. Nodes in
        ``skip_nodes`` keep their inputs verbatim (a cast inserted AFTER a
        node must keep reading that node, not itself)."""
        if not entry_map:
            return

        def resolve(entry):
            seen = set()
            while (id(entry[0]), entry[1]) in entry_map:
                key = (id(entry[0]), entry[1])
                if key in seen:  # a cyclic map would hang
                    break
                seen.add(key)
                entry = entry_map[key]
            return entry

        skip = {id(n) for n in skip_nodes}
        # the reachable set PLUS every pass-created node: a node created
        # mid-pass copied its inputs before the map existed
        nodes = {id(n): n for n in self.topo()}
        for n in self.created.values():
            nodes.setdefault(id(n), n)
        for node in nodes.values():
            if id(node) in skip:
                continue
            node.inputs = [resolve(e) for e in node.inputs]
        self.outputs = [resolve(e) for e in self.outputs]
        self.invalidate()

    def note(self, pass_name, rule, action, node=None, origins=(), **extra):
        rec = {"pass": pass_name, "rule": rule, "action": action,
               "node": node, "origins": list(origins)}
        rec.update(extra)
        self.records.append(rec)


class RewritePass:
    """One rewrite pass: ``run(g)`` mutates the working graph and returns
    the number of rule firings (0 = nothing to do, the fixpoint signal).
    Tests may hand ``rewrite(passes=[...])`` custom instances to exercise
    the verifier."""

    name = "<unnamed>"

    def run(self, g: _RGraph) -> int:  # pragma: no cover - interface
        raise NotImplementedError


# ------------------------------------------------------------- const_fold
def _is_pure(opdef):
    return (not opdef.needs_rng and not opdef.has_aux
            and not opdef.needs_train_flag)


class ConstFoldPass(RewritePass):
    """Evaluate init-op-only subgraphs once, on the CPU.

    A node is *const* when it is an op node, pure (no rng/aux/train flag),
    and every input is const — the induction grounds out at the zero-input
    init ops. Variables are NEVER const. The fold frontier — a const node
    with a non-const consumer or a program output — becomes one
    ``_graph_const`` literal; the upstream const chain is swept by DCE."""

    name = "const_fold"

    def run(self, g: _RGraph) -> int:
        topo = g.topo()
        const: Dict[int, bool] = {}
        consumers: Dict[int, list] = {}
        for node in topo:
            for inp, oi in node.inputs:
                consumers.setdefault(id(inp), []).append(node)
        for node in topo:
            if node.is_variable or node.op == "_graph_const":
                const[id(node)] = False
                continue
            try:
                opdef = node.opdef()
            except MXNetError:
                const[id(node)] = False
                continue
            const[id(node)] = (_is_pure(opdef)
                               and all(const[id(i)] for i, _ in node.inputs))
        out_ids = g.output_ids()
        vals: Dict[Tuple[int, int], torch.Tensor] = {}

        def value(entry):
            node, oi = entry
            key = (id(node), oi)
            if key not in vals:
                ins = [value(e) for e in node.inputs]
                # the plain ops on the CPU: an init op allocates on the
                # current default device, so pin it here
                with torch.device("cpu"), torch.no_grad():
                    outs, _ = node.opdef().apply(node.parsed_attrs(), ins, aux=[],
                                                 is_train=False, rng=None)
                for i, o in enumerate(outs):
                    vals[(id(node), i)] = o
            return vals[key]

        entry_map, fired = {}, 0
        for node in topo:
            if not const[id(node)] or not node.inputs:
                continue  # a bare init op is already a single leaf
            if node.num_outputs() != 1:
                continue
            boundary = (id(node) in out_ids
                        or any(not const[id(c)]
                               for c in consumers.get(id(node), [])))
            if not boundary:
                continue  # an interior const node folds into its consumer
            try:
                arr = np.ascontiguousarray(value((node, 0)).numpy())
            except Exception as exc:  # a fold failure must never sink a bind
                _LOG.warning("const_fold: evaluating %r failed (%s); left "
                             "unfolded", node.name, exc)
                continue
            if arr.nbytes > _FOLD_CAP_BYTES:
                continue
            # the literal takes the folded node's NAME: a program-output
            # entry keeps its output name
            lit = g.new_node(
                "_graph_const", node.name,
                {"data": arr.tobytes(), "shape": tuple(arr.shape),
                 "dtype": arr.dtype.name}, [])
            entry_map[(id(node), 0)] = (lit, 0)
            g.note(self.name, "fold", "fold", node=lit.name,
                   origins=[node.name])
            g.counts["folded"] += 1
            fired += 1
        g.apply_entry_map(entry_map)
        return fired


# -------------------------------------------------------------------- cse
class CSEPass(RewritePass):
    """Merge op nodes with identical canonical signatures
    ``(op, frozen attrs, input entries)``, in one topo walk with
    incremental rewiring, so chains of duplicates (dup mean → dup center)
    collapse in a single pass. Stateful ops (aux, rng) never merge, and a
    node whose value is a program output keeps its identity."""

    name = "cse"

    def run(self, g: _RGraph) -> int:
        canon: Dict[tuple, _Node] = {}
        entry_map, fired = {}, 0
        out_ids = g.output_ids()

        def resolve(entry):
            while (id(entry[0]), entry[1]) in entry_map:
                entry = entry_map[(id(entry[0]), entry[1])]
            return entry

        for node in g.topo():
            node.inputs = [resolve(e) for e in node.inputs]
            if node.is_variable:
                continue
            try:
                opdef = node.opdef()
            except MXNetError:
                continue
            if opdef.needs_rng or opdef.has_aux:
                continue
            if node.op == "_graph_const":
                continue  # each folded literal is identity-unique
            try:
                key = (node.op, _freeze(node.parsed_attrs()),
                       tuple((id(i), oi) for i, oi in node.inputs))
                hash(key)
            except Exception:
                continue  # unhashable attr payloads opt the node out
            prev = canon.get(key)
            if prev is None:
                canon[key] = node
            elif id(node) not in out_ids:
                for i in range(node.num_outputs()):
                    entry_map[(id(node), i)] = (prev, i)
                g.note(self.name, "merge", "merge", node=prev.name,
                       origins=[node.name])
                g.counts["merged"] += 1
                fired += 1
        g.apply_entry_map(entry_map)
        return fired


# ----------------------------------------------------------- canonicalize
def _same_entry(a, b):
    return a[0] is b[0] and a[1] == b[1]


class CanonicalizePass(RewritePass):
    """Normalize computationally-identical spellings into the canonical
    forms the fusion-pattern matchers expect (JAX :382-494):

    * ``mul_self_to_square``  — ``elemwise_mul(x, x)`` / ``broadcast_mul``
      of one entry with itself → ``square(x)``.
    * ``negative_axis``       — positive reduction axes on ``mean``/``sum``
      (known rank) → the negative canonical form.
    * ``relu_to_activation``  — the bare ``relu`` op → ``Activation
      (act_type=relu)``.
    * ``rsqrt_compose``       — ``reciprocal(sqrt(x))`` and ``1/sqrt(x)``
      → ``rsqrt(x)``.
    * ``identity_elide``      — ``_mul_scalar/_div_scalar`` by 1.0 and
      ``_copy`` vanish (``_plus_scalar`` 0.0 is NOT elided: ``-0.0 + 0.0``
      flips the sign bit).

    ``rules`` is the set of rules the pass fires (a subclass narrows it:
    the port's always-on pipeline runs ``mul_self_to_square`` alone)."""

    name = "canonicalize"

    _REDUCES = ("mean", "sum", "sum_axis", "max", "max_axis", "min",
                "min_axis", "prod", "nansum", "nanprod")
    rules = frozenset(("mul_self_to_square", "negative_axis", "relu_to_activation",
                       "rsqrt_compose", "identity_elide"))

    def run(self, g: _RGraph) -> int:
        entry_map, fired = {}, 0
        out_ids = g.output_ids()
        on = self.rules.__contains__
        shapes, dtypes = ({}, {})
        if on("negative_axis") or on("identity_elide"):
            shapes, dtypes = g.infer()

        for node in g.topo():
            if node.is_variable:
                continue
            try:
                parsed = node.parsed_attrs()
            except Exception:
                continue

            # mul(x, x) -> square(x)
            if (on("mul_self_to_square")
                    and node.op in ("elemwise_mul", "broadcast_mul")
                    and len(node.inputs) == 2
                    and _same_entry(node.inputs[0], node.inputs[1])):
                sq = g.new_node("square", node.name, {}, [node.inputs[0]])
                entry_map[(id(node), 0)] = (sq, 0)
                g.note(self.name, "mul_self_to_square", "replace",
                       node=sq.name, origins=[node.name])
                fired += 1
                continue

            # positive reduction axis -> negative canonical form
            if on("negative_axis") and node.op in self._REDUCES and node.inputs:
                ax = parsed.get("axis")
                in_sh = shapes.get((id(node.inputs[0][0]), node.inputs[0][1]))
                if (ax and in_sh is not None
                        and any(a >= 0 for a in ax)
                        and all(-len(in_sh) <= a < len(in_sh) for a in ax)):
                    neg = tuple(a - len(in_sh) if a >= 0 else a for a in ax)
                    node.attrs["axis"] = str(neg if len(neg) > 1 else neg[0])
                    node._parsed = None
                    g.note(self.name, "negative_axis", "attr",
                           node=node.name, origins=[node.name])
                    fired += 1
                continue

            # bare relu op -> Activation(act_type=relu)
            if on("relu_to_activation") and node.op == "relu":
                act = g.new_node("Activation", node.name,
                                 {"act_type": "relu"}, list(node.inputs))
                entry_map[(id(node), 0)] = (act, 0)
                g.note(self.name, "relu_to_activation", "replace",
                       node=act.name, origins=[node.name])
                fired += 1
                continue

            # reciprocal(sqrt(x)) / 1/sqrt(x) -> rsqrt(x)
            recip = on("rsqrt_compose") and (
                node.op == "reciprocal"
                or (node.op == "_rdiv_scalar" and parsed.get("scalar") == 1.0))
            if recip and node.inputs and node.inputs[0][1] == 0:
                prod = node.inputs[0][0]
                if not prod.is_variable and prod.op == "sqrt":
                    rs = g.new_node("rsqrt", node.name, {},
                                    list(prod.inputs))
                    entry_map[(id(node), 0)] = (rs, 0)
                    g.note(self.name, "rsqrt_compose", "replace",
                           node=rs.name, origins=[node.name, prod.name])
                    fired += 1
                    continue

            # identity ops vanish (never a program output, and never when
            # the op changed the dtype: int32 * 1.0 promotes to float32)
            elide = on("identity_elide") and (
                node.op == "_copy"
                or (node.op in ("_mul_scalar", "_div_scalar")
                    and parsed.get("scalar") == 1.0))
            if elide and node.inputs:
                in_dt = dtypes.get((id(node.inputs[0][0]),
                                    node.inputs[0][1]))
                out_dt = dtypes.get((id(node), 0))
                if in_dt is None or out_dt is None \
                        or np.dtype(in_dt) != np.dtype(out_dt):
                    elide = False
            if elide and id(node) not in out_ids and node.inputs:
                entry_map[(id(node), 0)] = node.inputs[0]
                # counts["removed"] is DCE's alone
                g.note(self.name, "identity_elide", "remove",
                       origins=[node.name])
                fired += 1
        g.apply_entry_map(entry_map)
        return fired


# ------------------------------------------------------------------- bf16
class Bf16LegalizePass(RewritePass):
    """Cast-sandwich dtype legalization: every f32 input slot an op
    declares in ``ops/infer_meta.py`` ``bf16_slots`` gets a
    ``Cast(bfloat16)``, and the op's output a ``Cast(float32)``, so every
    downstream dtype is unchanged (GL601-clean by construction). Opt-in via
    ``MXNET_GRAPHREWRITE_BF16=1``; idempotent (legalized nodes carry a
    ``__bf16_legalized__`` marker attr). A graph pass only (JAX :496)."""

    name = "bf16"

    def run(self, g: _RGraph) -> int:
        fired = 0
        shapes_tbl, dtypes = g.infer()
        entry_map, out_casts = {}, []
        out_ids = g.output_ids()
        for node in list(g.topo()):
            if node.is_variable or node.attrs.get("__bf16_legalized__"):
                continue
            if id(node) in out_ids:
                continue  # the f32out cast would rename the output entry
            meta = get_meta(node.op)
            if not meta.bf16_slots or node.num_outputs() != 1:
                continue
            try:
                parsed = node.parsed_attrs()
                slots = node.opdef().input_names(parsed)
            except Exception:
                continue
            cast_idx = []
            for i, slot in enumerate(slots[:len(node.inputs)]):
                if slot not in meta.bf16_slots:
                    continue
                dt = dtypes.get((id(node.inputs[i][0]), node.inputs[i][1]))
                if dt is not None and np.dtype(dt) == np.dtype(np.float32):
                    cast_idx.append(i)
            out_dt = dtypes.get((id(node), 0))
            if not cast_idx or out_dt is None \
                    or np.dtype(out_dt) != np.dtype(np.float32):
                continue
            for i in cast_idx:
                src, src_oi = node.inputs[i]
                if src.is_variable and "__shape__" not in src.attrs:
                    # the Cast hides this variable from the consumer's
                    # backward shape rule: stamp the shape inferred now
                    known = shapes_tbl.get((id(src), src_oi))
                    if known is not None:
                        src.attrs["__shape__"] = str(tuple(known))
                cast = g.new_node("Cast", "%s_bf16in%d" % (node.name, i),
                                  {"dtype": "bfloat16"}, [node.inputs[i]])
                node.inputs[i] = (cast, 0)
                g.note(self.name, "cast_in", "insert", node=cast.name,
                       origins=[node.name])
                g.counts["casts"] += 1
            node.attrs["__bf16_legalized__"] = "1"
            node._parsed = None
            back = g.new_node("Cast", node.name + "_f32out",
                              {"dtype": "float32"}, [(node, 0)])
            g.note(self.name, "cast_out", "insert", node=back.name,
                   origins=[node.name])
            g.counts["casts"] += 1
            entry_map[(id(node), 0)] = (back, 0)
            out_casts.append(back)
            fired += 1
        g.apply_entry_map(entry_map, skip_nodes=out_casts)
        return fired


# -------------------------------------------------------------------- dce
class DCEPass(RewritePass):
    """Sweep what the other passes orphaned: anything in ``live`` no longer
    reachable from the outputs is counted (with a provenance record), so
    GL605's removed total is exact."""

    name = "dce"

    def run(self, g: _RGraph) -> int:
        reach = {id(n) for n in g.topo()}
        removed = [n for n in g.live if id(n) not in reach]
        for n in removed:
            g.note(self.name, "unreachable", "remove", origins=[n.name])
            g.counts["removed"] += 1
        g.live = g.topo()
        return len(removed)


class _SquareOnly(CanonicalizePass):
    """``canonicalize`` narrowed to ``mul_self_to_square``."""

    rules = frozenset(("mul_self_to_square",))


_BUILTIN = {p.name: p for p in
            (ConstFoldPass(), CSEPass(), CanonicalizePass(),
             Bf16LegalizePass(), DCEPass())}
#: default pipeline order (bf16 joins before dce when enabled)
_DEFAULT_ORDER = ("const_fold", "cse", "canonicalize", "dce")
#: what every bind runs under MXNET_GRAPHREWRITE=0 (the port's departure)
_ALWAYS_ON = (_BUILTIN["cse"], _SquareOnly(), _BUILTIN["dce"])


def rewrite_pass_names():
    return tuple(_BUILTIN)


# ------------------------------------------------------------------ result
# copied from mxnet_tpu/analysis/rewrite.py (RewriteResult; backend-free)
class RewriteResult:
    """One pipeline run: the rewritten Symbol plus everything the GL6xx
    verifier needs — the original, the provenance records, per-pass
    firing stats, created-node names, and the fixpoint outcome."""

    def __init__(self, original, symbol, records, counts, pass_fired,
                 created_names, nodes_before, nodes_after, rounds, fixpoint,
                 round_budget, shapes, types, label="", pass_rows=()):
        self.original = original
        self.symbol = symbol
        self.records = records
        self.counts = counts
        self.pass_fired = pass_fired        # {pass: total firings}
        self.created_names = created_names  # names of reachable new nodes
        self.nodes_before = nodes_before
        self.nodes_after = nodes_after
        self.rounds = rounds
        self.fixpoint = fixpoint
        self.round_budget = round_budget
        self.shapes = dict(shapes or {})
        self.types = dict(types or {})
        self.label = label
        # one row per pass execution: {round, pass, fired, nodes_before,
        # nodes_after}
        self.pass_rows = list(pass_rows)

    @property
    def changed(self) -> bool:
        return bool(self.records)

    def rule_table(self) -> Dict[str, int]:
        """fired-rule histogram: 'pass.rule' -> count."""
        table: Dict[str, int] = {}
        for r in self.records:
            key = "%s.%s" % (r["pass"], r["rule"])
            table[key] = table.get(key, 0) + 1
        return table

    def to_dict(self) -> dict:
        return {
            "label": self.label,
            "nodes_before": self.nodes_before,
            "nodes_after": self.nodes_after,
            "counts": dict(self.counts),
            "pass_fired": dict(self.pass_fired),
            "pass_rows": list(self.pass_rows),
            "rules": self.rule_table(),
            "rounds": self.rounds,
            "fixpoint": self.fixpoint,
        }


def rewrite(symbol, shapes=None, types=None, passes=None, bf16=None,
            max_rounds=None, label="") -> RewriteResult:
    """Run the rewrite pipeline over ``symbol`` and return a
    ``RewriteResult`` (the input Symbol is never mutated).

    ``shapes``/``types`` are the bind hints; they power the shape-dependent
    rules (axis canonicalization, bf16 slot dtypes) and the verifier.
    ``passes`` selects a subset by name (or supplies ``RewritePass``
    instances); default: const_fold → cse → canonicalize [→ bf16 when
    ``bf16``/``MXNET_GRAPHREWRITE_BF16=1``] → dce, iterated to fixpoint
    within ``max_rounds`` (``MXNET_GRAPHREWRITE_ROUNDS``, default 4)."""
    if bf16 is None:
        bf16 = _bf16_enabled()
    if passes is None:
        order = list(_DEFAULT_ORDER)
        if bf16:
            order.insert(-1, "bf16")
        selected = [_BUILTIN[n] for n in order]
    else:
        selected = []
        for p in passes:
            if isinstance(p, str):
                if p not in _BUILTIN:
                    raise ValueError("unknown rewrite pass %r; have: %s"
                                     % (p, sorted(_BUILTIN)))
                selected.append(_BUILTIN[p])
            else:
                selected.append(p)
    budget = max_rounds if max_rounds else _max_rounds()

    g = _RGraph(symbol, shapes=shapes, types=types)
    nodes_before = len(g.live)
    pass_fired = {p.name: 0 for p in selected}
    pass_rows = []
    rounds, fixpoint = 0, False
    if _tm.enabled():
        _tm.counter("rewrite.runs").inc()
    for rounds in range(1, budget + 1):
        round_fired = 0
        for p in selected:
            before = len(g.topo())
            sp = _tm.NULL_SPAN
            if _tm.enabled():
                sp = _tm.span("rewrite.pass", pass_name=p.name)
            with sp:
                n = p.run(g)
                sp.set(fired=n)
            pass_fired[p.name] += n
            round_fired += n
            if n:
                pass_rows.append({"round": rounds, "pass": p.name,
                                  "fired": n, "nodes_before": before,
                                  "nodes_after": len(g.topo())})
        if round_fired == 0:
            fixpoint = True
            break
    final = g.topo()
    reach = {id(n) for n in final}
    created_names = [n.name for i, n in g.created.items() if i in reach]
    if _tm.enabled():
        for key, counter in (("folded", "rewrite.nodes_folded"),
                             ("merged", "rewrite.nodes_merged"),
                             ("removed", "rewrite.nodes_removed"),
                             ("casts", "rewrite.casts_inserted")):
            if g.counts[key]:
                _tm.counter(counter).inc(g.counts[key])
    return RewriteResult(
        original=symbol, symbol=g.symbol(), records=g.records,
        counts=g.counts, pass_fired=pass_fired,
        created_names=created_names, nodes_before=nodes_before,
        nodes_after=len(final), rounds=rounds, fixpoint=fixpoint,
        round_budget=budget, shapes=shapes, types=types, label=label,
        pass_rows=pass_rows)


# ---------------------------------------------------------------- verifier
def _entry_tables(symbol, shapes, types):
    """Partial-mode shape/dtype inference: per-output (shape, dtype) lists.
    Never raises — an uninferrable graph returns Nones and the error."""
    try:
        res = symbol._infer_impl(
            {k: tuple(v) for k, v in (shapes or {}).items()},
            {k: np_dtype(v) for k, v in (types or {}).items()},
            partial=True)
    except Exception as exc:
        return None, None, str(exc)
    out_shapes, out_types = res[1], res[4]
    return list(out_shapes), list(out_types), None


def _node_bytes(symbol, shapes, types):
    """name -> total output bytes per node (0 when unknown)."""
    from .manager import GraphContext
    from .shape_lint import propagate

    try:
        ctx = GraphContext(symbol, shape_hints=shapes, type_hints=types,
                           strict_shapes=False)
        propagate(ctx)
    except Exception:
        return {}
    table = {}
    for node in ctx.topo:
        total = 0
        for i in range(node.num_outputs()):
            sh = ctx.entry_shape.get((id(node), i))
            dt = ctx.entry_dtype.get((id(node), i))
            if sh is not None:
                total += int(np.prod(sh)) * (np.dtype(dt).itemsize
                                             if dt is not None else 4)
        table[node.name] = table.get(node.name, 0) + total
    return table


# copied from mxnet_tpu/analysis/rewrite.py (verify_rewrite; backend-free)
def verify_rewrite(result: RewriteResult, grad_req=None,
                   target="") -> Report:
    """Statically check one ``RewriteResult`` against the GL6xx contract.

    ``grad_req`` (optional) is the bind's per-argument request — a dict
    ``{name: req}``, a str, or a list aligned with the ORIGINAL symbol's
    ``list_arguments()`` — and arms GL604. Returns a ``Report`` whose
    ``rewrite_summary`` carries the machine counts + bytes-saved."""
    rep = Report(target=target or result.label or "rewrite")
    orig, new = result.original, result.symbol

    # --- GL601: the output interface must be unchanged -------------------
    o_sh, o_dt, o_err = _entry_tables(orig, result.shapes, result.types)
    n_sh, n_dt, n_err = _entry_tables(new, result.shapes, result.types)
    if n_err is not None:
        rep.add(Diagnostic(
            "GL601", "rewritten graph fails shape/dtype inference: %s"
            % n_err,
            fix_hint="a rewrite pass emitted an unbindable node; run with "
                     "MXNET_GRAPHREWRITE=0 and report the pass"))
    elif o_err is None:
        if len(o_sh) != len(n_sh):
            rep.add(Diagnostic(
                "GL601", "rewrite changed the output count: %d -> %d"
                % (len(o_sh), len(n_sh))))
        else:
            names = orig.list_outputs()
            for i, (a, b, da, db) in enumerate(zip(o_sh, n_sh, o_dt, n_dt)):
                if (a is not None and b is not None and tuple(a) != tuple(b)) \
                        or (da is not None and db is not None
                            and np.dtype(da) != np.dtype(db)):
                    rep.add(Diagnostic(
                        "GL601",
                        "output %d (%s): shape/dtype %s/%s -> %s/%s"
                        % (i, names[i] if i < len(names) else "?",
                           a, getattr(da, "name", da),
                           b, getattr(db, "name", db)),
                        node=names[i] if i < len(names) else None))
    try:
        o_onames, n_onames = orig.list_outputs(), new.list_outputs()
    except Exception:
        o_onames = n_onames = None
    if o_onames is not None and o_onames != n_onames:
        rep.add(Diagnostic(
            "GL601",
            "rewrite changed output names: %s -> %s"
            % (o_onames, n_onames),
            fix_hint="a replacement that owns a program output must keep "
                     "the replaced node's name"))
    o_args, n_args = orig.list_arguments(), new.list_arguments()
    o_aux, n_aux = (orig.list_auxiliary_states(),
                    new.list_auxiliary_states())
    added = [a for a in n_args if a not in set(o_args)]
    if added or o_aux != n_aux or \
            [a for a in o_args if a in set(n_args)] != n_args:
        rep.add(Diagnostic(
            "GL601",
            "rewrite changed the argument interface: args %s -> %s, "
            "aux %s -> %s" % (o_args, n_args, o_aux, n_aux),
            fix_hint="rewrites may drop unused arguments but never add or "
                     "reorder them"))

    # --- GL604: eliminated arguments a grad_req still references ---------
    if grad_req is not None:
        if isinstance(grad_req, str):
            reqs = {n: grad_req for n in o_args}
        elif isinstance(grad_req, dict):
            reqs = dict(grad_req)
        else:
            reqs = dict(zip(o_args, grad_req))
        kept = set(n_args)
        for name in o_args:
            if name not in kept and reqs.get(name, "null") != "null":
                rep.add(Diagnostic(
                    "GL604",
                    "argument %r was eliminated by the rewrite but its "
                    "grad_req is %r — backward would write a gradient for "
                    "a value the program never computes"
                    % (name, reqs.get(name)),
                    node=name,
                    fix_hint="set grad_req='null' for %s or disable the "
                             "eliminating pass" % name))

    # --- GL602: every surviving created node needs an originating rule ---
    claimed = {r["node"] for r in result.records if r.get("node")}
    for name in result.created_names:
        if name not in claimed:
            rep.add(Diagnostic(
                "GL602",
                "node %r was created by a rewrite pass but no provenance "
                "record names it" % name, node=name,
                fix_hint="every pass must g.note() each node it creates"))

    # --- GL603: fixpoint budget ------------------------------------------
    if not result.fixpoint:
        rep.add(Diagnostic(
            "GL603",
            "pipeline still firing after %d round(s) (budget %d) — passes "
            "are ping-ponging or the budget is too small"
            % (result.rounds, result.round_budget),
            fix_hint="raise MXNET_GRAPHREWRITE_ROUNDS or report the "
                     "oscillating rule pair"))

    # --- GL605: the summary ----------------------------------------------
    summary = result.to_dict()
    if result.changed:
        # NET intermediate bytes eliminated: every origin of an eliminating
        # record, deduped by name, MINUS the bytes of surviving
        # pass-created nodes
        obytes = _node_bytes(orig, result.shapes, result.types)
        gone = set()
        for r in result.records:
            if r["action"] in ("fold", "merge", "remove"):
                gone.update(r["origins"])
        nbytes = _node_bytes(new, result.shapes, result.types)
        bytes_saved = max(0, sum(obytes.get(n, 0) for n in gone)
                          - sum(nbytes.get(n, 0)
                                for n in set(result.created_names)))
        summary["bytes_saved_estimate"] = int(bytes_saved)
        rep.add(Diagnostic(
            "GL605",
            "%d node(s) -> %d: %d folded, %d merged, %d removed, %d casts "
            "inserted (~%.1f KiB of per-step intermediates eliminated)"
            % (result.nodes_before, result.nodes_after,
               result.counts["folded"], result.counts["merged"],
               result.counts["removed"], result.counts["casts"],
               bytes_saved / 1024.0)))
    rep.rewrite_summary = summary
    return rep


# ------------------------------------------------------------ bind helper
def pattern_site_counts(symbol) -> Dict[str, int]:
    """Per-pattern fusion site counts the fusion engine would root on this
    symbol — the before/after metric of the canonicalization pass."""
    from .. import fusion

    plan = fusion.plan(symbol._topo(),
                       output_ids={id(n) for n, _ in symbol._outputs})
    return fusion.plan_sites(plan)[0]


def rewrite_for_bind(symbol, shapes, types, grad_req=None, target="bind"):
    """The ``executor.bind``/``SPMDStepAdapter`` hook: ``(symbol to bind,
    RewriteResult or None)``. A rewrite whose argument interface drifted is
    abandoned and the ORIGINAL is bound (positional binds depend on it).

    Under ``MXNET_GRAPHREWRITE=on|verify`` the whole pipeline runs, as in
    the JAX package, and a failure of it binds the original graph;
    ``verify`` runs the GL6xx verifier and raises ``MXNetError`` on
    GL601/GL602/GL604. Under ``0`` the port still runs ``_ALWAYS_ON``
    (``cse``, ``mul_self_to_square``, ``dce``), and a failure there raises:
    those rules are what the port's kernels engage by (the transformer's
    ``norm_residual`` sites), so no fallback may drop them unseen."""
    mode = graphrewrite_mode()
    if mode is None:
        result = rewrite(symbol, shapes=shapes, types=types, passes=_ALWAYS_ON,
                         label=target)
    else:
        try:
            result = rewrite(symbol, shapes=shapes, types=types, label=target)
        except Exception as exc:
            if _tm.enabled():
                _tm.counter("rewrite.fallbacks").inc()
            _LOG.warning("graph rewrite failed at %s (%s: %s) — binding the "
                         "original graph", target, type(exc).__name__, exc)
            return symbol, None
    if not result.changed:
        return symbol, result
    if mode == "verify":
        report = verify_rewrite(result, grad_req=grad_req, target=target)
        for d in report:
            lvl = (logging.ERROR if d.severity == "error" else
                   logging.WARNING if d.severity == "warning" else
                   logging.DEBUG)
            _LOG.log(lvl, d.format())
        if report.errors:
            raise MXNetError(
                "graph rewrite verification failed at %s "
                "(MXNET_GRAPHREWRITE=verify):\n%s"
                % (target, report.format(min_severity="warning")))
    if (result.symbol.list_arguments() != symbol.list_arguments()
            or result.symbol.list_auxiliary_states()
            != symbol.list_auxiliary_states()):
        if _tm.enabled():
            _tm.counter("rewrite.fallbacks").inc()
        _LOG.warning("graph rewrite at %s changed the argument "
                     "interface — binding the original graph", target)
        return symbol, None
    return result.symbol, result
