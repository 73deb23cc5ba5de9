"""Pattern-based subgraph fusion over the Symbol DAG.

Counterpart of the generic pattern engine of ``mxnet_tpu/fusion.py``
(``Lazy``/``resolve`` :131-168, ``plan`` :385, ``_exec_pattern``/``execute``
:997-1048) over the three patterns of ``ops/fusion_patterns.py``. ``plan``
roots each match in a directive map and marks its interior nodes ``lazy``;
at run time a rooted site runs its pattern's lowering, which is a kernel
on CUDA tensors and the kernel's plain version on CPU tensors. There is no
conv+BN side, no autotuner and no environment switch: every matched site
takes its lowering. Where the kernel does not take a site's shapes, a CPU
site runs the ordinary unfused ops and a CUDA site raises.

Training needs no switch here (the JAX ``_exec_pattern`` takes ``is_train``
for its gate): the executor runs a training forward under autograd, a
pattern's lowering records its kernel's autograd Function, and a ``Lazy``
interior node that a consumer outside the pattern materialises runs ordinary
torch ops, which carry their gradients like any other node.
"""
from __future__ import annotations

from .ops.fusion_patterns import get_patterns
from .ops.registry import get_op

__all__ = ["Lazy", "resolve", "plan", "plan_sites", "execute"]


class Lazy:
    """A pattern-interior node's not-yet-computed output. ``materialize()``
    runs the ordinary op (the unfused semantics) and caches the value."""

    __slots__ = ("node", "ins", "_mat")

    def __init__(self, node, ins):
        self.node, self.ins = node, list(ins)
        self._mat = None

    def materialize(self):
        if self._mat is None:
            outs, _ = get_op(self.node.op).apply(self.node.parsed_attrs(),
                                                 [resolve(v) for v in self.ins])
            self._mat = outs[0]
        return self._mat


def resolve(v):
    """Any op that is not fusion-aware sees a plain tensor."""
    return v.materialize() if isinstance(v, Lazy) else v


class _PlanCtx:
    """What pattern matchers may see of the graph: the consumer map, the
    program-output ids, and the directives built so far (``claimed``)."""

    __slots__ = ("consumers", "output_ids", "claimed")

    def __init__(self, consumers, output_ids, claimed):
        self.consumers, self.output_ids = consumers, output_ids
        self.claimed = claimed


def plan(topo, output_ids=()):
    """Build the fusion plan: id(node) -> directive dict. Structural only.

    Each pattern, in priority order, over the still-unclaimed nodes: a
    matched root gets a ``pattern`` directive, its interior nodes ``lazy``
    markers. ``output_ids`` are the nodes whose values are program outputs;
    none of them may be a pattern interior."""
    output_ids = frozenset(output_ids)
    consumers = {}
    for node in topo:
        for inp, oi in node.inputs:
            consumers.setdefault(id(inp), []).append((node, oi))
    directives = {}
    ctx = _PlanCtx(consumers, output_ids, directives)
    for pat in get_patterns():
        for node in topo:
            if node.is_variable or id(node) in directives:
                continue
            m = pat.match(node, ctx)
            if m is None:
                continue
            directives[id(node)] = {"kind": "pattern", "pat": pat, "meta": m.meta}
            for n in m.interior:
                directives[id(n)] = {"kind": "lazy"}
    return directives


def plan_sites(directives):
    """Per-pattern site counts of one plan."""
    sites = {}
    for d in directives.values():
        if d["kind"] == "pattern":
            sites[d["pat"].name] = sites.get(d["pat"].name, 0) + 1
    return sites


def _exec_pattern(directive, node, ins):
    """Run one pattern-rooted node through its lowering, or, on the CPU only,
    the unfused root op where the kernel does not take the site's shapes."""
    pat, meta = directive["pat"], directive["meta"]
    args = pat.externals(meta, ins, resolve)
    fn = pat.build(meta, args)
    if fn is not None:
        return (fn(*args),)
    outs, _ = get_op(node.op).apply(node.parsed_attrs(), [resolve(v) for v in ins])
    return tuple(outs)


def execute(directive, node, ins):
    """Run one planned node during interpret(); ``ins`` may hold markers."""
    kind = directive["kind"]
    if kind == "lazy":
        return (Lazy(node, ins),)
    if kind == "pattern":
        return _exec_pattern(directive, node, ins)
    raise AssertionError(kind)
