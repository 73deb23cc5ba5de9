"""Symbol→Symbol rewrites run at bind.

Counterpart of ``mxnet_tpu/analysis/rewrite.py`` for what the serving
slice needs, and always on (the JAX package gates it with
``MXNET_GRAPHREWRITE``): the transformer zoo's LayerNorm is written naively
on purpose (a duplicate mean and centre, and ``x*x`` for the square), and
only after these passes does it match the ``norm_residual`` pattern.

* ``cse``          — merge op nodes with identical ``(op, attrs, inputs)``;
  stateful ops and program-output nodes never merge.
* ``canonicalize`` — the one rule ``mul_self_to_square``:
  ``elemwise_mul(x, x)`` / ``broadcast_mul(x, x)`` → ``square(x)``.
* ``dce``          — sweep what the other passes orphaned.

The pipeline runs to a fixpoint within a round budget, never mutates the
caller's Symbol, and keeps the argument interface: a rewrite that would
change it is dropped and the original graph is bound.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from ..base import MXNetError
from ..symbol import Symbol, _Node, _freeze, _topo_order

__all__ = ["rewrite", "rewrite_for_bind", "CSEPass", "CanonicalizePass", "DCEPass"]

_MAX_ROUNDS = 4


class _RGraph:
    """The mutable working copy one rewrite pipeline operates on."""

    def __init__(self, symbol: Symbol):
        mapping = {}
        for node in symbol._topo():
            mapping[id(node)] = _Node(node.op, node.name, dict(node.attrs),
                                      [(mapping[id(i)], oi) for i, oi in node.inputs])
        self.outputs: List[Tuple[_Node, int]] = [(mapping[id(n)], oi)
                                                 for n, oi in symbol._outputs]
        self.created: Dict[int, _Node] = {}
        self.live: List[_Node] = self.topo()

    def topo(self) -> List[_Node]:
        seen, heads = set(), []
        for node, _ in self.outputs:
            if id(node) not in seen:
                seen.add(id(node))
                heads.append(node)
        return _topo_order(heads)

    def output_ids(self):
        return {id(n) for n, _ in self.outputs}

    def symbol(self) -> Symbol:
        return Symbol(list(self.outputs))

    def new_node(self, op, name, attrs, inputs) -> _Node:
        node = _Node(op, name, dict(attrs or {}), list(inputs))
        self.created[id(node)] = node
        return node

    def apply_entry_map(self, entry_map):
        """Rewire every input edge and output head through ``entry_map``
        ({(id(old), oi): (new_node, new_oi)}), following chains."""
        if not entry_map:
            return

        def resolve(entry):
            while (id(entry[0]), entry[1]) in entry_map:
                entry = entry_map[(id(entry[0]), entry[1])]
            return entry

        # pass-created nodes copied their inputs before the map existed and
        # may not yet be reachable from the outputs: rewire them too
        nodes = {id(n): n for n in self.topo()}
        for n in self.created.values():
            nodes.setdefault(id(n), n)
        for node in nodes.values():
            node.inputs = [resolve(e) for e in node.inputs]
        self.outputs = [resolve(e) for e in self.outputs]


class CSEPass:
    """Merge op nodes with identical canonical signatures in one topo walk
    with incremental rewiring, so chains of duplicates (dup mean → dup
    centre) collapse in a single pass."""

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
            opdef = node.opdef()
            if opdef.needs_rng or opdef.has_aux:
                continue
            key = (node.op, _freeze(node.parsed_attrs()),
                   tuple((id(i), oi) for i, oi in node.inputs))
            prev = canon.get(key)
            if prev is None:
                canon[key] = node
            elif id(node) not in out_ids:
                for i in range(node.num_outputs()):
                    entry_map[(id(node), i)] = (prev, i)
                fired += 1
        g.apply_entry_map(entry_map)
        return fired


class CanonicalizePass:
    """``mul_self_to_square``: a self-multiply becomes ``square`` (the
    spelling the ``norm_residual`` matcher keys on), keeping the node name."""

    name = "canonicalize"

    def run(self, g: _RGraph) -> int:
        entry_map, fired = {}, 0
        for node in g.topo():
            if (node.op in ("elemwise_mul", "broadcast_mul") and len(node.inputs) == 2
                    and node.inputs[0][0] is node.inputs[1][0]
                    and node.inputs[0][1] == node.inputs[1][1]):
                sq = g.new_node("square", node.name, {}, [node.inputs[0]])
                entry_map[(id(node), 0)] = (sq, 0)
                fired += 1
        g.apply_entry_map(entry_map)
        return fired


class DCEPass:
    """Count (and forget) the nodes no longer reachable from the outputs."""

    name = "dce"

    def run(self, g: _RGraph) -> int:
        reach = {id(n) for n in g.topo()}
        removed = [n for n in g.live if id(n) not in reach]
        g.live = g.topo()
        return len(removed)


_PIPELINE = (CSEPass(), CanonicalizePass(), DCEPass())


def rewrite(symbol: Symbol, max_rounds=_MAX_ROUNDS) -> Symbol:
    """cse → canonicalize → dce to a fixpoint; returns the rewritten Symbol."""
    g = _RGraph(symbol)
    for _ in range(max_rounds):
        if sum(p.run(g) for p in _PIPELINE) == 0:
            break
    return g.symbol()


def rewrite_for_bind(symbol: Symbol) -> Symbol:
    """The symbol a bind should use: the rewritten one, unless the rewrite
    changed the argument interface (bound positionally), then the original."""
    new = rewrite(symbol)
    if new.list_arguments() != symbol.list_arguments():
        return symbol
    if new.list_outputs() != symbol.list_outputs():
        raise MXNetError("graph rewrite renamed the outputs %s -> %s"
                         % (symbol.list_outputs(), new.list_outputs()))
    return new
