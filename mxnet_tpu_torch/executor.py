"""Executor: a bound symbol graph, run eagerly.

Counterpart of ``mxnet_tpu/executor.py`` for inference: ``_GraphProgram``
(:36) holds the topological order and the fusion plan, ``interpret``
(:158) walks the graph over torch tensors, and ``Executor.forward
(is_train=False)`` runs it and exposes ``outputs``/``output_dict``. There is
no jit: PyTorch runs each op as it is reached, and the fused sites launch
their CUDA kernels. ``bind`` always runs the rewrite passes first
(``analysis/rewrite.py``), so the fusion matchers see the canonical graph.
Training (``is_train=True``, ``backward``) comes with the training slice.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from .base import MXNetError, np_dtype
from .context import Context
from .ndarray import NDArray, zeros
from .ops.registry import get_op
from . import fusion as _fusion

__all__ = ["Executor", "bind", "simple_bind"]


class _GraphProgram:
    """The interpretation of a Symbol: its topo order and fusion plan."""

    def __init__(self, symbol):
        self.symbol = symbol
        self.topo = symbol._topo()
        # graph-output node ids keep the planner from eliding a node whose
        # value must materialize as a program output
        self.fusion_plan = _fusion.plan(self.topo,
                                        output_ids={id(n) for n, _ in symbol._outputs})
        self.pattern_sites = _fusion.plan_sites(self.fusion_plan)
        self.arg_names = symbol.list_arguments()
        self._arg_index = {n: i for i, n in enumerate(self.arg_names)}
        self.outputs = list(symbol._outputs)
        self.output_names = symbol.list_outputs()

    def interpret(self, arg_vals):
        """Run the graph on torch tensors; returns the output tuple."""
        vals = {}
        for node in self.topo:
            if node.is_variable:
                vals[(id(node), 0)] = arg_vals[self._arg_index[node.name]]
                continue
            ins = [vals[(id(inp), oi)] for inp, oi in node.inputs]
            directive = self.fusion_plan.get(id(node))
            if directive is not None:
                outs = _fusion.execute(directive, node, ins)
            else:
                outs, _ = get_op(node.op).apply(node.parsed_attrs(),
                                                [_fusion.resolve(x) for x in ins])
            for i, o in enumerate(outs):
                vals[(id(node), i)] = o
        return tuple(_fusion.resolve(vals[(id(n), i)]) for n, i in self.outputs)


class Executor:
    """A bound computation (reference: python/mxnet/executor.py)."""

    def __init__(self, symbol, ctx: Context, arg_arrays, program=None):
        self._symbol = symbol
        self._ctx = ctx
        self._prog = program or _GraphProgram(symbol)
        self.arg_arrays: List[NDArray] = list(arg_arrays)
        self.arg_dict: Dict[str, NDArray] = dict(zip(self._prog.arg_names, self.arg_arrays))
        self.outputs: List[NDArray] = []
        self.output_dict: Dict[str, NDArray] = {}

    def forward(self, is_train=False):
        """Run the graph on the bound arguments; returns ``outputs``."""
        if is_train:
            raise MXNetError("forward(is_train=True): the port runs inference only; "
                             "training comes with the training slice")
        with torch.no_grad():
            outs = self._prog.interpret(tuple(a._tensor() for a in self.arg_arrays))
        self.outputs = [NDArray(o, self._ctx) for o in outs]
        self.output_dict = dict(zip(self._prog.output_names, self.outputs))
        return self.outputs


def bind(symbol, ctx, args):
    """Bind a {name: NDArray} dict to the rewritten symbol's arguments."""
    from .analysis.rewrite import rewrite_for_bind

    symbol = rewrite_for_bind(symbol)
    prog = _GraphProgram(symbol)
    ctx = Context(ctx) if not isinstance(ctx, Context) else ctx
    missing = [n for n in prog.arg_names if n not in args]
    if missing:
        raise MXNetError("bind: missing arguments %s" % missing)
    return Executor(symbol, ctx, [args[n] for n in prog.arg_names], program=prog)


def simple_bind(symbol, ctx, type_dict=None, **kwargs):
    """Infer shapes and dtypes from the given input shapes, allocate every
    argument as zeros on ``ctx``, and bind."""
    shape_hints = {k: tuple(v) for k, v in kwargs.items() if v is not None}
    type_hints = {k: np_dtype(v) for k, v in (type_dict or {}).items()}
    arg_shapes, _, arg_types, _ = symbol._infer_impl(shape_hints, type_hints)
    ctx = Context(ctx) if not isinstance(ctx, Context) else ctx
    arrays = {n: zeros(s, ctx=ctx, dtype=t)
              for n, s, t in zip(symbol.list_arguments(), arg_shapes, arg_types)}
    return bind(symbol, ctx, arrays)
