"""Executor: a bound symbol graph, run eagerly, forward and backward.

Counterpart of ``mxnet_tpu/executor.py``: ``_GraphProgram`` (:36) holds the
topological order and the fusion plan, ``interpret`` (:158) walks the graph
over torch tensors, and ``Executor`` runs it with the reference's
``grad_req`` semantics (write|add|null per argument). There is no jit:
PyTorch runs each op as it is reached, and the fused sites launch their CUDA
kernels. The JAX package takes gradients with ``jax.vjp`` over the traced
graph; here a training forward runs under torch autograd, which records the
same graph as it runs, and ``backward`` takes ``torch.autograd.grad`` of the
outputs. ``bind`` always runs the rewrite passes first
(``analysis/rewrite.py``), so the fusion matchers see the canonical graph.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .base import MXNetError, np_dtype
from .context import Context, current_context
from .ndarray import NDArray, zeros
from .ops.registry import get_op
from . import fusion as _fusion

__all__ = ["Executor", "bind", "simple_bind"]

GRAD_REQS = ("write", "add", "null")


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

    def __init__(self, symbol, ctx: Context, arg_arrays, grad_arrays=None, grad_req=None,
                 program=None):
        self._symbol = symbol
        self._ctx = ctx
        self._prog = program or _GraphProgram(symbol)
        n = len(self._prog.arg_names)
        self.arg_arrays: List[NDArray] = list(arg_arrays)
        self.grad_arrays: List[Optional[NDArray]] = list(grad_arrays or [None] * n)
        self._grad_req: List[str] = list(grad_req or ["null"] * n)
        self.arg_dict: Dict[str, NDArray] = dict(zip(self._prog.arg_names, self.arg_arrays))
        self.grad_dict: Dict[str, Optional[NDArray]] = dict(zip(self._prog.arg_names,
                                                                self.grad_arrays))
        self.outputs: List[NDArray] = []
        self.output_dict: Dict[str, NDArray] = {}
        # (leaf tensors, output tensors) of the last training forward: the
        # autograd graph a later backward() consumes (JAX: _cached_vjp)
        self._graph = None

    # ----------------------------------------------------------------- running
    def _needs_grad(self):
        return any(r != "null" for r in self._grad_req)

    def _run_train(self):
        """Run the graph under autograd from the bound arguments: every
        floating-point argument whose req is not null becomes a leaf that
        requires grad. Returns (leaves, outputs)."""
        leaves = []
        for arr, req in zip(self.arg_arrays, self._grad_req):
            t = arr._tensor()
            if req != "null" and t.is_floating_point():
                t = t.detach().requires_grad_(True)
            leaves.append(t)
        with torch.enable_grad():
            outs = self._prog.interpret(tuple(leaves))
        return leaves, outs

    def _set_outputs(self, outs):
        self.outputs = [NDArray(o.detach(), self._ctx) for o in outs]
        self.output_dict = dict(zip(self._prog.output_names, self.outputs))
        return self.outputs

    def forward(self, is_train=False):
        """Run the graph on the bound arguments; returns ``outputs``.

        With ``is_train=True`` and some grad_req not null the forward runs
        under autograd and keeps its graph for ``backward()``; otherwise it
        runs under ``torch.no_grad()`` and keeps nothing."""
        # release the previous step's graph before building the next one, or
        # two sets of saved activations coexist on the device (JAX :357)
        self._graph = None
        if is_train and self._needs_grad():
            self._graph = self._run_train()
            return self._set_outputs(self._graph[1])
        with torch.no_grad():
            outs = self._prog.interpret(tuple(a._tensor() for a in self.arg_arrays))
        return self._set_outputs(outs)

    def backward(self, out_grads=None):
        """Gradients of the outputs into the grad arrays, per grad_req.

        After ``forward(is_train=True)`` this consumes that forward's graph;
        without one (a second ``backward``, or none before) it runs the
        training forward again from the bound arguments first, as the JAX
        package runs its fused forward+backward then. ``out_grads`` are the
        head gradients, one per output; without them each output's is ones
        (a loss head such as SoftmaxOutput ignores it)."""
        if out_grads is not None:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            if len(out_grads) != len(self._prog.outputs):
                raise MXNetError("backward: expected %d head gradients, got %d"
                                 % (len(self._prog.outputs), len(out_grads)))
        graph, self._graph = self._graph, None  # the graph is consumed here
        if graph is None:
            graph = self._run_train()
        self._apply_grads(self._grads(graph, out_grads))

    def forward_backward(self, out_grads=None, is_train=True):
        """One training step's forward and backward; returns ``outputs``."""
        self.forward(is_train=is_train)
        self.backward(out_grads)
        return self.outputs

    def _grads(self, graph, out_grads):
        """One gradient (or None) per argument."""
        leaves, outs = graph
        heads = []
        for i, o in enumerate(outs):
            if not o.requires_grad:
                continue  # an output no argument's gradient flows through
            g = torch.ones_like(o) if out_grads is None else \
                out_grads[i]._tensor().to(device=o.device, dtype=o.dtype)
            heads.append((o, g))
        wrt = [i for i, t in enumerate(leaves) if t.requires_grad]
        grads = [None] * len(leaves)
        if heads and wrt:
            got = torch.autograd.grad([o for o, _ in heads], [leaves[i] for i in wrt],
                                      grad_outputs=[g for _, g in heads], allow_unused=True)
            for i, g in zip(wrt, got):
                grads[i] = g
        return grads

    def _apply_grads(self, grads):
        """write copies, add accumulates, null leaves the array alone; an
        argument no gradient reaches (float token ids) gets zeros under write,
        as the JAX package writes them. The port writes into the grad arrays
        in place, so a held ``grad_dict`` entry sees the new values (the JAX
        package rebinds the array's buffer)."""
        with torch.no_grad():
            for garr, g, req in zip(self.grad_arrays, grads, self._grad_req):
                if req == "null" or garr is None:
                    continue
                t = garr._tensor()
                if g is None:
                    if req == "write":
                        t.zero_()
                elif req == "add":
                    t.add_(g.to(t.dtype))
                else:
                    t.copy_(g)


# -------------------------------------------------------------------- binding
def _normalize_grad_req(grad_req, arg_names):
    """One req per argument from a str, a list or a {name: req} dict (names
    a dict leaves out get null), as ``mxnet_tpu/executor.py:526``."""
    if isinstance(grad_req, str):
        reqs = [grad_req] * len(arg_names)
    elif isinstance(grad_req, (list, tuple)):
        if len(grad_req) != len(arg_names):
            raise MXNetError("grad_req list length mismatch")
        reqs = list(grad_req)
    elif isinstance(grad_req, dict):
        reqs = [grad_req.get(n, "null") for n in arg_names]
    else:
        raise TypeError("grad_req must be str/list/dict")
    bad = sorted(set(reqs) - set(GRAD_REQS))
    if bad:
        raise MXNetError("grad_req must be one of %s, got %s" % (GRAD_REQS, bad))
    return reqs


def _by_name(values, names, what):
    """A {name: value} dict from a dict or a list in argument order."""
    if isinstance(values, dict):
        return dict(values)
    if len(values) != len(names):
        raise MXNetError("bind: expected %d %s, got %d" % (len(names), what, len(values)))
    return dict(zip(names, values))


def bind(symbol, ctx, args, args_grad=None, grad_req="write", aux_states=None):
    """Bind NDArrays to a symbol's arguments (reference: symbol.py bind).

    ``args`` and ``args_grad`` are dicts by name or lists in the order of
    ``symbol.list_arguments()``. Without ``args_grad`` nothing gets a
    gradient; an argument ``args_grad`` leaves out gets req null. No op of
    the port has aux state, so ``aux_states`` must be empty."""
    from .analysis.rewrite import rewrite_for_bind

    if aux_states:
        raise MXNetError("bind: no op of this port has aux states, got %d" % len(aux_states))
    names = symbol.list_arguments()
    args = _by_name(args, names, "args")
    reqs = dict(zip(names, _normalize_grad_req(grad_req, names)))
    grads = {} if args_grad is None else _by_name(args_grad, names, "grad arrays")
    symbol = rewrite_for_bind(symbol)
    prog = _GraphProgram(symbol)
    ctx = Context(ctx) if not isinstance(ctx, Context) else ctx
    missing = [n for n in prog.arg_names if n not in args]
    if missing:
        raise MXNetError("bind: missing arguments %s" % missing)
    grad_arrays = [grads.get(n) for n in prog.arg_names]
    req_list = [reqs.get(n, "null") if g is not None else "null"
                for n, g in zip(prog.arg_names, grad_arrays)]
    return Executor(symbol, ctx, [args[n] for n in prog.arg_names], grad_arrays, req_list,
                    program=prog)


def simple_bind(symbol, ctx, grad_req="write", type_dict=None, **kwargs):
    """Infer shapes and dtypes from the given input shapes, allocate every
    argument, and a gradient array for each whose req is not null, as zeros
    on ``ctx``, and bind."""
    shape_hints = {k: tuple(v) for k, v in kwargs.items() if v is not None}
    type_hints = {k: np_dtype(v) for k, v in (type_dict or {}).items()}
    arg_shapes, _, arg_types, _ = symbol._infer_impl(shape_hints, type_hints)
    ctx = current_context() if ctx is None else ctx
    ctx = Context(ctx) if not isinstance(ctx, Context) else ctx
    names = symbol.list_arguments()
    reqs = _normalize_grad_req(grad_req, names)
    arrays = {n: zeros(s, ctx=ctx, dtype=t) for n, s, t in zip(names, arg_shapes, arg_types)}
    grads = {n: zeros(s, ctx=ctx, dtype=t)
             for n, s, t, r in zip(names, arg_shapes, arg_types, reqs) if r != "null"}
    return bind(symbol, ctx, arrays, args_grad=grads, grad_req=reqs)
