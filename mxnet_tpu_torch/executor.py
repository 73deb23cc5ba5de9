"""Executor: a bound symbol graph, run eagerly, forward and backward.

Counterpart of ``mxnet_tpu/executor.py``: ``_GraphProgram`` (:36) holds the
topological order and the fusion plan, ``interpret`` (:158) walks the graph
over torch tensors, and ``Executor`` runs it with the reference's
``grad_req`` semantics (write|add|null per argument) and aux states (the
moving statistics of BatchNorm, :158-224): a training forward returns each
op's new aux values, threaded back by variable name, and the executor writes
them into its aux arrays in place. There is no jit:
PyTorch runs each op as it is reached, and the fused sites launch their CUDA
kernels. The JAX package takes gradients with ``jax.vjp`` over the traced
graph; here a training forward runs under torch autograd, which records the
same graph as it runs, and ``backward`` takes ``torch.autograd.grad`` of the
outputs. ``bind`` always runs the rewrite passes first
(``analysis/rewrite.py``), so the fusion matchers see the canonical graph,
and under ``MXNET_GRAPHLINT`` lints the graph it binds (``analysis/``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from .base import MXNetError, np_dtype
from .context import Context, current_context
from .ndarray import NDArray, _wrap, zeros
from .ops.registry import get_op
from . import fusion as _fusion
from . import random as _random

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
        self.pattern_sites, self.conv_bn_directives = _fusion.plan_sites(self.fusion_plan)
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self._arg_index = {n: i for i, n in enumerate(self.arg_names)}
        self._aux_index = {n: i for i, n in enumerate(self.aux_names)}
        self.outputs = list(symbol._outputs)
        self.output_names = symbol.list_outputs()

    def interpret(self, arg_vals, aux_vals, is_train, device=None):
        """Run the graph on torch tensors; returns ``(outputs, new_aux)``,
        each op's new aux values in the place of the aux variables it reads.

        ``device`` is the bind's: an op with no inputs (``_zeros``, a
        sampler) allocates there, and every rng-consuming node (``Dropout``,
        ``RNN``'s dropout, the samplers) draws from its generator,
        ``random.generator(device)``, in topological order (JAX :202-210
        folds one key a node out of the forward's key). A training forward
        draws each mask once; its backward reuses it through autograd."""
        vals = {}
        new_aux = list(aux_vals)
        rng = None
        for node in self.topo:
            if node.is_variable:
                if node.name in self._arg_index:
                    vals[(id(node), 0)] = arg_vals[self._arg_index[node.name]]
                else:
                    vals[(id(node), 0)] = aux_vals[self._aux_index[node.name]]
                continue
            opdef = get_op(node.op)
            n_aux = len(opdef.aux_names(node.parsed_attrs()))
            ins = [vals[(id(inp), oi)] for inp, oi in node.inputs]
            ins, aux = ins[:len(ins) - n_aux], ins[len(ins) - n_aux:]
            directive = self.fusion_plan.get(id(node))
            if directive is not None:
                outs, aux_out = _fusion.execute(directive, node, ins, aux, is_train)
            else:
                if opdef.needs_rng and device is not None and rng is None:
                    rng = _random.generator(device)
                with contextlib.nullcontext() if ins or device is None else torch.device(device):
                    outs, aux_out = opdef.apply(node.parsed_attrs(),
                                                [_fusion.resolve(x) for x in ins], aux=aux,
                                                is_train=is_train, rng=rng)
            for i, o in enumerate(outs):
                vals[(id(node), i)] = o
            for (inp, _), new in zip(node.inputs[len(node.inputs) - n_aux:], aux_out):
                if not inp.is_variable:
                    raise MXNetError("aux input of %s must be a variable" % node.name)
                new_aux[self._aux_index[inp.name]] = new
        outputs = tuple(_fusion.resolve(vals[(id(n), i)]) for n, i in self.outputs)
        return outputs, tuple(new_aux)


class Executor:
    """A bound computation (reference: python/mxnet/executor.py)."""

    def __init__(self, symbol, ctx: Context, arg_arrays, grad_arrays=None, grad_req=None,
                 aux_arrays=None, program=None):
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
        self.aux_arrays: List[NDArray] = list(aux_arrays or [])
        self.aux_dict: Dict[str, NDArray] = dict(zip(self._prog.aux_names, self.aux_arrays))
        self.outputs: List[NDArray] = []
        self.output_dict: Dict[str, NDArray] = {}
        # (leaf tensors, output tensors) of the last training forward: the
        # autograd graph a later backward() consumes (JAX: _cached_vjp)
        self._graph = None
        self._monitor_callback = None
        # the caller's symbol, before the bind-time rewrite: what reshape()
        # and bind(shared_exec=...) compare against
        self._orig_symbol = symbol

    # ----------------------------------------------------------------- running
    def _needs_grad(self):
        return any(r != "null" for r in self._grad_req)

    def _aux_tensors(self):
        return tuple(a._tensor() for a in self.aux_arrays)

    def _run_train(self):
        """Run the training forward under autograd from the bound arguments:
        every floating-point argument whose req is not null becomes a leaf
        that requires grad. Returns ((leaves, outputs), new_aux)."""
        leaves = []
        for arr, req in zip(self.arg_arrays, self._grad_req):
            t = arr._tensor()
            if req != "null" and t.is_floating_point():
                t = t.detach().requires_grad_(True)
            leaves.append(t)
        with torch.enable_grad():
            outs, new_aux = self._prog.interpret(tuple(leaves), self._aux_tensors(), True,
                                                 self._ctx.torch_device)
        return (leaves, outs), new_aux

    def _write_aux(self, new_aux):
        """The training forward's new aux values into the aux arrays, in
        place (the JAX package rebinds them, :309)."""
        with torch.no_grad():
            for arr, new in zip(self.aux_arrays, new_aux):
                t = arr._tensor()
                if new is not t:
                    t.copy_(new)

    def _set_outputs(self, outs):
        self.outputs = [_wrap(o.detach(), self._ctx) for o in outs]
        self.output_dict = dict(zip(self._prog.output_names, self.outputs))
        if self._monitor_callback is not None:
            for name, arr in self.output_dict.items():
                self._monitor_callback(name, arr)
        return self.outputs

    def forward(self, is_train=False, **kwargs):
        """Run the graph on the bound arguments; returns ``outputs``.
        Keyword arguments are copied into the bound arguments first
        (``exe.forward(data=x)``; an unknown name raises).

        With ``is_train=True`` and some grad_req not null the forward runs
        under autograd and keeps its graph for ``backward()``; otherwise it
        runs under ``torch.no_grad()`` and keeps nothing. A training forward
        (``is_train=True``, gradients or not) writes the new moving stats
        into the aux arrays."""
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown argument %r" % k)
            self.arg_dict[k][:] = v
        # release the previous step's graph before building the next one, or
        # two sets of saved activations coexist on the device (JAX :357)
        self._graph = None
        if is_train and self._needs_grad():
            self._graph, new_aux = self._run_train()
            outs = self._graph[1]
        else:
            with torch.no_grad():
                outs, new_aux = self._prog.interpret(
                    tuple(a._tensor() for a in self.arg_arrays), self._aux_tensors(),
                    bool(is_train), self._ctx.torch_device)
        if is_train:
            self._write_aux(new_aux)
        return self._set_outputs(outs)

    def backward(self, out_grads=None):
        """Gradients of the outputs into the grad arrays, per grad_req.

        After ``forward(is_train=True)`` this consumes that forward's graph;
        without one (a second ``backward``, or none before) it runs the
        training forward again from the bound arguments first, as the JAX
        package runs its fused forward+backward then, and discards that
        forward's aux values as JAX does (:431). ``out_grads`` are the
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
            graph, _ = self._run_train()
        self._apply_grads(self._grads(graph, out_grads))

    def forward_backward(self, out_grads=None, is_train=True):
        """One training step's forward and backward; returns ``outputs``.
        The aux arrays take the step's new values once (JAX :452)."""
        self.forward(is_train=is_train)
        self.backward(out_grads)
        return self.outputs

    def copy_params_from(self, arg_params, aux_params=None, allow_extra_params=False):
        """Copy {name: array} (NDArray, tensor or numpy) into the bound
        arguments and aux states (JAX :457); a name the executor does not
        have raises unless ``allow_extra_params``."""
        for params, table, what in ((arg_params, self.arg_dict, "arguments"),
                                    (aux_params, self.aux_dict, "aux states")):
            for name, arr in (params or {}).items():
                if name in table:
                    table[name][:] = arr
                elif not allow_extra_params:
                    raise MXNetError("Found name %r not in executor %s" % (name, what))

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """A new executor at new input shapes, sharing this one's program
        (JAX :469). An argument whose shape is unchanged keeps its array;
        ``partial_shaping`` keeps the old shape of whatever the new hints
        leave undetermined; without ``allow_up_sizing`` no argument may
        grow."""
        if partial_shaping:
            arg_shapes, _, aux_shapes = self._symbol.infer_shape_partial(**kwargs)
        else:
            arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
            if arg_shapes is None:
                raise MXNetError(
                    "reshape: insufficient shape info (pass partial_shaping=True to keep "
                    "old shapes for undetermined arguments)")

        def renew(arr, shape, name):
            if shape is None:
                if not partial_shaping:
                    raise MXNetError("reshape: shape of %r undetermined" % name)
                return arr, False
            if tuple(arr.shape) == tuple(shape):
                return arr, False
            if int(np.prod(shape)) > arr.size and not allow_up_sizing:
                raise MXNetError(
                    "reshape: new shape %s of %r is larger than original %s; pass "
                    "allow_up_sizing=True to permit reallocation" % (shape, name, arr.shape))
            return zeros(shape, ctx=self._ctx, dtype=arr.dtype), True

        new_args, new_grads = [], []
        for name, arr, garr, shape in zip(self._prog.arg_names, self.arg_arrays,
                                          self.grad_arrays, arg_shapes):
            na, changed = renew(arr, shape, name)
            new_args.append(na)
            new_grads.append(zeros(na.shape, ctx=self._ctx, dtype=garr.dtype)
                             if changed and garr is not None else garr)
        new_aux = [renew(arr, shape, name)[0]
                   for name, arr, shape in zip(self._prog.aux_names, self.aux_arrays, aux_shapes)]
        exe = Executor(self._symbol, self._ctx, new_args, new_grads, self._grad_req, new_aux,
                       program=self._prog)
        exe._orig_symbol = self._orig_symbol
        return exe

    def set_monitor_callback(self, callback):
        """``callback(name, NDArray)`` is called on every output after each
        forward."""
        self._monitor_callback = callback

    def debug_str(self):
        return self._symbol.debug_str()

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
def _lint_at_bind(symbol, arg_arrays, arg_names, aux_arrays, aux_names, train=True):
    """``MXNET_GRAPHLINT=warn|error`` (JAX :538-558): run the graph passes
    with the concrete bind shapes and dtypes; ``warn`` logs the findings,
    ``error`` raises ``MXNetError`` with the report. ``train`` steers the
    GL5xx memory plan: a bind without gradients plans forward-only
    liveness, a training bind adds gradients and optimizer state."""
    from .analysis import graphlint_mode, lint_bind

    mode = graphlint_mode()
    if mode is None:
        return
    shapes = {n: tuple(a.shape) for n, a in zip(arg_names, arg_arrays) if a is not None}
    types = {n: np.dtype(np_dtype(a.dtype)) for n, a in zip(arg_names, arg_arrays)
             if a is not None}
    shapes.update({n: tuple(a.shape) for n, a in zip(aux_names, aux_arrays)})
    types.update({n: np.dtype(np_dtype(a.dtype)) for n, a in zip(aux_names, aux_arrays)})
    lint_bind(symbol, shapes, types, mode, target="bind", train=train)


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


def _check_group2ctx(ctx, group2ctx):
    """The port places a graph on one device: every ``group2ctx`` entry
    must name the bind's own context."""
    others = sorted({str(c) for c in (group2ctx or {}).values() if Context(c) != ctx})
    if others:
        raise MXNetError("bind: group2ctx places groups on %s, but the port binds a graph on "
                         "one device (%s)" % (others, ctx))


def bind(symbol, ctx, args, args_grad=None, grad_req="write", aux_states=None, shared_exec=None,
         group2ctx=None):
    """Bind NDArrays to a symbol's arguments (reference: symbol.py bind).

    ``args`` and ``args_grad`` are dicts by name or lists in the order of
    ``symbol.list_arguments()``. Without ``args_grad`` nothing gets a
    gradient; an argument ``args_grad`` leaves out gets req null.
    ``aux_states`` is a dict by name or a list in the order of
    ``symbol.list_auxiliary_states()``, and must hold every aux state.
    ``shared_exec``, an executor of the same symbol, lends its rewritten
    graph and program (JAX :586). ``group2ctx`` may only name ``ctx``."""
    from .analysis.rewrite import rewrite_for_bind

    names = symbol.list_arguments()
    args = _by_name(args, names, "args")
    reqs = dict(zip(names, _normalize_grad_req(grad_req, names)))
    grads = {} if args_grad is None else _by_name(args_grad, names, "grad arrays")
    orig_symbol = symbol
    ctx = Context(ctx) if not isinstance(ctx, Context) else ctx
    _check_group2ctx(ctx, group2ctx)
    if shared_exec is not None and (shared_exec._orig_symbol is symbol
                                    or shared_exec._symbol is symbol):
        symbol, prog = shared_exec._symbol, shared_exec._prog
    else:
        symbol = rewrite_for_bind(symbol)
        prog = _GraphProgram(symbol)
    missing = [n for n in prog.arg_names if n not in args]
    if missing:
        raise MXNetError("bind: missing arguments %s" % missing)
    grad_arrays = [grads.get(n) for n in prog.arg_names]
    req_list = [reqs.get(n, "null") if g is not None else "null"
                for n, g in zip(prog.arg_names, grad_arrays)]
    # as mxnet_tpu/executor.py:631-643
    if aux_states is None:
        if prog.aux_names:
            raise MXNetError("bind: missing aux states %s" % prog.aux_names)
        aux_arrays = []
    elif isinstance(aux_states, dict):
        missing = [n for n in prog.aux_names if n not in aux_states]
        if missing:
            raise MXNetError("bind: missing aux states %s" % missing)
        aux_arrays = [aux_states[n] for n in prog.aux_names]
    else:
        aux_arrays = list(aux_states)
        if len(aux_arrays) != len(prog.aux_names):
            raise MXNetError("bind: expected %d aux states, got %d"
                             % (len(prog.aux_names), len(aux_arrays)))
    arg_arrays = [args[n] for n in prog.arg_names]
    # the graph that is bound (the rewritten one), as the JAX package lints
    # what it binds (:645)
    _lint_at_bind(symbol, arg_arrays, prog.arg_names, aux_arrays, prog.aux_names,
                  train=any(r != "null" for r in req_list))
    exe = Executor(symbol, ctx, arg_arrays, grad_arrays, req_list, aux_arrays, program=prog)
    exe._orig_symbol = orig_symbol
    return exe


def simple_bind(symbol, ctx, grad_req="write", type_dict=None, group2ctx=None,
                shared_exec=None, **kwargs):
    """Infer shapes and dtypes from the given input shapes, allocate every
    argument, a gradient array for each whose req is not null, and every
    aux state, as zeros on ``ctx`` (JAX :689), and bind. With
    ``shared_exec`` a parameter (an argument whose shape is not given here)
    of the same name, shape and dtype is taken from that executor instead of
    allocated: the two share the parameter tensors (and its program, as
    ``bind`` does). Inputs, gradient arrays and aux states stay their own."""
    shape_hints = {k: tuple(v) for k, v in kwargs.items() if v is not None}
    type_hints = {k: np_dtype(v) for k, v in (type_dict or {}).items()}
    try:
        res = symbol._infer_impl(shape_hints, type_hints)
    except Exception as e:
        from .analysis import graphlint_mode

        if graphlint_mode() is not None:
            # diagnose the failure with the graph passes (JAX :660-678):
            # per-node findings with provenance instead of a traceback
            from .analysis import lint

            report = lint(symbol, shapes=shape_hints, types=type_hints,
                          strict_shapes=True, target="simple_bind")
            if report.errors:
                raise MXNetError("simple_bind failed: %s\ngraphlint diagnosis:\n%s"
                                 % (e, report.format(min_severity="warning")))
        raise
    arg_shapes, _, aux_shapes, arg_types, _, aux_types = res
    ctx = current_context() if ctx is None else ctx
    ctx = Context(ctx) if not isinstance(ctx, Context) else ctx
    names = symbol.list_arguments()
    reqs = _normalize_grad_req(grad_req, names)

    def param(n, s, t):
        old = None
        if shared_exec is not None and n not in shape_hints:
            old = shared_exec.arg_dict.get(n)
        if old is not None and tuple(old.shape) == tuple(s) and np_dtype(old.dtype) == t:
            return old
        return zeros(s, ctx=ctx, dtype=t)

    arrays = {n: param(n, s, t) for n, s, t in zip(names, arg_shapes, arg_types)}
    grads = {n: zeros(s, ctx=ctx, dtype=t)
             for n, s, t, r in zip(names, arg_shapes, arg_types, reqs) if r != "null"}
    aux = {n: zeros(s, ctx=ctx, dtype=t)
           for n, s, t in zip(symbol.list_auxiliary_states(), aux_shapes, aux_types)}
    return bind(symbol, ctx, arrays, args_grad=grads, grad_req=reqs, aux_states=aux,
                shared_exec=shared_exec, group2ctx=group2ctx)
