"""The ``Custom`` op: user Python code inside the graph.

Counterpart of ``mxnet_tpu/ops/custom.py`` (the reference's
src/operator/custom/custom.cc and python/mxnet/operator.py). The JAX
package calls the user's ``forward``/``backward`` on host NDArrays through
``jax.pure_callback``; here they run on the port's NDArrays directly, on the
device the op's inputs lie on, and an autograd Function wires the user's
``backward`` into the graph's. Aux states pass through unchanged, as in the
JAX op (:131-133). A Custom node cannot be captured into a CUDA graph (the
decoders' megasteps, the serving cache's captured programs): the user's
code runs on the host at every call, so under capture the op raises,
naming its ``op_type``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, numpy_dtype, torch_dtype
from .registry import AttrSpec, register

_CUSTOM_PROPS = {}


def register_custom(op_type):
    """Decorator registering a CustomOpProp subclass under ``op_type``
    (reference: operator.py register)."""

    def wrap(klass):
        if op_type in _CUSTOM_PROPS:
            raise MXNetError("custom op %r already registered" % op_type)
        _CUSTOM_PROPS[op_type] = klass
        return klass

    return wrap


# copied from mxnet_tpu/ops/custom.py (_instantiate, backend-free)
def _instantiate(attrs):
    op_type = attrs.get("op_type")
    if op_type not in _CUSTOM_PROPS:
        raise MXNetError("unknown custom op_type %r" % op_type)
    kwargs = {k: v for k, v in attrs.items()
              if k != "op_type" and not (k.startswith("__") and k.endswith("__"))
              and v is not None}
    return _CUSTOM_PROPS[op_type](**kwargs)


def _custom_input_names(attrs):
    return list(_instantiate(attrs).list_arguments())


def _custom_aux_names(attrs):
    return list(_instantiate(attrs).list_auxiliary_states())


def _custom_num_outputs(attrs):
    return len(_instantiate(attrs).list_outputs())


def _capturing():
    """Whether this thread's current CUDA stream is capturing a graph."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _context_of(t):
    from ..context import cpu, gpu

    return cpu() if t.device.type == "cpu" else gpu(t.device.index or 0)


def _nds(tensors, ctx):
    """Fresh NDArrays holding copies of ``tensors``: the user's code may
    write into what it is handed."""
    from ..ndarray import _wrap

    return [_wrap(t.detach().clone(), ctx) for t in tensors]


class _CustomRun(torch.autograd.Function):
    """The user's forward on the inputs; its backward on the head
    gradients, the inputs and the outputs."""

    @staticmethod
    def forward(ctx, run, n_data, *tensors):
        data, aux = tensors[:n_data], tensors[n_data:]
        outs = run.forward(data, aux)
        ctx.run, ctx.n_data = run, n_data
        ctx.save_for_backward(*data, *aux, *outs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *cot):
        saved = ctx.saved_tensors
        n, k = ctx.n_data, len(cot)
        data, aux, outs = saved[:n], saved[n:len(saved) - k], saved[len(saved) - k:]
        grads = ctx.run.backward(cot, data, outs, aux)
        return (None, None) + tuple(grads) + (None,) * len(aux)


class _Run:
    """One Custom node's user operator and its shapes and types."""

    def __init__(self, prop, op, out_shapes, out_types, is_train):
        self.prop, self.op = prop, op
        self.out_shapes, self.out_types, self.is_train = out_shapes, out_types, is_train

    def forward(self, data, aux):
        from ..ndarray import zeros

        ctx = _context_of(data[0])
        out_nd = [zeros(tuple(s), ctx=ctx, dtype=t) for s, t in zip(self.out_shapes,
                                                                     self.out_types)]
        self.op.forward(is_train=self.is_train, req=["write"] * len(out_nd),
                        in_data=_nds(data, ctx), out_data=out_nd, aux=_nds(aux, ctx))
        return [o._tensor() for o in out_nd]

    def backward(self, cot, data, outs, aux):
        from ..ndarray import zeros

        ctx = _context_of(data[0])
        cot = [torch.zeros_like(o) if g is None else g for g, o in zip(cot, outs)]
        in_grad = [zeros(tuple(x.shape), ctx=ctx, dtype=numpy_dtype(x.dtype)) for x in data]
        self.op.backward(req=["write"] * len(in_grad), out_grad=_nds(cot, ctx),
                         in_data=_nds(data, ctx), out_data=_nds(outs, ctx), in_grad=in_grad,
                         aux=_nds(aux, ctx))
        return [g._tensor() for g in in_grad]


@register("Custom", attrs={"op_type": AttrSpec("str", required=True)},
          input_names=_custom_input_names, aux_names=_custom_aux_names,
          num_outputs=_custom_num_outputs, needs_train_flag=True)
def _custom(attrs, inputs, aux, is_train=False):
    prop = _instantiate(attrs)
    data, aux = list(inputs), list(aux or [])
    in_shapes = [list(x.shape) for x in data]
    _, out_shapes, _ = prop.infer_shape(in_shapes)
    in_types = [numpy_dtype(x.dtype) for x in data]
    try:
        _, out_types, _ = prop.infer_type(in_types)
    except Exception:
        out_types = [in_types[0] if in_types else np.float32] * len(out_shapes)
    out_types = [np.dtype(t) for t in out_types]
    dev = data[0].device if data else torch.device("cpu")
    if dev.type == "meta":  # shape inference: the prop's shapes, no call
        outs = [torch.empty(tuple(s), dtype=torch_dtype(t), device="meta")
                for s, t in zip(out_shapes, out_types)]
        return tuple(outs), aux
    if _capturing():
        raise MXNetError("Custom op %r cannot run under CUDA-graph capture: its forward "
                         "is the user's Python code, called at every run" % attrs["op_type"])
    run = _Run(prop, prop.create_operator(None, in_shapes, in_types), out_shapes, out_types,
               bool(is_train))
    outs = _CustomRun.apply(run, len(data), *data, *aux)
    # aux states pass through unchanged, as in the JAX op
    return tuple(outs), aux
