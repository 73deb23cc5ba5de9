"""Custom operator user API (reference: python/mxnet/operator.py).

Copied from mxnet_tpu/operator.py (backend-free).

Define a ``CustomOp`` + ``CustomOpProp`` pair, register it, then use it as
``mx.nd.Custom(..., op_type=name)`` or ``mx.sym.Custom(..., op_type=name)``.
The execution mechanism lives in ops/custom.py (the user's code called on the
port's NDArrays, an autograd Function around it).
"""
from __future__ import annotations

from .ops.custom import register_custom as register  # noqa: F401

__all__ = ["CustomOp", "CustomOpProp", "register"]


class CustomOp:
    """Base class for user operators (reference: operator.py:396 CustomOp)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """(reference: operator.py CustomOp.assign)"""
        if req in ("null",):
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src


class CustomOpProp:
    """Base class describing a custom op (reference: operator.py:472
    CustomOpProp)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()
