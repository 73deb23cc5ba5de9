"""Shape manipulation and indexing ops.

Counterpart of ``mxnet_tpu/ops/matrix.py``: ``Reshape`` with MXNet's shape
codes, ``Flatten``, ``slice_axis``, ``SwapAxis``, ``expand_dims`` and
``Embedding``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .registry import AttrSpec, register


# copied from mxnet_tpu/ops/matrix.py (_reshape_target, backend-free)
def _reshape_target(shape_spec, in_shape):
    """MXNet Reshape shape-code semantics: 0 copy, -1 infer, -2 copy rest,
    -3 merge two, -4 split (reference: matrix_op-inl.h ReshapeParam)."""
    out = []
    i = 0  # index into in_shape
    j = 0
    spec = list(shape_spec)
    while j < len(spec):
        s = spec[j]
        if s == 0:
            out.append(in_shape[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(in_shape[i:])
            i = len(in_shape)
        elif s == -3:
            out.append(in_shape[i] * in_shape[i + 1])
            i += 2
        elif s == -4:
            a, b = spec[j + 1], spec[j + 2]
            if a == -1:
                a = in_shape[i] // b
            if b == -1:
                b = in_shape[i] // a
            out.extend([a, b])
            i += 1
            j += 2
        else:
            out.append(s)
            i += 1
        j += 1
    if out.count(-1) > 1:
        raise MXNetError("Reshape: at most one -1 allowed")
    return tuple(out)


@register("Reshape", attrs={"shape": AttrSpec("shape", default=()),
                            "target_shape": AttrSpec("shape", default=()),
                            "keep_highest": AttrSpec("bool", default=False),
                            "reverse": AttrSpec("bool", default=False)},
          aliases=("reshape",))
def _reshape(attrs, data):
    spec = attrs["shape"] or attrs["target_shape"]
    if attrs.get("reverse"):
        tgt = tuple(reversed(_reshape_target(tuple(reversed(spec)),
                                             tuple(reversed(data.shape)))))
    else:
        tgt = _reshape_target(spec, tuple(data.shape))
    return torch.reshape(data, tgt)


@register("Flatten", aliases=("flatten",))
def _flatten(attrs, data):
    """(B, ...) -> (B, prod(...)) (JAX mxnet_tpu/ops/matrix.py:122)."""
    return torch.reshape(data, (data.shape[0], -1))


@register("expand_dims", attrs={"axis": AttrSpec("int", required=True)})
def _expand_dims(attrs, data):
    return torch.unsqueeze(data, attrs["axis"])


@register("slice_axis", attrs={"axis": AttrSpec("int", required=True),
                               "begin": AttrSpec("int", default=0),
                               "end": AttrSpec("any", default=None)})
def _slice_axis(attrs, data):
    ax = attrs["axis"] % data.ndim
    end = attrs["end"]
    end = None if end in (None, "None") else int(end)
    idx = [slice(None)] * data.ndim
    idx[ax] = slice(attrs["begin"], end)
    return data[tuple(idx)]


@register("SwapAxis", attrs={"dim1": AttrSpec("int", default=0),
                             "dim2": AttrSpec("int", default=0)},
          aliases=("swapaxes",))
def _swapaxis(attrs, data):
    return torch.transpose(data, attrs["dim1"], attrs["dim2"])


@register("Embedding", attrs={"input_dim": AttrSpec("int", required=True),
                              "output_dim": AttrSpec("int", required=True),
                              "dtype": AttrSpec("dtype", default=np.float32),
                              "sparse_grad": AttrSpec("bool", default=False)},
          input_names=("data", "weight"))
def _embedding(attrs, data, weight):
    """Lookup-table embedding; float ids are cast to long indices. Under
    autograd the weight's gradient is the scatter-add of the rows' gradients
    (indexing's backward); the ids get none, and the executor writes zeros
    for them as the JAX package does for its float ids."""
    return weight[data.long()]
