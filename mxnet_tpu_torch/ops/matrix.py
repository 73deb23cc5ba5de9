"""Shape manipulation and indexing ops.

Counterpart of ``mxnet_tpu/ops/matrix.py``: ``dot``, ``transpose``,
``Reshape`` with MXNet's shape codes, ``Flatten``, ``slice_axis``,
``SwapAxis``, ``expand_dims``, ``Concat``, ``Embedding``, ``SparseEmbedding``,
``one_hot``, the
ops the ``rnn/`` cells build with (``SliceChannel``, ``where``,
``zeros_like``, ``ones_like``), the init ops the imperative NDArray
creates arrays with (``_zeros``, ``_ones``, ``_full``, ``_arange``), and the
rest of the JAX module: ``batch_dot``, ``slice``, ``repeat``, ``tile``,
``reverse``, ``take``, ``batch_take``, ``pick``, the ordering ops ``topk``,
``sort`` and ``argsort`` on stable sorts of ``sort_key`` (``jax.lax.top_k``
and ``jnp.argsort`` keep tied elements in index order; ``top_k`` puts -0
before +0;
``torch.topk`` promises no order among ties), and ``Pad``. An init
op has no input to take its device from: it allocates on torch's current
default device, which ``ndarray.imperative_invoke`` and the executor set to
the call's context.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError, torch_dtype
from .registry import AttrSpec, register


@register("dot", attrs={"transpose_a": AttrSpec("bool", default=False),
                        "transpose_b": AttrSpec("bool", default=False)},
          input_names=("lhs", "rhs"))
def _dot(attrs, lhs, rhs):
    """Matrix/tensor product (reference: matrix_op.cc dot): the last axis of
    lhs against the first of rhs; 1-D by 1-D is the inner product."""
    if attrs["transpose_a"]:
        lhs = torch.movedim(lhs, 0, -1) if lhs.ndim > 2 else lhs.t()
    if attrs["transpose_b"]:
        rhs = torch.movedim(rhs, -1, 0) if rhs.ndim > 2 else rhs.t()
    if lhs.ndim == 1 and rhs.ndim == 1:
        return torch.dot(lhs, rhs)
    return torch.tensordot(lhs, rhs, dims=([lhs.ndim - 1], [0]))


@register("transpose", attrs={"axes": AttrSpec("shape", default=())})
def _transpose(attrs, data):
    axes = attrs["axes"] or tuple(reversed(range(data.ndim)))
    return data.permute(*axes)


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


@register("SparseEmbedding", attrs={"input_dim": AttrSpec("int", required=True),
                                    "output_dim": AttrSpec("int", required=True),
                                    "dtype": AttrSpec("dtype", default=np.float32)},
          input_names=("data", "weight"), aliases=("row_sparse_embedding",))
def _sparse_embedding(attrs, data, weight):
    """Embedding whose weight gradient is row-sparse by contract (JAX
    ``ops/matrix.py:245``): the same gather, by ``F.embedding``, whose
    backward sums each row's gradients in a sorted order (the same bits on
    every run, unlike a scatter-add by atomics). The KVStore glue routes
    the weight through the sparse round (``sparse.sparse_param_names``)."""
    return F.embedding(data.long(), weight)


def _n_args_names(attrs):
    return ["arg%d" % i for i in range(int(attrs.get("num_args", 1)))]


@register("Concat", attrs={"num_args": AttrSpec("int", required=True),
                           "dim": AttrSpec("int", default=1)},
          input_names=_n_args_names, aliases=("concat",))
def _concat(attrs, *args):
    """Concatenate along dim (reference: src/operator/concat.cc)."""
    return torch.cat(args, dim=attrs["dim"])


@register("one_hot", attrs={"depth": AttrSpec("int", required=True),
                            "on_value": AttrSpec("float", default=1.0),
                            "off_value": AttrSpec("float", default=0.0),
                            "dtype": AttrSpec("dtype", default=np.float32)},
          input_names=("indices",))
def _one_hot(attrs, indices):
    """Rows of ``off_value`` with ``on_value`` at each index; an index outside
    [0, depth) gives a row of ``off_value`` only, as jax.nn.one_hot does."""
    idx = indices.long().unsqueeze(-1)
    hot = (idx == torch.arange(attrs["depth"], device=indices.device)).to(
        torch_dtype(attrs["dtype"]))
    return hot * (attrs["on_value"] - attrs["off_value"]) + attrs["off_value"]


@register("SliceChannel", attrs={"num_outputs": AttrSpec("int", required=True),
                                 "axis": AttrSpec("int", default=1),
                                 "squeeze_axis": AttrSpec("bool", default=False)},
          num_outputs=lambda attrs: int(attrs["num_outputs"]), aliases=("split",))
def _slice_channel(attrs, data):
    """Split into equal parts along axis (reference: src/operator/slice_channel.cc)."""
    axis = attrs["axis"]
    parts = torch.split(data, data.shape[axis] // attrs["num_outputs"], dim=axis)
    if attrs["squeeze_axis"]:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


@register("where", input_names=("condition", "x", "y"))
def _where(attrs, condition, x, y):
    """Elementwise/row select (reference: control_flow_op.cc where)."""
    if condition.ndim == 1 and x.ndim > 1:
        condition = condition.reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.where(condition != 0, x, y)


@register("zeros_like")
def _zeros_like(attrs, data):
    return torch.zeros_like(data)


@register("ones_like")
def _ones_like(attrs, data):
    return torch.ones_like(data)


# --- init ops (reference: tensor/init_op.cc) ----------------------------------
def _init_attrs(**extra):
    return dict({"shape": AttrSpec("shape", default=()),
                 "dtype": AttrSpec("dtype", default=np.float32)}, **extra)


@register("_zeros", attrs=_init_attrs(), input_names=())
def _zeros(attrs):
    return torch.zeros(attrs["shape"], dtype=torch_dtype(attrs["dtype"]))


@register("_ones", attrs=_init_attrs(), input_names=())
def _ones(attrs):
    return torch.ones(attrs["shape"], dtype=torch_dtype(attrs["dtype"]))


@register("_full", attrs=_init_attrs(value=AttrSpec("float", default=0.0)), input_names=())
def _full(attrs):
    return torch.full(attrs["shape"], attrs["value"], dtype=torch_dtype(attrs["dtype"]))


@register("_arange", attrs={"start": AttrSpec("float", default=0.0),
                            "stop": AttrSpec("any", default=None),
                            "step": AttrSpec("float", default=1.0),
                            "repeat": AttrSpec("int", default=1),
                            "dtype": AttrSpec("dtype", default=np.float32)},
          input_names=())
def _arange(attrs):
    stop = attrs["stop"]
    if stop in (None, "None"):  # one bound given: it is the stop, as jnp.arange(start, None)
        start, stop = 0.0, attrs["start"]
    else:
        start, stop = attrs["start"], float(stop)
    out = torch.arange(start, stop, attrs["step"], dtype=torch_dtype(attrs["dtype"]))
    if attrs["repeat"] > 1:
        out = torch.repeat_interleave(out, attrs["repeat"])
    return out


# --- The rest of JAX mxnet_tpu/ops/matrix.py ------------------------------------
@register("batch_dot", attrs={"transpose_a": AttrSpec("bool", default=False),
                              "transpose_b": AttrSpec("bool", default=False)},
          input_names=("lhs", "rhs"))
def _batch_dot(attrs, lhs, rhs):
    """Batched matrix product (JAX :41)."""
    if attrs["transpose_a"]:
        lhs = lhs.transpose(-1, -2)
    if attrs["transpose_b"]:
        rhs = rhs.transpose(-1, -2)
    return torch.matmul(lhs, rhs)


@register("slice", attrs={"begin": AttrSpec("shape", required=True),
                          "end": AttrSpec("shape", required=True)},
          aliases=("crop",))
def _slice(attrs, data):
    return data[tuple(slice(b, e) for b, e in zip(attrs["begin"], attrs["end"]))]


def _axis_or_none(ax):
    return None if ax in (None, "None") else int(ax)


@register("repeat", attrs={"repeats": AttrSpec("int", required=True),
                           "axis": AttrSpec("any", default=None)})
def _repeat(attrs, data):
    """Each element ``repeats`` times along axis (the flattened array without
    one), as ``jnp.repeat``."""
    return torch.repeat_interleave(data, attrs["repeats"], dim=_axis_or_none(attrs["axis"]))


@register("tile", attrs={"reps": AttrSpec("shape", required=True)})
def _tile(attrs, data):
    return torch.tile(data, tuple(attrs["reps"]))


@register("reverse", attrs={"axis": AttrSpec("shape", required=True)}, aliases=("flip",))
def _reverse(attrs, data):
    return torch.flip(data, dims=tuple(attrs["axis"]))


@register("take", attrs={"axis": AttrSpec("int", default=0),
                         "mode": AttrSpec("str", default="clip")},
          input_names=("a", "indices"))
def _take(attrs, a, indices):
    """Slices of ``a`` along axis at the (truncated) indices, clipped into
    range or, with ``mode="wrap"``, taken modulo the axis (JAX :268)."""
    ax = attrs["axis"] % a.ndim
    n = a.shape[ax]
    idx = indices.long()
    idx = torch.remainder(idx, n) if attrs["mode"] == "wrap" else idx.clamp(0, n - 1)
    out = torch.index_select(a, ax, idx.reshape(-1))
    return out.reshape(tuple(a.shape[:ax]) + tuple(indices.shape) + tuple(a.shape[ax + 1:]))


@register("batch_take", input_names=("a", "indices"))
def _batch_take(attrs, a, indices):
    """out[i] = a[i, indices[i]] (JAX :281)."""
    return a.gather(1, indices.long()[:, None])[:, 0]


@register("pick", attrs={"axis": AttrSpec("int", default=1),
                         "keepdims": AttrSpec("bool", default=False)},
          input_names=("data", "index"))
def _pick(attrs, data, index):
    """data at ``index`` along axis, one element a position (JAX :310)."""
    ax = attrs["axis"] % data.ndim
    out = data.gather(ax, index.long().unsqueeze(ax))
    return out if attrs["keepdims"] else out.squeeze(ax)


def sort_key(x, signed_zeros=False):
    """Integer sort keys of x in the order JAX compares floats: ``jnp.sort``
    and ``jnp.argsort`` take -0 and +0 as equal and every NaN as one, last;
    ``lax.top_k`` (``signed_zeros``) puts -0 before +0 (IEEE total order).
    An integer tensor is its own key."""
    if not x.is_floating_point():
        return x
    if not signed_zeros:
        x = torch.where(torch.isnan(x), torch.full((), float("nan"), dtype=x.dtype,
                                                   device=x.device), x + 0.0)
    if x.dtype == torch.float64:
        i = x.view(torch.int64)
        return i ^ ((i >> 63) & 0x7FFFFFFFFFFFFFFF)
    i = x.float().view(torch.int32)
    return i ^ ((i >> 31) & 0x7FFFFFFF)


def _topk_attrs():
    return {"axis": AttrSpec("any", default=-1), "k": AttrSpec("int", default=1),
            "ret_typ": AttrSpec("str", default="indices"),
            "is_ascend": AttrSpec("bool", default=False)}


@register("topk", attrs=_topk_attrs(),
          num_outputs=lambda a: 2 if a.get("ret_typ") == "both" else 1)
def _topk(attrs, data):
    """The k largest (``is_ascend``: smallest) along axis, ties in index
    order as ``jax.lax.top_k`` gives them: a stable sort of ``sort_key``,
    then the first k (JAX :329). Indices are float32; ``ret_typ``
    value|indices|both|mask."""
    ax = attrs["axis"]
    ax = data.ndim - 1 if ax in (None, "None") else int(ax) % data.ndim
    k = attrs["k"]
    moved = torch.movedim(data, ax, -1)
    key = sort_key(-moved if attrs["is_ascend"] else moved, signed_zeros=True)
    raw_idx = torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :k]
    top_vals = torch.movedim(moved.gather(-1, raw_idx), -1, ax)
    top_idx = torch.movedim(raw_idx, -1, ax).to(torch.float32)
    rt = attrs["ret_typ"]
    if rt == "value":
        return top_vals
    if rt == "both":
        return top_vals, top_idx
    if rt == "mask":
        mask = torch.zeros_like(moved).scatter_(-1, raw_idx, 1.0)
        return torch.movedim(mask, -1, ax)
    if rt != "indices":
        raise MXNetError("topk: unsupported ret_typ %r" % rt)
    return top_idx


def _flat_axis(attrs, data):
    ax = attrs["axis"]
    if ax in (None, "None"):
        return data.reshape(-1), 0
    return data, int(ax)


@register("sort", attrs={"axis": AttrSpec("any", default=-1),
                         "is_ascend": AttrSpec("bool", default=True)})
def _sort(attrs, data):
    """Ascending along axis (the flattened array for None), reversed for
    descending (JAX :356)."""
    data, ax = _flat_axis(attrs, data)
    out = data.gather(ax, torch.argsort(sort_key(data), dim=ax, stable=True))
    return out if attrs["is_ascend"] else torch.flip(out, dims=(ax,))


@register("argsort", attrs={"axis": AttrSpec("any", default=-1),
                            "is_ascend": AttrSpec("bool", default=True)})
def _argsort(attrs, data):
    """The stable ascending order (JAX :365), reversed for descending (ties
    then in reverse index order, as the JAX op flips), as float32."""
    data, ax = _flat_axis(attrs, data)
    out = torch.argsort(sort_key(data), dim=ax, stable=True)
    if not attrs["is_ascend"]:
        out = torch.flip(out, dims=(ax,))
    return out.to(torch.float32)


@register("Pad", attrs={"mode": AttrSpec("str", default="constant"),
                        "pad_width": AttrSpec("shape", required=True),
                        "constant_value": AttrSpec("float", default=0.0)},
          aliases=("pad",))
def _pad(attrs, data):
    """N-d padding (JAX :459): ``pad_width`` holds (before, after) for every
    axis; constant, edge or reflect (the numpy modes ``jnp.pad`` takes).
    Edge and reflect pad at most the last three axes, as ``F.pad`` does."""
    import torch.nn.functional as F

    pw = attrs["pad_width"]
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(data.ndim)]
    first = next((i for i, p in enumerate(pairs) if any(p)), data.ndim)
    flat = [v for p in reversed(pairs[first:]) for v in p]  # F.pad: last axis first
    mode = attrs["mode"]
    if mode == "constant":
        return F.pad(data, flat, mode="constant", value=attrs["constant_value"])
    if data.ndim - first > 3:
        raise MXNetError("Pad: mode %r pads at most the last three axes" % mode)
    # the unpadded leading axes as one channel axis of a batch of one
    x = data.reshape((1, -1) + tuple(data.shape[first:]))
    out = F.pad(x, flat, mode="replicate" if mode == "edge" else "reflect")
    return out.reshape(tuple(data.shape[:first]) + tuple(out.shape[2:]))
