"""NDArray: the imperative tensor API.

Counterpart of ``mxnet_tpu/ndarray.py``: creation (``array``, ``empty``,
``zeros``, ``ones``, ``full``, ``arange``, ``concatenate``,
``onehot_encode``), views, operators, ``imperative_invoke``, one
module-level function per registered op, and ``save``/``load`` in the
reference's ``.params`` layout. PyTorch runs each op as it is reached and
returns before the card has finished, so ``waitall`` runs
``torch.cuda.synchronize`` and then drains the host work queued on the
execution engine (``engine.py``: checkpoint writes), as the JAX package's
does.

Views. ``reshape``, ``slice``, ``at`` and ``arr[i]``/``arr[a:b]`` share one
``_Chunk`` with their parent, as in the JAX package (reference: NDArray::Chunk,
ndarray.h:374), and every read and write goes through the chunk's current
tensor. ``_set_tensor`` on a whole array swaps that tensor without a copy
(``KVCacheDecoder`` swaps its ring buffers so); a torch view of the old
tensor would go stale then, a view held through the chunk follows its parent.

Ops run outside autograd and return new arrays; an op given ``out`` writes
into it in place (the optimizer updates a weight and its state where they
lie), and an op with aux state (BatchNorm) writes its new aux values into
its aux inputs, the reference's FMutateInputs contract.
"""
from __future__ import annotations

import builtins
import contextlib
import struct
import sys
from typing import List, Optional

import numpy as np
import torch

from .base import MXNetError, dtype_code, dtype_from_code, np_dtype, numpy_dtype, torch_dtype
from .context import Context, current_context
from . import ops as _ops  # noqa: F401  (registers every op before the functions below are made)
from .ops import registry as _registry
from .ops.registry import get_op, parse_attrs

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange", "concatenate",
           "onehot_encode", "save", "load", "waitall", "imperative_invoke"]

_MAGIC_LIST = 0x112  # reference: kMXAPINDArrayListMagic (src/c_api/c_api.cc)


class _Chunk:
    """The tensor an array and its views share."""

    __slots__ = ("data", "ctx")

    def __init__(self, data: torch.Tensor, ctx: Context):
        self.data = data
        self.ctx = ctx


def _to_tensor(value, ctx: Context, dtype=None) -> torch.Tensor:
    """``value`` (NDArray, tensor, numpy, list or scalar) as a tensor on
    ``ctx``. Numpy and list input in float64 becomes float32, the framework's
    default, unless ``dtype`` says otherwise; a tensor keeps its dtype, and
    one already on ``ctx`` is returned as it is, not copied."""
    if isinstance(value, NDArray):
        value = value._tensor()
    if not isinstance(value, torch.Tensor):
        arr = np.asarray(value, dtype=None if dtype is None else np_dtype(dtype))
        if arr.dtype == np.float64 and dtype is None:
            arr = arr.astype(np.float32)
        value = torch.from_numpy(np.ascontiguousarray(arr))
    value = value.detach().to(ctx.torch_device)
    return value if dtype is None else value.to(torch_dtype(dtype))


class NDArray:
    """An n-dimensional array on one device. ``NDArray(data, ctx)`` holds
    ``data`` (a tensor is held as it is, not copied; ``ctx`` defaults to
    ``current_context()``, the GPU)."""

    __slots__ = ("_chunk", "_begin", "_end", "_shape", "_whole")

    def __init__(self, data=None, ctx=None, *, chunk=None, begin=None, end=None, shape=None):
        if chunk is None:
            ctx = ctx or current_context()
            chunk = _Chunk(_to_tensor(data, ctx), ctx)
            shape = chunk.data.shape
        self._chunk = chunk
        self._begin = begin
        self._end = end
        self._shape = tuple(int(d) for d in shape)
        # the whole chunk in its own shape (a swap keeps the shape), or a view
        self._whole = begin is None and self._shape == tuple(chunk.data.shape)

    # ------------------------------------------------------------------ core
    def _tensor(self) -> torch.Tensor:
        """The array's tensor: the chunk's own for a whole array, a torch
        view of it for a view."""
        d = self._chunk.data
        if self._whole:
            return d
        if not d.is_contiguous():
            # rows of a transposed tensor cannot be viewed in another shape;
            # the chunk owns its tensor, so it is laid out anew once
            d = self._chunk.data = d.contiguous()
        if self._begin is not None:
            d = d[self._begin:self._end]
        return d.view(self._shape)

    def _set_tensor(self, tensor: torch.Tensor):
        """Take ``tensor`` as the new value; it must keep shape, dtype and
        device. A whole array swaps its chunk's tensor (no copy), and its
        views follow; a view copies into its part of the chunk."""
        cur = self._tensor()
        if tuple(tensor.shape) != self._shape or tensor.dtype != cur.dtype \
                or tensor.device != cur.device:
            raise MXNetError("NDArray._set_tensor: %s %s on %s cannot replace %s %s on %s"
                             % (tuple(tensor.shape), tensor.dtype, tensor.device,
                                self._shape, cur.dtype, cur.device))
        if self._whole:
            self._chunk.data = tensor
        else:
            cur.copy_(tensor)

    # ------------------------------------------------------------- properties
    @property
    def shape(self):
        return self._shape

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def size(self):
        return int(np.prod(self._shape)) if self._shape else 1

    @property
    def dtype(self) -> np.dtype:
        return numpy_dtype(self._chunk.data.dtype)

    @property
    def context(self) -> Context:
        return self._chunk.ctx

    ctx = context

    def __reduce__(self):
        """Pickles (the optimizer's state file) hold the values and the
        context; unpickling puts the values back on that context."""
        return (_unpickle, (self.asnumpy(), self.context.device_typeid, self.context.device_id))

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(str(s) for s in self._shape), self.context)

    def __len__(self):
        if not self._shape:
            raise TypeError("len() of 0-d NDArray")
        return self._shape[0]

    # ------------------------------------------------------------- conversion
    def asnumpy(self) -> np.ndarray:
        """A host copy (waits for the card)."""
        t = self._tensor().detach()
        # .cpu() of a tensor on the card is a new host tensor already
        return t.cpu().numpy() if t.is_cuda else t.numpy().copy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("the array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def astype(self, dtype) -> "NDArray":
        return imperative_invoke("Cast", [self], {"dtype": np_dtype(dtype)})[0]

    def wait_to_read(self):
        if self._chunk.data.is_cuda:
            torch.cuda.current_stream(self._chunk.data.device).synchronize()

    wait_to_write = wait_to_read

    # -------------------------------------------------------------- views
    def _view(self, begin, end, shape):
        return NDArray(chunk=self._chunk, begin=begin, end=end, shape=shape)

    def reshape(self, shape) -> "NDArray":
        if isinstance(shape, int):
            shape = (shape,)
        shape = tuple(shape)
        if -1 in shape:
            known = int(np.prod([s for s in shape if s != -1]))
            shape = tuple(self.size // builtins.max(known, 1) if s == -1 else s for s in shape)
        if int(np.prod(shape)) != self.size:
            raise MXNetError("reshape size mismatch %s -> %s" % (self._shape, shape))
        return self._view(self._begin, self._end, shape)

    def slice(self, begin, end) -> "NDArray":
        """Axis-0 view sharing memory (reference: ndarray.h:284 Slice)."""
        n = self._shape[0]
        begin = int(begin) % n if begin < 0 else int(begin)
        end = n if end is None else (int(end) + n if end < 0 else int(end))
        if not (0 <= begin <= end <= n):
            raise MXNetError("invalid slice [%s, %s) for axis size %d" % (begin, end, n))
        if self._whole:
            b0, e0 = begin, end
        else:
            # view of a view: only valid when self spans whole rows of the chunk
            per_row = self.size // builtins.max(n, 1)
            chunk_row = int(np.prod(self._chunk.data.shape[1:])) or 1
            if per_row % chunk_row != 0:
                raise MXNetError("unsupported nested view slicing")
            rows_per = per_row // chunk_row
            b0 = (self._begin or 0) + begin * rows_per
            e0 = (self._begin or 0) + end * rows_per
        return self._view(b0, e0, (end - begin,) + self._shape[1:])

    def at(self, idx) -> "NDArray":
        orig = idx = int(idx)
        n0 = self._shape[0] if self._shape else 0
        if idx < 0:
            idx += n0
        if not 0 <= idx < n0:
            # IndexError, not MXNetError: `for row in arr` probes increasing
            # indices and stops on IndexError (sequence protocol)
            raise IndexError("index %d out of bounds for axis of size %d" % (orig, n0))
        v = self.slice(idx, idx + 1)
        return self._view(v._begin, v._end, self._shape[1:])

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            return self.at(key)
        if isinstance(key, builtins.slice):
            if key.step is not None and key.step != 1:
                raise MXNetError("NDArray only supports step=1 slicing")
            return self.slice(0 if key.start is None else key.start, key.stop)
        # advanced indexing returns a copy
        return NDArray(self._tensor()[key].clone(), ctx=self.context)

    def __setitem__(self, key, value):
        target = self
        if isinstance(key, (int, np.integer)):
            target = self.at(key)
        elif isinstance(key, builtins.slice):
            if not (key.start is None and key.stop is None and key.step is None):
                target = self[key]
        elif isinstance(key, tuple):
            dst = self._tensor()
            dst[key] = value if isinstance(value, (int, float)) else \
                _to_tensor(value, self.context, dtype=self.dtype)
            return
        dst = target._tensor()
        if isinstance(value, (int, float, np.generic)):
            dst.fill_(value)
            return
        if isinstance(value, NDArray):
            value = value._tensor()
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.ascontiguousarray(value, dtype=target.dtype))
        # copy_ broadcasts, converts dtype, and copies across devices
        dst.copy_(value.detach())

    # ------------------------------------------------------------- transfers
    def copyto(self, other):
        """Copy into another NDArray, or onto another context as a new one
        (card to card and card to host without a detour)."""
        if isinstance(other, NDArray):
            if other is self or other._chunk is self._chunk:
                raise MXNetError("copyto: source and target are the same")
            other[:] = self
            return other
        if isinstance(other, Context):
            return NDArray(self._tensor().to(other.torch_device, copy=True), ctx=other)
        raise TypeError("copyto: unsupported target %r" % (other,))

    def copy(self) -> "NDArray":
        return self.copyto(self.context)

    def as_in_context(self, ctx: Context) -> "NDArray":
        if ctx == self.context:
            return self
        return self.copyto(ctx)

    # ------------------------------------------------------------- arithmetic
    def _binary(self, other, op, scalar_op, reverse=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return imperative_invoke(op, [a, b], {})[0]
        return imperative_invoke(scalar_op, [self], {"scalar": float(other)})[0]

    def __add__(self, other):
        return self._binary(other, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, other):
        return self._binary(other, "broadcast_sub", "_rminus_scalar", reverse=True)

    def __mul__(self, other):
        return self._binary(other, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, other):
        return self._binary(other, "broadcast_div", "_rdiv_scalar", reverse=True)

    __div__ = __truediv__
    __rdiv__ = __rtruediv__

    def __pow__(self, other):
        return self._binary(other, "broadcast_power", "_power_scalar")

    def __rpow__(self, other):
        return self._binary(other, "broadcast_power", "_rpower_scalar", reverse=True)

    def __mod__(self, other):
        return self._binary(other, "broadcast_mod", "_mod_scalar")

    def __neg__(self):
        return imperative_invoke("negative", [self], {})[0]

    def __eq__(self, other):
        return self._binary(other, "broadcast_equal", "_equal_scalar")

    def __ne__(self, other):
        return self._binary(other, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, other):
        return self._binary(other, "broadcast_greater", "_greater_scalar")

    def __ge__(self, other):
        return self._binary(other, "broadcast_greater_equal", "_greater_equal_scalar")

    def __lt__(self, other):
        return self._binary(other, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, other):
        return self._binary(other, "broadcast_lesser_equal", "_lesser_equal_scalar")

    # == compares elementwise and returns an array, so an NDArray hashes by
    # identity (as the JAX class does): two equal arrays are two dict keys
    __hash__ = object.__hash__

    def __iadd__(self, other):
        self[:] = self + other
        return self

    def __isub__(self, other):
        self[:] = self - other
        return self

    def __imul__(self, other):
        self[:] = self * other
        return self

    def __itruediv__(self, other):
        self[:] = self / other
        return self

    @property
    def T(self):
        return imperative_invoke("transpose", [self], {})[0]

    # numpy-style conveniences mapped onto registered ops
    def sum(self, axis=(), keepdims=False):
        return imperative_invoke("sum", [self], {"axis": axis, "keepdims": keepdims})[0]

    def mean(self, axis=(), keepdims=False):
        return imperative_invoke("mean", [self], {"axis": axis, "keepdims": keepdims})[0]

    def max(self, axis=(), keepdims=False):
        return imperative_invoke("max", [self], {"axis": axis, "keepdims": keepdims})[0]

    def min(self, axis=(), keepdims=False):
        return imperative_invoke("min", [self], {"axis": axis, "keepdims": keepdims})[0]


def _unpickle(host, device_typeid, device_id) -> NDArray:
    return NDArray(torch.from_numpy(host), ctx=Context(Context.devtype2str[device_typeid],
                                                       device_id))


def _wrap(tensor: torch.Tensor, ctx: Context) -> NDArray:
    """An NDArray over a tensor that already lies on ``ctx``: no check, no
    copy (an executor's outputs, an op's results)."""
    return NDArray(chunk=_Chunk(tensor, ctx), shape=tensor.shape)


# ---------------------------------------------------------------- dispatch
def _shares_storage(t: torch.Tensor, others) -> bool:
    if t.device.type == "meta":
        return False
    ptr = t.untyped_storage().data_ptr()
    return builtins.any(o.untyped_storage().data_ptr() == ptr for o in others)


def imperative_invoke(op_name, inputs, attrs, out=None, ctx=None, is_train=True,
                      rng=None) -> List[NDArray]:
    """Run a registered op eagerly on NDArrays, outside autograd (reference:
    MXImperativeInvoke, src/c_api/c_api_ndarray.cc:322).

    The op's trailing aux inputs (BatchNorm's moving stats) take its new aux
    values in place. With ``out`` each result is written into its ``out``
    array in place and ``out`` is returned; without it the results are new
    arrays on ``ctx`` (default: the first input's context, else the ``ctx``
    attribute, else ``current_context()``), never aliases of an input. ``rng``
    is a ``torch.Generator`` for an op that draws random numbers; without
    one such an op draws from ``ctx``'s device generator (``random.py``), on
    that device."""
    opdef = get_op(op_name)
    attrs = parse_attrs(opdef, attrs)
    n_aux = len(opdef.aux_names(attrs))
    if ctx is None:
        ctx = inputs[0].context if inputs else (
            Context(attrs["ctx"]) if attrs.get("ctx") else current_context())
    if opdef.needs_rng and rng is None:
        from . import random as _random

        rng = _random.generator(ctx.torch_device)
    from . import autograd as _ag

    tensors = [x._tensor() for x in inputs]
    n_in = len(tensors) - n_aux
    # under autograd.record() the op reads the recorded tensors and runs
    # under grad mode; its results keep their graph in the autograd module
    recording = _ag.is_recording()
    ins = [_ag._recorded(x) for x in inputs[:n_in]] if recording else tensors[:n_in]
    # an op without inputs allocates on torch's default device: make that ctx's
    device = contextlib.nullcontext() if tensors else torch.device(ctx.torch_device)
    with torch.enable_grad() if recording else torch.no_grad(), device:
        outs, new_aux = opdef.apply(attrs, ins, aux=tensors[n_in:],
                                    is_train=bool(is_train), rng=rng)
    with torch.no_grad():
        for t, new in zip(tensors[n_in:], new_aux):
            if new is not t:
                t.copy_(new)
        if out is not None:
            targets = list(out) if isinstance(out, (list, tuple)) else [out]
            for t, o in zip(targets, outs):
                t._tensor().copy_(o)
        else:
            # a reshape, a transpose or the identity returns a torch view of
            # its input; a new NDArray owns its memory, laid out densely
            targets = [_wrap(o.detach().clone(memory_format=torch.contiguous_format)
                             if _shares_storage(o, tensors) else o.detach(), ctx) for o in outs]
    if recording:
        _ag._record_outputs(targets, outs)
    return targets


def _make_op_function(op_name):
    opdef = get_op(op_name)

    def fn(*args, out=None, name=None, ctx=None, **kwargs):
        if not builtins.all(isinstance(a, NDArray) for a in args):
            raise MXNetError("%s: positional args must be NDArrays; use kwargs for attrs"
                             % op_name)
        inputs = list(args)
        # named tensor inputs may come via kwargs (data=..., weight=...)
        attrs = {k: v for k, v in kwargs.items() if not isinstance(v, NDArray)}
        named_inputs = {k: v for k, v in kwargs.items() if isinstance(v, NDArray)}
        if named_inputs:
            probe = parse_attrs(opdef, attrs)
            for n in opdef.input_names(probe) + opdef.aux_names(probe):
                if n in named_inputs:
                    inputs.append(named_inputs.pop(n))
            if named_inputs:
                raise MXNetError("%s: unknown tensor inputs %s" % (op_name, list(named_inputs)))
        outs = imperative_invoke(op_name, inputs, attrs, out=out, ctx=ctx)
        return outs[0] if len(outs) == 1 else outs

    fn.__name__ = op_name
    fn.__doc__ = opdef.doc
    return fn


def _init_ndarray_module():
    """Expose every registered op as a module-level function (reference:
    python/mxnet/ndarray.py _init_ndarray_module). They shadow builtins such
    as ``sum``, ``max``, ``abs`` and ``round`` in this module: the code here
    says ``builtins.`` where it means those."""
    mod = sys.modules[__name__]
    for name in list(_registry._REGISTRY.keys()):
        if not hasattr(mod, name):
            setattr(mod, name, _make_op_function(name))


# ---------------------------------------------------------------- creation
def array(source_array, ctx=None, dtype=None) -> NDArray:
    """A new array holding a copy of ``source_array`` (NDArray, numpy, list).
    Numpy dtypes are kept, lists and float64 become float32."""
    ctx = ctx or current_context()
    if isinstance(source_array, NDArray):
        source_array = source_array.asnumpy()
    if dtype is None:
        dtype = source_array.dtype if isinstance(source_array, np.ndarray) else np.float32
        if np.dtype(dtype) == np.float64:
            dtype = np.float32
    return NDArray(torch.from_numpy(np.array(source_array, dtype=np_dtype(dtype))), ctx=ctx)


def _shape_tuple(shape):
    return (shape,) if isinstance(shape, (int, np.integer)) else tuple(shape)


def zeros(shape, ctx=None, dtype=np.float32) -> NDArray:
    """Zeros on ``ctx`` (default ``current_context()``, the GPU)."""
    return imperative_invoke("_zeros", [], {"shape": _shape_tuple(shape),
                                            "dtype": np_dtype(dtype)},
                             ctx=ctx or current_context())[0]


empty = zeros


def ones(shape, ctx=None, dtype=np.float32) -> NDArray:
    return imperative_invoke("_ones", [], {"shape": _shape_tuple(shape),
                                           "dtype": np_dtype(dtype)},
                             ctx=ctx or current_context())[0]


def full(shape, val, ctx=None, dtype=np.float32) -> NDArray:
    return imperative_invoke("_full", [], {"shape": _shape_tuple(shape), "value": float(val),
                                           "dtype": np_dtype(dtype)},
                             ctx=ctx or current_context())[0]


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=np.float32) -> NDArray:
    if stop is None:
        start, stop = 0.0, start
    return imperative_invoke("_arange", [], {"start": float(start), "stop": float(stop),
                                             "step": float(step), "repeat": int(repeat),
                                             "dtype": np_dtype(dtype)},
                             ctx=ctx or current_context())[0]


def concatenate(arrays, axis=0, always_copy=True) -> NDArray:
    return imperative_invoke("Concat", list(arrays), {"num_args": len(arrays), "dim": axis})[0]


def onehot_encode(indices, out):
    """(reference: ndarray.py onehot_encode) one-hot fill of ``out``."""
    return imperative_invoke("one_hot", [indices], {"depth": out.shape[1]}, out=out)[0]


def waitall():
    """Block until all pending work is done (reference: MXNDArrayWaitAll):
    the card's (CPU ops have finished when they return), then the host work
    queued on the execution engine, whose failures it raises."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    from . import engine

    if engine._engine is not None:  # nothing was ever pushed without one
        engine._engine.wait_for_all()


# ---------------------------------------------------------------- serialization
def _write_ndarray(f, arr: Optional[NDArray]):
    """Reference-exact layout (src/ndarray/ndarray.cc:623-645 NDArray::Save):
    TShape (uint32 ndim + uint32 dims), then, unless the array is_none
    (ndim == 0), Context (int32 dev_type, int32 dev_id), int32 type_flag, and
    the raw contiguous bytes with no length prefix. An array on the card is
    written with the GPU's dev_type; the loaders ignore that field."""
    if arr is None:
        f.write(struct.pack("<I", 0))  # is_none: shape only, like the reference
        return
    np_arr = arr.asnumpy()
    shape = np_arr.shape
    if len(shape) == 0:
        # the reference format has no 0-d representation (ndim == 0 means
        # is_none, ndarray.cc:650-652): refuse rather than drop data
        raise MXNetError("cannot save 0-d NDArray in the .params format; reshape to (1,)")
    f.write(struct.pack("<I", len(shape)))
    f.write(struct.pack("<%dI" % len(shape), *shape))
    f.write(struct.pack("<ii", arr.context.device_typeid, arr.context.device_id))
    f.write(struct.pack("<i", dtype_code(np_arr.dtype)))
    f.write(np.ascontiguousarray(np_arr).tobytes())


def _read_exact(f, n):
    data = f.read(n)
    if len(data) != n:
        raise MXNetError("NDArray file is truncated: wanted %d bytes, got %d" % (n, len(data)))
    return data


def _read_ndarray(f, ctx: Context) -> Optional[NDArray]:
    (ndim,) = struct.unpack("<I", _read_exact(f, 4))
    if ndim == 0:
        return None  # reference: is_none NDArray (ndarray.cc:650-652)
    shape = struct.unpack("<%dI" % ndim, _read_exact(f, 4 * ndim))
    _read_exact(f, 8)  # the saved context: an array loads onto ctx wherever it was saved
    (dt_code,) = struct.unpack("<i", _read_exact(f, 4))
    dtype = dtype_from_code(dt_code)
    nbytes = int(np.prod(shape)) * dtype.itemsize
    host = np.frombuffer(_read_exact(f, nbytes), dtype=dtype).reshape(shape).copy()
    return NDArray(torch.from_numpy(host), ctx=ctx)


def _save_stream(f, data):
    if isinstance(data, dict):
        names, arrays = list(data.keys()), list(data.values())
    elif isinstance(data, (list, tuple)):
        names, arrays = [], list(data)
    elif isinstance(data, NDArray):
        names, arrays = [], [data]
    else:
        raise TypeError("save: need dict/list/NDArray")
    f.write(struct.pack("<QQ", _MAGIC_LIST, 0))
    f.write(struct.pack("<Q", len(arrays)))
    for a in arrays:
        _write_ndarray(f, a)
    f.write(struct.pack("<Q", len(names)))
    for n in names:
        b = n.encode("utf-8")
        f.write(struct.pack("<Q", len(b)))
        f.write(b)


def _load_stream(f, ctx: Context = None, what="stream"):
    ctx = ctx or current_context()
    magic, _ = struct.unpack("<QQ", _read_exact(f, 16))
    if magic != _MAGIC_LIST:
        raise MXNetError("invalid NDArray file %s" % what)
    (count,) = struct.unpack("<Q", _read_exact(f, 8))
    arrays = [_read_ndarray(f, ctx) for _ in range(count)]
    (n_names,) = struct.unpack("<Q", _read_exact(f, 8))
    names = []
    for _ in range(n_names):
        (ln,) = struct.unpack("<Q", _read_exact(f, 8))
        names.append(_read_exact(f, ln).decode("utf-8"))
    return dict(zip(names, arrays)) if names else arrays


def save(fname: str, data):
    """Save a dict, a list or one NDArray in the reference's ``.params``
    layout (kMXAPINDArrayListMagic, ndarray.h:358-369): the file the JAX
    package's ``nd.save`` writes for the same data."""
    with open(fname, "wb") as f:
        _save_stream(f, data)


def load(fname: str, ctx: Context = None):
    """Load what ``save`` (of either package) wrote, onto ``ctx`` (default
    ``current_context()``, the GPU): a dict if names were saved, else a list."""
    with open(fname, "rb") as f:
        return _load_stream(f, ctx, what=fname)


_init_ndarray_module()
