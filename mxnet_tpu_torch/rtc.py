"""Run-time kernel compilation: CUDA kernels from source strings.

Replaces ``mxnet_tpu/rtc.py`` (``Rtc._build`` :65, ``pl.pallas_call`` :76),
which compiles a Pallas kernel body from a string for the TPU. The reference
both mirror (include/mxnet/mxrtc.h, python/mxnet/rtc.py) compiled CUDA C at
run time and launched it over NDArrays, and that is what the port does:

    src = r'''
    extern "C" __global__ void kernel(const float* x, float* y) {
      int i = blockIdx.x * blockDim.x + threadIdx.x;
      if (i < 1024) y[i] = 2.f * x[i] + 1.f;
    }
    '''
    k = Rtc("axpb", src, grid=(4,), block=(256,))
    (y,) = k.push([x], out_shapes=[(1024,)])

The kernel's parameters are the inputs' device pointers in order, then the
outputs'. Sizes are written into the source by the caller, as with MXRtc.

How. At the first ``push`` the source is compiled for ``sm_90a`` with
``nvcc -cubin`` (``ops/cuda_build.compile_cubin``) and the image cached under
``build/torch_kernels/rtc/`` by a hash of source and flags. nvcc and not
NVRTC: the port's other kernels already need nvcc, so rtc needs nothing
more, and a cubin, unlike PTX, loads under any ``libcuda`` that runs the
card. The image is loaded through ``libcuda`` (``cuModuleLoadData``,
``cuModuleGetFunction``) and launched with ``cuLaunchKernel`` on torch's
current stream, with the caller's geometry. The launch does not synchronise:
a fault inside the kernel shows at the next synchronisation. The outputs are
allocated by torch on the same stream, so holding them in the returned
NDArrays keeps them alive for the kernel.

There is no CPU route and no fallback: inputs on ``cpu()`` raise (rtc was
CUDA-only in the reference too). Constructing an ``Rtc`` needs neither nvcc
nor a card. ``launches`` and ``compiles`` count, per object and for the
module, the kernel launches made and the nvcc runs they needed.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from .base import MXNetError, np_dtype, torch_dtype
from .context import current_context
from . import ndarray as nd
from .ops import cuda_build

__all__ = ["Rtc"]

launches = 0
compiles = 0


def default_out_dtypes(in_dtypes, n_out):
    """Output i takes input i's dtype; outputs beyond the inputs take the
    first input's, or float32 when there is no input (as the JAX package's
    ``push``, rtc.py:92-95)."""
    fill = in_dtypes[0] if in_dtypes else np.dtype(np.float32)
    return [in_dtypes[i] if i < len(in_dtypes) else fill for i in range(n_out)]


def _dims(value, what):
    """A launch extent as three positive ints."""
    dims = (value,) if isinstance(value, (int, np.integer)) else tuple(value)
    if not 1 <= len(dims) <= 3 or any(int(d) != d or d < 1 for d in dims):
        raise MXNetError("rtc: %s must be one to three positive ints, got %r" % (what, value))
    return tuple(int(d) for d in dims) + (1,) * (3 - len(dims))


class Rtc:
    """A CUDA kernel compiled from source at run time (reference: mxrtc.h
    MXRtc; python/mxnet/rtc.py Rtc).

    ``source`` is a CUDA translation unit that defines
    ``extern "C" __global__ void <kernel_name>(...)``. ``grid`` and ``block``
    are the default launch geometry; ``push`` may override them."""

    def __init__(self, name, source, kernel_name="kernel", grid=None, block=None):
        self.name = name
        self._source = source
        self._kernel_name = kernel_name
        self._grid, self._block = grid, block
        if 'extern "C"' not in source or not re.search(
                r"__global__[^;{}]*?\b%s\s*\(" % re.escape(kernel_name), source):
            raise MXNetError('rtc: source of %r does not define extern "C" __global__ void %s(...)'
                             % (name, kernel_name))
        self._image = None
        self._functions = {}  # device index -> (module, function)
        self.launches = 0
        self.compiles = 0

    def _function(self, device):
        global compiles
        if self._image is None:
            self._image, compiled = cuda_build.compile_cubin(self._source, self.name)
            self.compiles += compiled
            compiles += compiled
        if device.index not in self._functions:
            self._functions[device.index] = cuda_build.load_function(
                self._image, self._kernel_name, device)
        return self._functions[device.index][1]

    def push(self, inputs, out_shapes, out_dtypes=None, grid_dims=None, block_dims=None):
        """Launch the kernel over ``inputs`` (NDArrays, or numpy arrays copied
        to the NDArrays' context) and return one new NDArray per entry of
        ``out_shapes``, on the inputs' context (reference: rtc.py Rtc.push).

        ``grid_dims``/``block_dims`` are the CUDA launch geometry (blocks and
        threads, one to three ints each), defaulting to the constructor's
        ``grid``/``block``; one of the two must give each."""
        global launches
        grid = grid_dims if grid_dims is not None else self._grid
        block = block_dims if block_dims is not None else self._block
        if grid is None:
            raise MXNetError("rtc: %r has no launch grid: pass grid_dims to push() or grid to "
                             "Rtc()" % self.name)
        if block is None:
            raise MXNetError("rtc: %r has no block size: pass block_dims to push() or block "
                             "to Rtc()" % self.name)
        grid, block = _dims(grid, "grid_dims"), _dims(block, "block_dims")
        ctx = next((x.context for x in inputs if isinstance(x, nd.NDArray)), None) \
            or current_context()
        arrays = [x if isinstance(x, nd.NDArray) else nd.array(np.asarray(x), ctx=ctx)
                  for x in inputs]
        if out_dtypes is None:
            out_dtypes = default_out_dtypes([a.dtype for a in arrays], len(out_shapes))
        if len(out_dtypes) != len(out_shapes):
            raise MXNetError("rtc: %d out_shapes but %d out_dtypes"
                             % (len(out_shapes), len(out_dtypes)))
        if ctx.device_type != "gpu" or any(a.context != ctx for a in arrays):
            raise MXNetError("rtc: %r runs on one CUDA device only (no CPU route); inputs are "
                             "on %s" % (self.name, [str(a.context) for a in arrays] or ctx))
        device = ctx.torch_device
        # the kernel indexes dense arrays: a transposed or strided holder is copied
        tensors = [a._tensor().contiguous() for a in arrays]
        outs = [torch.empty(tuple(s), dtype=torch_dtype(np_dtype(d)), device=device)
                for s, d in zip(out_shapes, out_dtypes)]
        function = self._function(device)
        cuda_build.launch_function(function, grid, block,
                                   [t.data_ptr() for t in tensors + outs], device)
        self.launches += 1
        launches += 1
        return [nd._wrap(o, ctx) for o in outs]
