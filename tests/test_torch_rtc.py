"""``mx.rtc`` of the port on a host without nvcc or a card: construction,
the refusals, and the ``out_dtypes`` default rule against the JAX package's
``Rtc.push`` (Pallas interpret mode). The launches themselves run on the
card (``tests/test_torch_cuda.py``)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu_torch import rtc

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SRC = r"""
extern "C" __global__ void kernel(const float* x, float* y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 8) y[i] = 2.f * x[i] + 1.f;
}
"""


def test_constructs_and_imports_with_nvcc_hidden():
    code = """
import shutil, sys
assert shutil.which("nvcc") is None
import mxnet_tpu_torch as pt
k = pt.rtc.Rtc("axpb", %r, grid=(1,), block=(32,))
assert (k.compiles, k.launches) == (0, 0) and "jax" not in sys.modules
print("ok")
""" % SRC
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT), PATH="/nonexistent",
                                  CUDA_HOME="/nonexistent"))
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stdout + res.stderr


@pytest.mark.parametrize("source,kernel_name", [
    ('extern "C" __global__ void other(float* y) {}', "kernel"),
    ('__global__ void kernel(float* y) {}', "kernel"),               # no C linkage
    ('extern "C" void kernel(float* y); // __global__', "kernel"),   # a declaration of a host function
    ('extern "C" __global__ void kernel2(float* y) {}', "kernel"),
    (SRC, "fma3"),
])
def test_source_without_the_kernel_raises(source, kernel_name):
    with pytest.raises(pt.MXNetError, match="does not define"):
        rtc.Rtc("bad", source, kernel_name=kernel_name)


def test_source_forms_that_define_the_kernel_construct():
    rtc.Rtc("a", SRC)
    rtc.Rtc("b", 'extern "C" __global__ void __launch_bounds__(256) fma3(float* y) {}',
            kernel_name="fma3")
    rtc.Rtc("c", 'extern "C" {\n__global__ void kernel(float* y) {}\n}')


def test_missing_geometry_raises_naming_the_argument():
    x = pt.nd.ones((8,), ctx=pt.cpu())
    with pytest.raises(pt.MXNetError, match="grid_dims"):
        rtc.Rtc("k", SRC).push([x], out_shapes=[(8,)])
    with pytest.raises(pt.MXNetError, match="block_dims"):
        rtc.Rtc("k", SRC, grid=(1,)).push([x], out_shapes=[(8,)])
    with pytest.raises(pt.MXNetError, match="block_dims"):
        rtc.Rtc("k", SRC).push([x], out_shapes=[(8,)], grid_dims=(1,))
    for bad in ((), (1, 1, 1, 1), (0,), (1.5,)):
        with pytest.raises(pt.MXNetError, match="one to three positive ints"):
            rtc.Rtc("k", SRC, block=32).push([x], out_shapes=[(8,)], grid_dims=bad)


def test_cpu_inputs_raise_and_nothing_is_compiled_or_launched():
    k = rtc.Rtc("k", SRC, grid=1, block=32)
    before = pt.ops.launch_counts()["rtc"]
    for inputs in ([pt.nd.ones((8,), ctx=pt.cpu())],
                   [pt.nd.ones((8,), ctx=pt.cpu()), np.ones(8, np.float32)]):
        with pytest.raises(pt.MXNetError, match="no CPU route"):
            k.push(inputs, out_shapes=[(8,)])
    assert (k.compiles, k.launches, pt.ops.launch_counts()["rtc"]) == (0, 0, before)
    with pytest.raises(pt.MXNetError, match="out_dtypes"):
        k.push([pt.nd.ones((8,), ctx=pt.cpu())], out_shapes=[(8,)], out_dtypes=[])


def test_numpy_only_inputs_go_to_the_default_context_the_gpu(monkeypatch):
    # the default no variable names (tests/conftest.py sets one for JAX)
    monkeypatch.delenv("MXNET_DEFAULT_CONTEXT", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(pt.MXNetError, match="CUDA is not available"):
        rtc.Rtc("k", SRC, grid=1, block=32).push([np.ones(8, np.float32)], out_shapes=[(8,)])


def test_default_out_dtypes_rule_is_the_reference_rule():
    """Output i takes input i's dtype, outputs past the inputs the first
    input's: read off what the JAX package's push returns."""
    jk = mx.rtc.Rtc("three", """
def kernel(a_ref, b_ref, o1_ref, o2_ref, o3_ref):
    o1_ref[:] = a_ref[:] + 1.0
    o2_ref[:] = b_ref[:] + 1
    o3_ref[:] = a_ref[:] - 1.0
""")
    a, b = np.ones((2, 2), np.float32), np.ones((2, 2), np.int32)
    outs = jk.push([mx.nd.array(a), mx.nd.array(b)], out_shapes=[(2, 2)] * 3)
    want = [np.dtype(o.dtype) for o in outs]
    assert want == [np.float32, np.int32, np.float32]
    assert rtc.default_out_dtypes([np.dtype(a.dtype), np.dtype(b.dtype)], 3) == want
    assert rtc.default_out_dtypes([np.dtype(np.int32)], 2) == [np.int32, np.int32]
    assert rtc.default_out_dtypes([], 2) == [np.float32, np.float32]
    assert rtc.default_out_dtypes([np.dtype(np.int32), np.dtype(np.float32)], 1) == [np.int32]
