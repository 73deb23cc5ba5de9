"""``matmul_with_stats`` of the port: its plain PyTorch version against the
JAX package's Pallas kernel in interpret mode (the three shapes of
``tests/test_pallas_matmul_stats.py``) and against numpy at a ragged shape
the TPU kernel's gate refuses. float32 throughout; the two sum in other
orders (K-long dot products, M-long column sums): rtol 1e-4, atol 1e-4 for C
and 1e-3 for the sums, as the JAX package's own test."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import pallas_matmul_stats as jms
from mxnet_tpu_torch import MXNetError, ops
from mxnet_tpu_torch.ops import matmul_stats as ms

torch.set_num_threads(1)


def _operands(M, K, N):
    rs = np.random.RandomState(0)
    return rs.randn(M, K).astype("float32"), rs.randn(K, N).astype("float32")


def _close(got, want):
    for g, w, atol in zip(got, want, (1e-4, 1e-3, 1e-3)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == np.shape(w) and g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=atol)


@pytest.mark.parametrize("M,K,N,bm,bn", [(256, 64, 128, 64, 128), (1024, 32, 256, 512, 256),
                                         (512, 128, 128, 128, 128)])
def test_plain_version_matches_the_pallas_kernel(M, K, N, bm, bn):
    a, b = _operands(M, K, N)
    want = jms.matmul_with_stats(jnp.asarray(a), jnp.asarray(b), block_m=bm, block_n=bn,
                                 interpret=True)
    ops.reset_launch_counts()
    got = ms.matmul_with_stats(torch.from_numpy(a), torch.from_numpy(b))
    assert ops.launch_counts()["matmul_stats"] == 0  # CPU tensors launch nothing
    _close(got, want)
    _close(ms.matmul_with_stats_plain(torch.from_numpy(a), torch.from_numpy(b)), want)


def test_ragged_shape_matches_numpy():
    M, K, N = 1000, 70, 200
    assert not jms.supported(M, K, N, itemsize=4) and ms.supported(M, K, N)
    a, b = _operands(M, K, N)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    _close(ms.matmul_with_stats(torch.from_numpy(a), torch.from_numpy(b)),
           (ref.astype(np.float32), ref.sum(0).astype(np.float32),
            (ref * ref).sum(0).astype(np.float32)))


def test_supported_states_the_ports_own_rule():
    assert ms.supported(100352, 64, 256) and ms.supported(1, 1, 1)
    assert not ms.supported(8, 8, 8, torch.bfloat16)  # the bf16 variant is not written
    assert not ms.supported(0, 8, 8) and not ms.supported(2 ** 20, 8, 2 ** 12)
    assert ms.BLOCK_M == 128


def test_dispatcher_refuses_bad_operands():
    a, b = (torch.from_numpy(x) for x in _operands(8, 4, 6))
    for bad in ((a, b.t()), (a[0], b), (a, b.double())):
        with pytest.raises(MXNetError, match=r"want a \(M, K\) and b \(K, N\)"):
            ms.matmul_with_stats(*bad)
    c, s, q = ms.matmul_with_stats(a.double(), b.double())  # the CPU route keeps a's dtype
    assert c.dtype == torch.float64 and s.dtype == q.dtype == torch.float32
