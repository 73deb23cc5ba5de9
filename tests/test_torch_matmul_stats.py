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


def _bf16_ulp_of_max(x):
    """One bfloat16 ulp (8 significant bits) at the largest magnitude of x."""
    return 2.0 ** (np.floor(np.log2(np.max(np.abs(x)))) - 7)


def test_plain_version_matches_the_pallas_kernel_in_bfloat16():
    """C in bfloat16, the statistics from the float32 accumulator before C
    is rounded, as the Pallas kernel takes them: C within one bfloat16 ulp of
    its largest magnitude, the sums at the float32 tolerances above."""
    M, K, N = 512, 64, 256
    a, b = _operands(M, K, N)
    want = jms.matmul_with_stats(jnp.asarray(a).astype(jnp.bfloat16),
                                 jnp.asarray(b).astype(jnp.bfloat16), interpret=True)
    c, s, q = ms.matmul_with_stats(torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16())
    assert c.dtype == torch.bfloat16 and s.dtype == q.dtype == torch.float32
    wc = np.asarray(want[0].astype(jnp.float32))
    assert np.max(np.abs(c.float().numpy() - wc)) <= _bf16_ulp_of_max(wc)
    for g, w in zip((s, q), want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-3)


def test_supported_states_the_ports_own_rule():
    assert ms.supported(100352, 64, 256) and ms.supported(1, 1, 1)
    assert not ms.supported(8, 8, 8, torch.bfloat16)  # the bf16 variant is not written
    assert not ms.supported(0, 8, 8) and not ms.supported(2 ** 20, 8, 2 ** 12)
    # the C entry's layout codes, in order (csrc/matmul_stats.cu)
    assert [v[0] for v in ms.LAYOUTS.values()] == list(range(len(ms.LAYOUTS)))


def test_dispatcher_refuses_bad_operands():
    a, b = (torch.from_numpy(x) for x in _operands(8, 4, 6))
    for bad in ((a, b.t()), (a[0], b), (a, b.double())):
        with pytest.raises(MXNetError, match=r"want a \(M, K\) and b \(K, N\)"):
            ms.matmul_with_stats(*bad)
    c, s, q = ms.matmul_with_stats(a.double(), b.double())  # the CPU route keeps a's dtype
    assert c.dtype == torch.float64 and s.dtype == q.dtype == torch.float32


# (M, K, N) -> (kind, layout, groups, n_slabs): ResNet-50's 1x1 convolutions
# at batch 32 that chip_smoke.py times, then the ragged shapes of its checks
# and of tests/test_torch_cuda.py
@pytest.mark.parametrize("M,K,N,want", [
    (100352, 64, 256, ("short_k", "short_64x128", 66, 2)),   # the deploy tap
    (100352, 64, 64, ("short_k", "short_128x64", 132, 1)),
    (100352, 256, 64, ("long_k", "tile_256x64", 392, 1)),
    (25088, 512, 128, ("long_k", "tile_64x128", 392, 1)),
    (1568, 2048, 512, ("long_k", "tile_64x128", 25, 4)),
    (1000, 70, 200, ("short_k", "short_64x128", 16, 2)),
    (1, 3, 1, ("short_k", "short_128x64", 1, 1)),
    (5000, 32, 8, ("short_k", "short_128x64", 40, 1)),
    (300, 64, 132, ("short_k", "short_64x128", 5, 2)),
    (128, 16, 64, ("short_k", "short_128x64", 1, 1)),
    (3000, 96, 200, ("short_k", "short_64x128", 47, 2)),
    (3000, 512, 200, ("long_k", "tile_64x128", 47, 2)),
    (77, 513, 129, ("long_k", "tile_64x128", 2, 2)),
    (ms.SHORT_K_MAX, ms.SHORT_K_MAX + 1, 64, ("long_k", "tile_256x64", 1, 1)),
])
def test_matmul_stats_schedule(M, K, N, want):
    assert tuple(ms._schedule(M, K, N)) == want


@pytest.mark.parametrize("M,K,N", [(100352, 64, 256), (100352, 64, 64), (100352, 256, 64),
                                   (25088, 512, 128),
                                   (1568, 2048, 512), (1000, 70, 200), (1, 3, 1),
                                   (300, 64, 132), (77, 513, 129)])
def test_matmul_stats_partial_rows_cover_every_tile_once(M, K, N):
    """The partial rows the wrapper allocates, re-derived by handing every
    M-tile to its block as the kernel does (block p takes the M-tiles p,
    p + P, ... of its slab): every tile once, every block at least one, so
    one partial row a block along M; and the layout's shared memory fits."""
    sched = ms._schedule(M, K, N)
    _, bm, bn, _, _, resident = ms.LAYOUTS[sched.layout]
    m_tiles = -(-M // bm)
    owner = {}
    for p in range(sched.groups):
        for tile in range(p, m_tiles, sched.groups):
            assert tile not in owner
            owner[tile] = p
    assert sorted(owner) == list(range(m_tiles))
    assert set(owner.values()) == set(range(sched.groups))
    assert sched.n_slabs == -(-N // bn)
    assert resident == (sched.kind == "short_k")
    if not resident:
        assert sched.groups == m_tiles  # one tile a block
    else:
        assert sched.groups * sched.n_slabs <= ms.SMS
    assert ms.smem_bytes(sched.layout, K) <= ms.SMEM_MAX

