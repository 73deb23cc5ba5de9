"""The arithmetic of the port's tensor-core kernels, emulated in numpy on the
CPU (``mxnet_tpu_torch/csrc/tf32x3.cuh``), and the Python side of their
tilings.

3xTF32 splits each f32 operand into two TF32 halves (rounded as
``cvt.rna.tf32.f32`` rounds: 10 mantissa bits, to nearest, ties away from
zero) and sums three of the four products. Held here against float64 products at the contraction
lengths of the transformer's ffn1 (512) and ResNet-50's conv sites (576,
2304, 4608), with the operand scales ``chip_smoke.py`` uses, the error stays
within a tenth of the smoke's tolerances (``TOL["matmul_bias_act"]`` 1e-4
absolute, ``CONV_TOL["elementwise"]`` 1e-5 of the largest output), and one
TF32 product alone does not: that is why the kernels take three.
"""
import numpy as np
import pytest

from mxnet_tpu_torch.ops import conv_bn as cb
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.ops import matmul_bias_act as mba
from mxnet_tpu_torch.ops import matmul_stats as ms

MATMUL_TOL, CONV_TOL = 1e-4, 1e-5  # chip_smoke.py TOL["matmul_bias_act"], CONV_TOL
K_SITES = (512, 576, 2304, 4608)


def tf32(x):
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round half away from zero."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    """tf32x3.cuh's split: hi = tf32(x), lo = tf32(x − hi)."""
    hi = tf32(x)
    return hi, tf32(np.asarray(x, np.float32) - hi)


def dot3(a, b):
    """Σ_k a[i,k]·b[k,j] as 3xTF32 forms it: hi·hi + hi·lo + lo·hi, each
    product exact (float64 holds it), summed in float64."""
    (ah, al), (bh, bl) = split(a), split(b)
    f = np.float64
    return ah.astype(f) @ bh.astype(f) + ah.astype(f) @ bl.astype(f) + al.astype(f) @ bh.astype(f)


def dot1(a, b):
    """One TF32 product."""
    return tf32(a).astype(np.float64) @ tf32(b).astype(np.float64)


def matmul_operands(K, seed=0):
    """The smoke's ffn1 operands: a ~ N(0, 1), w ~ N(0, 1/K), as (M, K), (K, N)."""
    rs = np.random.RandomState(seed)
    a = rs.standard_normal((32, K)).astype(np.float32)
    w = (rs.standard_normal((K, 32)) / np.sqrt(K)).astype(np.float32)
    return a, w


def conv_operands(Kt, seed=0):
    """The smoke's conv operands as an implicit GEMM's: w He-scaled (N, K·taps),
    the prologue's output relu(x·scale + shift) (K·taps, positions)."""
    rs = np.random.RandomState(seed)
    w = (rs.standard_normal((32, Kt)) * np.sqrt(2.0 / Kt)).astype(np.float32)
    x = rs.standard_normal((Kt, 48)).astype(np.float32)
    scale = (0.5 + rs.rand(Kt, 1)).astype(np.float32)
    shift = (0.1 * rs.standard_normal((Kt, 1))).astype(np.float32)
    return w, np.maximum(x * scale + shift, np.float32(0))


def test_tf32_rounds_to_ten_mantissa_bits_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = np.array([1 + 2.0 ** -11, 1 + 2.0 ** -11 + 2.0 ** -20, 1 + 2.0 ** -12, -(1 + 2.0 ** -11),
                  3.0, 0.0], np.float32)
    np.testing.assert_array_equal(tf32(x), [one + ulp, one + ulp, one, -(one + ulp), 3.0, 0.0])
    assert (tf32(x).view(np.uint32) & 0x1FFF == 0).all()


def test_split_halves_sum_back_within_two_to_minus_22():
    x = np.random.RandomState(1).standard_normal(10000).astype(np.float32) * 100
    hi, lo = split(x)
    # x − hi is exact in f32, and lo keeps 11 of its significant bits
    assert (np.float32(x) - hi == (x.astype(np.float64) - hi)).all()
    err = np.abs(hi.astype(np.float64) + lo - x) / np.abs(x)
    assert err.max() <= 2.0 ** -22


@pytest.mark.parametrize("K", K_SITES)
def test_three_products_keep_the_matmul_tolerance(K):
    a, w = matmul_operands(K)
    exact = a.astype(np.float64) @ w.astype(np.float64)
    assert np.abs(dot3(a, w) - exact).max() <= MATMUL_TOL / 10


@pytest.mark.parametrize("K", K_SITES)
def test_three_products_keep_the_conv_tolerance(K):
    w, xn = conv_operands(K)
    exact = w.astype(np.float64) @ xn.astype(np.float64)
    err = np.abs(dot3(w, xn) - exact).max() / np.abs(exact).max()
    assert err <= CONV_TOL / 10


@pytest.mark.parametrize("K", K_SITES)
def test_one_tf32_product_misses_both_tolerances(K):
    """Why three: one pass keeps 11 significant bits of each operand."""
    a, w = matmul_operands(K)
    exact = a.astype(np.float64) @ w.astype(np.float64)
    assert np.abs(dot1(a, w) - exact).max() > MATMUL_TOL
    wc, xn = conv_operands(K)
    exact = wc.astype(np.float64) @ xn.astype(np.float64)
    assert np.abs(dot1(wc, xn) - exact).max() / np.abs(exact).max() > CONV_TOL


def _rz(v):
    """float64 -> float32, rounded toward zero (the tensor cores' adder)."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _mma_sums(a, b, chain):
    """Σ_k a·b through m16n8k8 steps of three TF32 products, each mma
    rounding its exact sum toward zero, chained through ``chain`` steps into
    one accumulator (None: all of K) that is then added to the sum rounding
    to nearest. tf32x3.cuh's mma3 chains one step."""
    (ah, al), (bh, bl) = split(a), split(b)
    f = np.float64
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    d = np.zeros_like(acc)
    steps = a.shape[1] // 8
    for i in range(steps):
        s = slice(8 * i, 8 * i + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            d = _rz(d.astype(f) + x[:, s].astype(f) @ y[s].astype(f))
        if chain is not None and ((i + 1) % chain == 0 or i + 1 == steps):
            acc, d = (acc.astype(f) + d).astype(np.float32), np.zeros_like(acc)
    return d if chain is None else acc


def test_a_fresh_accumulator_a_step_keeps_sums_of_squares_unbiased():
    """The card test's failing case at the first design (1x1, K = 1032, 32
    positions, no prologue): chained through 387 truncating adds, the
    outputs shrink toward zero and their sum of squares drifts by about
    1e-5 of itself (1.3e-5 on the card); chained through 4 steps it is
    smaller but still one-signed; a fresh accumulator a step, as the
    kernels take, is the least of the three."""
    rs = np.random.RandomState(3)
    K = 1032
    w = (rs.standard_normal((8, K)) / np.sqrt(K)).astype(np.float32)
    x = rs.standard_normal((K, 32)).astype(np.float32)
    exact = w.astype(np.float64) @ x.astype(np.float64)
    ssq = (exact ** 2).sum(axis=1)
    rel = {}
    for chain in (None, 4, 1):
        c = _mma_sums(w, x, chain).astype(np.float64)
        rel[chain] = np.abs((c ** 2).sum(axis=1) - ssq).max() / ssq.max()
    assert rel[None] > 4e-6 and rel[1] <= 1e-6 and rel[1] < rel[4] < rel[None]


# ----------------------------------------------- the tilings, as Python sees them
@pytest.mark.parametrize("M,N,K,want", [
    (8, 2048, 512, "small_m"),       # decode ffn1
    (1024, 2048, 512, "tiles"),      # prefill ffn1
    (2048, 2048, 512, "tiles"),      # training ffn1
    (5, 70, 33, "small_m"), (130, 3, 65, "small_m"), (77, 130, 200, "small_m"),
    (32, 2048, 512, "small_m"), (33, 2048, 512, "small_m"),  # past one 32-row group
    (mba.SMALL_M_MAX, 2048, 512, "small_m"),  # the crossover
    (mba.SMALL_M_MAX + 1, 2048, 512, "tiles"),
    (8, 2048, 4096, "tiles"),        # 8 rows of A would not fit in a block's 64 KiB
    (64, 2048, 520, "tiles"),        # 32 rows would not
    (2048, 2048, 100, "tiles"),
])
def test_schedule(M, N, K, want):
    assert mba._schedule(M, N, K) == want


def _tiles_restated(B, Ho, Wo, taps):
    """The forward's position tiles, by walking every output position: 1x1
    tiles hold 128 consecutive positions of the flattened (b, oy, ox) axis,
    3x3 tiles an 8 x 8 pixel square of one image."""
    tiles = set()
    for b in range(B):
        for oy in range(Ho):
            for ox in range(Wo):
                if taps == 1:
                    tiles.add(((b * Ho + oy) * Wo + ox) // 128)
                else:
                    tiles.add((b, oy // 8, ox // 8))
    return len(tiles)


# ResNet-50's fused sites by stage at 224: 1x1 stride 1 at 56, 28, 14, 7;
# the 1x1 stride-2 shortcuts into 28, 14, 7; the 3x3 at 56, 28, 14, 7
@pytest.mark.parametrize("B", [1, 2, 32])
@pytest.mark.parametrize("H,stride,taps", [(56, 1, 1), (28, 1, 1), (14, 1, 1), (7, 1, 1),
                                           (56, 2, 1), (28, 2, 1), (14, 2, 1),
                                           (56, 1, 9), (28, 1, 9), (14, 1, 9), (7, 1, 9)])
def test_forward_partial_rows_follow_the_tiling(B, H, stride, taps):
    Ho, Wo = cb.strided_dims(H, H, (stride, stride)) if taps == 1 else (H, H)
    assert cb._fwd_parts(B, Ho, Wo, taps) == _tiles_restated(B, Ho, Wo, taps)


# ResNet-50's fused sites at 224 as (H, stride, taps, K, N): the input grid,
# the kernel, input and output channels (the 3x3 stride-2 convs run unfused)
RESNET_FUSED_SITES = [
    (56, 1, 1, 64, 64), (56, 1, 9, 64, 64), (56, 1, 1, 64, 256), (56, 1, 1, 256, 64),
    (56, 1, 1, 256, 128), (28, 1, 1, 128, 512), (56, 2, 1, 256, 512), (28, 1, 1, 512, 128),
    (28, 1, 9, 128, 128), (28, 1, 1, 512, 256), (14, 1, 1, 256, 1024), (28, 2, 1, 512, 1024),
    (14, 1, 1, 1024, 256), (14, 1, 9, 256, 256), (14, 1, 1, 1024, 512), (7, 1, 1, 512, 2048),
    (14, 2, 1, 1024, 2048), (7, 1, 1, 2048, 512), (7, 1, 9, 512, 512)]


def _out_grid(H, stride, taps):
    return cb.strided_dims(H, H, (stride, stride)) if taps == 1 else (H, H)


def test_backward_partial_rows_keep_their_own_tiling():
    """The dgrad runs the forward's main loop and tiling, so its dscale and
    dshift partial rows are the forward's position tiles, restated by
    walking every position, at every fused site of ResNet-50 at batch 1, 2
    and 32: at stage 4's 7 x 7 a 1x1 tile packs 2.6 images."""
    for B in (1, 2, 32):
        for H, stride, taps, _, _ in RESNET_FUSED_SITES:
            Ho, Wo = _out_grid(H, stride, taps)
            assert cb._fwd_parts(B, Ho, Wo, taps) == _tiles_restated(B, Ho, Wo, taps)
    assert cb._fwd_parts(32, 7, 7, 1) == 13


def _wgrad_stages_restated(B, Ho, Wo, taps):
    """The wgrad's stage of each output position, by walking them all: 32
    consecutive positions of the flattened (b, oy, ox) axis (1x1), a pixel
    tile of one image 8 wide and 8 high, or 7 high where that fills the
    grid's height and 8 does not (3x3), numbered in the kernel's order."""
    b, oy, ox = np.meshgrid(np.arange(B), np.arange(Ho), np.arange(Wo), indexing="ij")
    if taps == 1:
        return ((b * Ho + oy) * Wo + ox).ravel() // 32
    th = 7 if Ho % 8 and Ho % 7 == 0 else 8
    tiles_x = -(-Wo // 8)
    return ((b * -(-Ho // th) + oy // th) * tiles_x + ox // 8).ravel()


@pytest.mark.parametrize("B", [1, 2, 32])
@pytest.mark.parametrize("H,stride,taps,K,N", RESNET_FUSED_SITES)
def test_wgrad_splits_cover_the_reduction_in_one_wave(B, H, stride, taps, K, N):
    """Each wgrad block takes the stages [z·per, (z + 1)·per) of its split
    (per = ceil(stages / splits)): every stage of the restated tiling falls
    in exactly one split, a split takes at least WGRAD_MIN_STAGES stages
    where there are that many, and the blocks fit one wave of the card."""
    Ho, Wo = _out_grid(H, stride, taps)
    stage = _wgrad_stages_restated(B, Ho, Wo, taps)
    stages = int(stage.max()) + 1
    assert stages == cb._wgrad_stages(B, Ho, Wo, taps) == len(np.unique(stage))
    splits = cb._wgrad_splits(B, K, N, Ho, Wo, taps)
    per = -(-stages // splits)
    owner = stage // per
    assert owner.max() < splits and len(np.unique(owner)) == -(-stages // per)
    assert per >= min(cb.WGRAD_MIN_STAGES, stages)
    tn, tk = cb.WGRAD_TILE[taps]
    blocks = -(-N // tn) * -(-K // tk) * splits
    assert splits == 1 or blocks <= cb.SMS * cb.WGRAD_BLOCKS_PER_SM[taps]


def _split_sums(a, b, splits, stage, chain=False):
    """dw = a·b over P positions as the wgrad kernel forms it. The P-long
    contraction is cut into stages of ``stage`` positions, and those into
    ``splits`` ranges of ceil(stages / splits), one a block. Within a range
    each 8-deep step's three TF32 products go into a fresh truncating
    accumulator that is added to the range's sum rounding to nearest (mma3);
    with ``chain``, into one truncating accumulator for the whole range.
    The ranges' partial sums are then added in sum_rows's fixed order
    (conv_bn.cuh): lane l of L adds rows l, l + L, ..., then the L lanes in
    order."""
    (ah, al), (bh, bl) = split(a), split(b)
    f, M, N = np.float64, a.shape[0], b.shape[1]
    steps = a.shape[1] // 8
    per = -(-(a.shape[1] // stage) // splits) * stage // 8  # steps a range
    prods = []
    for x, y in ((al, bh), (ah, bl), (ah, bh)):
        p = np.zeros((splits * per, M, N))
        p[:steps] = x.astype(f).reshape(M, steps, 8).transpose(1, 0, 2) @ \
            y.astype(f).reshape(steps, 8, N)
        prods.append(p.reshape(splits, per, M, N))  # zero steps past the end add nothing
    acc = np.zeros((splits, M, N), np.float32)
    if chain:
        for i in range(per):
            for p in prods:
                acc = _rz(acc.astype(f) + p[:, i])
    else:
        d = np.zeros(prods[0].shape, np.float32)
        for p in prods:
            d = _rz(d.astype(f) + p)
        for i in range(per):
            acc = acc + d[:, i]  # float32: rounded to nearest
    L = 16 if splits >= 64 else (4 if splits >= 8 else 1)
    out = np.zeros((M, N), np.float32)
    for lane in range(L):
        s = np.zeros((M, N), np.float32)
        for r in range(lane, splits, L):
            s = s + acc[r]
        out = out + s
    return out


def wgrad_operands(P, ds, seed=0):
    """The wgrad's operands over P positions for 8 output and 8 input
    channels: dce = dc + ds + 2·c·dq as the smoke draws them (dc, c ~ N(0,
    1), dq ~ 1e-3·N(0, 1)) and xn = relu(x·scale + shift), as (8, P) and
    (P, 8)."""
    rs = np.random.RandomState(seed)
    dc, c, x = (rs.standard_normal((8, P)).astype(np.float32) for _ in range(3))
    dq = (1e-3 * rs.standard_normal((8, 1))).astype(np.float32)
    dce = (dc + np.float32(ds)) + (np.float32(2) * c) * dq
    scale = (0.5 + rs.rand(8, 1)).astype(np.float32)
    shift = (0.1 * rs.standard_normal((8, 1))).astype(np.float32)
    return dce, np.ascontiguousarray(np.maximum(x * scale + shift, np.float32(0)).T)


# the longest wgrad sums of ResNet-50 at batch 32, stage 1's 100 352
# positions: the 3x3 (8 x 8 pixel stages) and the 1x1 64 -> 256 (32-position
# stages), as (taps, K, N, stage)
@pytest.mark.parametrize("taps,K,N,stage", [(9, 64, 64, 64), (1, 64, 256, 32)])
def test_wgrad_long_sums_keep_the_conv_tolerance(taps, K, N, stage):
    P = 32 * 56 * 56
    splits = cb._wgrad_splits(32, K, N, 56, 56, taps)
    dce, xn = wgrad_operands(P, ds=0.01)
    exact = dce.astype(np.float64) @ xn.astype(np.float64)
    err = np.abs(_split_sums(dce, xn, splits, stage) - exact).max() / np.abs(exact).max()
    assert err <= CONV_TOL / 10


def test_one_accumulator_chained_over_a_split_misses_the_conv_tolerance():
    """Stage 1's 3x3 at batch 32 with a statistics cotangent that moves every
    position of a channel alike (ds = 1, as a BatchNorm's dshift does): the
    split's sums grow steadily, and one accumulator chained through a
    split's 192 steps truncates them past CONV_TOL, where a fresh
    accumulator a step stays within a tenth of it."""
    P = 32 * 56 * 56
    splits = cb._wgrad_splits(32, 64, 64, 56, 56, 9)
    dce, xn = wgrad_operands(P, ds=1.0, seed=5)
    exact = dce.astype(np.float64) @ xn.astype(np.float64)
    rel = {chain: np.abs(_split_sums(dce, xn, splits, 64, chain) - exact).max()
           / np.abs(exact).max() for chain in (False, True)}
    assert rel[False] <= CONV_TOL / 10 < CONV_TOL < rel[True]


# ------------------------------------------ the flash backward (flash_attention_bwd.cu)
FLASH_TOL = 1e-4  # chip_smoke.py TOL["flash_attention_dq"], TOL["flash_attention_dkv"]


def _mma_steps(a, b, passes=3, acc=None):
    """Σ_k a[i,k]·b[k,j] as the flash kernels form it: each 8-deep step's
    TF32 products (3xTF32's three, the small ones first, or one) go into a
    fresh accumulator that rounds toward zero, which is added to the f32
    running sum ``acc`` (zero by default) rounding to nearest (tf32x3.cuh
    mma3)."""
    f = np.float64
    if passes == 3:
        (ah, al), (bh, bl) = split(a), split(b)
        pairs = ((al, bh), (ah, bl), (ah, bh))
    else:
        pairs = ((tf32(a), tf32(b)),)
    M, K = a.shape
    steps = K // 8
    d = np.zeros((steps, M, b.shape[1]), np.float32)
    for x, y in pairs:
        p = x.astype(f).reshape(M, steps, 8).transpose(1, 0, 2) @ y.astype(f).reshape(steps, 8, -1)
        d = _rz(d.astype(f) + p)
    acc = np.zeros((M, b.shape[1]), np.float32) if acc is None else acc
    for i in range(steps):
        acc = acc + d[i]
    return acc


def flash_operands(heads=3, T=256, D=64, seed=0):
    """The smoke's training-shape draws (standard-normal q, k, v, dO) and the
    forward's O and lse in f32, as the backward kernels receive them."""
    rs = np.random.RandomState(seed)
    q, k, v, do = (rs.standard_normal((heads, T, D)).astype(np.float32) for _ in range(4))
    scale = 1.0 / np.sqrt(D)
    mask = np.tril(np.ones((T, T), bool))
    s = np.where(mask, q.astype(np.float64) @ k.astype(np.float64).transpose(0, 2, 1) * scale,
                 -np.inf)
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m)
    l = p.sum(-1, keepdims=True)
    o = ((p / l) @ v.astype(np.float64)).astype(np.float32)
    lse = (m + np.log(l))[..., 0].astype(np.float32)
    return q, k, v, do, o, lse, mask, scale


def flash_bwd_f64(q, k, v, do, o, lse, mask, scale):
    """dQ, dK, dV in float64 from the same f32 inputs."""
    q, k, v, do, o, lse = (x.astype(np.float64) for x in (q, k, v, do, o, lse))
    p = np.where(mask, np.exp(q @ k.transpose(0, 2, 1) * scale - lse[..., None]), 0.0)
    ds = p * (do @ v.transpose(0, 2, 1) - (do * o).sum(-1, keepdims=True))
    return ds @ k * scale, ds.transpose(0, 2, 1) @ q * scale, p.transpose(0, 2, 1) @ do


def flash_bwd_emulated(q, k, v, do, o, lse, mask, scale, passes=3):
    """The kernels' arithmetic, head by head: S = Q·Kᵀ and dP = dO·Vᵀ, P =
    2^(S·scale_log2 − lse_log2) where visible (flash_tc.cuh masked_exp: the
    two factors rounded to f32, the argument one FMA), dS = P∘(dP − δ) in
    f32, then dQ = scale·dS·K, dK = scale·dSᵀ·Q and dV = Pᵀ·dO, with P and dS
    split like any other operand; δ = rowsum(dO∘O) in f32."""
    f32 = np.float32
    log2e = f32(1.4426950408889634)
    out = [np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)]
    for h in range(q.shape[0]):
        delta = (do[h].astype(np.float64) * o[h]).sum(-1).astype(f32)
        s = _mma_steps(q[h], np.ascontiguousarray(k[h].T), passes)
        lse_log2 = lse[h] * log2e
        arg = (s.astype(np.float64) * (f32(scale) * log2e) - lse_log2[:, None]).astype(f32)
        p = np.where(mask, np.exp2(arg), f32(0))
        dp = _mma_steps(do[h], np.ascontiguousarray(v[h].T), passes)
        ds = p * (dp - delta[:, None])
        out[0][h] = _mma_steps(ds, k[h], passes) * f32(scale)
        out[1][h] = _mma_steps(np.ascontiguousarray(ds.T), q[h], passes) * f32(scale)
        out[2][h] = _mma_steps(np.ascontiguousarray(p.T), do[h], passes)
    return out


def test_flash_backward_keeps_a_tenth_of_the_tolerance_on_three_products():
    """At the training shape (T = S = 256, D = 64, causal) the emulated
    kernels' dQ, dK and dV lie within a tenth of the smoke's 1e-4 of
    float64; one TF32 pass for every product misses 1e-4."""
    ops = flash_operands()
    want = flash_bwd_f64(*ops)
    err3 = [np.abs(g - w).max() for g, w in zip(flash_bwd_emulated(*ops), want)]
    err1 = [np.abs(g - w).max() for g, w in zip(flash_bwd_emulated(*ops, passes=1), want)]
    assert max(err3) <= FLASH_TOL / 10
    assert min(err1) > FLASH_TOL


# ------------------------------------------------ the flash forward (flash_attention.cu)
FLASH_FWD_TOL = 1e-5  # chip_smoke.py TOL["flash_attention"]
FWD_COLS, FWD_GROUPS = 32, 2  # the kernel's key tile and groups of warps at D <= 64


def flash_fwd_f64(q, k, v, mask, scale):
    """O and the row logsumexp in float64 from the same f32 inputs."""
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    s = np.where(mask, q @ k.transpose(0, 2, 1) * scale, -np.inf)
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m)
    l = p.sum(-1, keepdims=True)
    return (p / l) @ v, (m + np.log(l))[..., 0]


def flash_fwd_emulated(q, k, v, mask, scale, passes=3):
    """The forward kernel's arithmetic, head by head. Key tiles of 32 taken
    in turn by two groups (tile kt by group kt % 2), each group with its own
    f32 state for every row: the max m of the raw scores S = Q·Kᵀ (3xTF32,
    or one TF32 pass), ml = m·scale_log2 rounded to f32, the row sum l and
    the O accumulator. Per tile: the new max over the visible scores, α =
    2^(ml_old − ml_new), P = 2^(S·scale_log2 − ml) where visible (one FMA and
    one exp2, flash_tc.cuh masked_exp), else exactly 0; l = l·α + ΣP; O =
    O·α, then P·V added step by step, P split like any other operand and
    each 8-deep step a fresh accumulator. At the end group 1's state is
    rescaled onto group 0's common max and added, then O / max(l, 1e-30)
    and lse = m·scale + log(l)."""
    f32, f = np.float32, np.float64
    sl2 = f32(scale) * f32(1.4426950408889634)
    T, S = mask.shape
    o = np.zeros(q.shape, f32)
    lse = np.zeros(q.shape[:2], f32)
    for h in range(q.shape[0]):
        m = np.full((FWD_GROUPS, T), -1e30, f32)
        ml = m * sl2
        l = np.zeros((FWD_GROUPS, T), f32)
        acc = np.zeros((FWD_GROUPS, T, q.shape[2]), f32)
        for kt in range(-(-S // FWD_COLS)):
            gr, cols = kt % FWD_GROUPS, slice(kt * FWD_COLS, (kt + 1) * FWD_COLS)
            s = _mma_steps(q[h], np.ascontiguousarray(k[h, cols].T), passes)
            vis = mask[:, cols]
            mn = np.maximum(m[gr], np.where(vis, s, f32(-1e30)).max(-1))
            mnl = mn * sl2
            alpha = np.exp2(ml[gr] - mnl)
            m[gr], ml[gr] = mn, mnl
            arg = np.where(vis, s.astype(f) * sl2 - mnl[:, None], 0).astype(f32)
            p = np.where(vis, np.exp2(arg), f32(0))
            l[gr] = l[gr] * alpha + p.sum(-1, dtype=f32)
            acc[gr] = _mma_steps(p, v[h, cols], passes, acc[gr] * alpha[:, None])
        mn = np.maximum(m[0], m[1])
        mnl = mn * sl2
        a0, a1 = np.exp2(ml[0] - mnl), np.exp2(m[1] * sl2 - mnl)
        ls = np.maximum(l[0] * a0 + l[1] * a1, f32(1e-30))
        o[h] = (acc[0] * a0[:, None] + acc[1] * a1[:, None]) / ls[:, None]
        lse[h] = (mn.astype(f) * f32(scale) + np.log(ls)).astype(f32)
    return o, lse


def test_flash_forward_keeps_a_tenth_of_the_tolerance_on_three_products():
    """At the training shape (T = S = 256, D = 64, causal) the emulated
    forward kernel's O and lse lie within a tenth of the smoke's 1e-5 of
    float64; one TF32 pass for both products misses 1e-5."""
    q, k, v, _, _, _, mask, scale = flash_operands()
    want = flash_fwd_f64(q, k, v, mask, scale)
    err3 = [np.abs(g - w).max() for g, w in zip(flash_fwd_emulated(q, k, v, mask, scale), want)]
    err1 = [np.abs(g - w).max()
            for g, w in zip(flash_fwd_emulated(q, k, v, mask, scale, passes=1), want)]
    assert max(err3) <= FLASH_FWD_TOL / 10
    assert min(err1) > FLASH_FWD_TOL


# (T, S, causal): the card tests' and the smoke's flash shapes
FLASH_SHAPES = [(1, 1, True), (33, 33, True), (17, 95, True), (40, 9, False), (64, 64, True),
                (256, 256, True), (70, 70, True), (45, 77, True), (29, 50, False),
                (75, 75, True), (75, 41, False), (77, 77, True), (50, 131, True),
                (33, 70, False), (128, 128, True)]


@pytest.mark.parametrize("T,S,causal", FLASH_SHAPES)
def test_bwd_tiles_cover_every_visible_pair_once_and_no_masked_tile(T, S, causal):
    """Each block's rows as ``_tiles`` lists them, the table the kernels
    read: the forward and the backward's dq read its query-owning blocks
    (``q``), dk/dv its key-owning ones (``kv``). In each every visible
    (query, key) pair (bottom-right causal mask) is visited exactly once,
    every streamed row is seen by one of the block's own rows (so no tile of
    any height is wholly masked), and the blocks with the most rows to
    stream launch first. The head width does not enter the table: every
    kernel owns ``TILE_ROWS`` rows a block at both widths."""
    visible = np.tril(np.ones((T, S), bool), S - T) if causal else np.ones((T, S), bool)
    tiles = fa._tiles(T, S, causal)
    R = fa.TILE_ROWS
    for blocks, vis in ((tiles.q, visible), (tiles.kv, visible.T)):
        own, other = vis.shape
        assert len(blocks) == -(-own // R)
        n = np.zeros((own, other), np.int64)
        for r0, lo, hi in blocks:
            assert 0 <= r0 < own and r0 % R == 0 and 0 <= lo < hi <= other
            n[r0:r0 + R, lo:hi] += 1
            assert vis[r0:r0 + R, lo:hi].any(axis=0).all()
        assert (n[vis] == 1).all() and n.max() <= 1
        work = [hi - lo for _, lo, hi in blocks]
        assert work == sorted(work, reverse=True)


# ------------------------------------------------------------ matmul_stats
STATS_TOL = {"c": 1e-5, "sums": 1e-4}  # chip_smoke.py CONV_TOL, as matmul_stats is held


def _f32_add(x, y):
    return (np.asarray(x, np.float32).astype(np.float64) + y).astype(np.float32)


def _matmul_stats_sums(c, layout, groups):
    """Σc and Σc² over the rows of the f32 C (M, N) in csrc/matmul_stats.cu's
    order: each thread adds its rows g and g + 8 of each m16 tile, tile by
    tile along its block's M-tiles p, p + P, ... (c² by an FMA); the 8
    values of g by shuffles over lane offsets 4, 8, 16; the warps along M in
    order (one partial row a block); then common.cuh's sum_rows over the P
    partial rows (lane l adds rows l, l + L, ..., lane 0 the L lane sums)."""
    _, bm, _, _, wm_n, _ = ms.LAYOUTS[layout]
    M, N = c.shape
    mt = bm // wm_n // 16
    m_tiles = -(-M // bm)
    rows = np.zeros((groups, 2, N), np.float32)
    for p in range(groups):
        warp_rows = np.zeros((wm_n, 2, N), np.float32)
        for wm in range(wm_n):
            lanes = np.zeros((8, 2, N), np.float32)  # g = 0..7
            for g in range(8):
                s, q = np.zeros(N, np.float32), np.zeros(N, np.float32)
                for tile in range(p, m_tiles, groups):
                    for mi in range(mt):
                        for h in range(2):
                            r = tile * bm + wm * mt * 16 + mi * 16 + g + 8 * h
                            v = c[r] if r < M else np.zeros(N, np.float32)
                            s = _f32_add(s, v)
                            q = _f32_add(q, v.astype(np.float64) ** 2)  # fmaf: one rounding
                lanes[g] = s, q
            for o in (1, 2, 4):  # lane offsets 4, 8, 16 flip bits 0, 1, 2 of g
                lanes = np.stack([_f32_add(lanes[g], lanes[g ^ o]) for g in range(8)])
            warp_rows[wm] = lanes[0]
        acc = np.zeros((2, N), np.float32)
        for wm in range(wm_n):
            acc = _f32_add(acc, warp_rows[wm])
        rows[p] = acc
    L = 16 if groups >= 64 else (4 if groups >= 8 else 1)
    lane_sums = np.zeros((L, 2, N), np.float32)
    for lane in range(L):
        for p in range(lane, groups, L):
            lane_sums[lane] = _f32_add(lane_sums[lane], rows[p])
    out = np.zeros((2, N), np.float32)
    for lane in range(L):
        out = _f32_add(out, lane_sums[lane])
    return out[0], out[1]


def _matmul_stats_errors(c, exact, layout, groups):
    s, q = _matmul_stats_sums(c, layout, groups)
    c64 = c.astype(np.float64)
    return (np.abs(c64 - exact).max() / np.abs(exact).max(),
            np.abs(s - exact.sum(0)).max() / np.abs(exact.sum(0)).max(),
            np.abs(q - (exact ** 2).sum(0)).max() / ((exact ** 2).sum(0)).max())


# small versions of the short-K deploy tap (100352, 64, 256) and of a long-K
# 1x1 convolution (25088, 512, 128), at the smoke's operand scales
@pytest.mark.parametrize("M,K,N", [(2048, 64, 64), (512, 512, 128)], ids=["short_k", "long_k"])
def test_matmul_stats_keeps_a_tenth_of_its_tolerances_on_three_products(M, K, N):
    rs = np.random.RandomState(7)
    a = rs.standard_normal((M, K)).astype(np.float32)
    b = (rs.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    sched = ms._schedule(M, K, N)
    assert sched.kind == ("short_k" if K <= ms.SHORT_K_MAX else "long_k") and sched.n_slabs == 1
    # tf32x3.cuh's step: a fresh accumulator every 8-deep step
    c3 = _mma_sums(a, b, chain=1)
    err_c, err_s, err_q = _matmul_stats_errors(c3, exact, sched.layout, sched.groups)
    assert err_c <= STATS_TOL["c"] / 10
    assert max(err_s, err_q) <= STATS_TOL["sums"] / 10
    # one TF32 pass misses C's tolerance 30-fold; the sums average its
    # rounding over M rows, and miss theirs by less (Σc here, Σc² at times)
    c1 = dot1(a, b).astype(np.float32)
    err_c, err_s, err_q = _matmul_stats_errors(c1, exact, sched.layout, sched.groups)
    assert err_c > 10 * STATS_TOL["c"] and max(err_s, err_q) > STATS_TOL["sums"]

