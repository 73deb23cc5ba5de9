"""The arithmetic of the bf16 conv+BN kernels on Hopper
(``mxnet_tpu_torch/csrc/conv_bn_bf16.cuh``, ``conv_bn_bf16.cu``,
``conv_bn_bf16_bwd.cu``), emulated in numpy on the CPU, and the Python side
of their tilings.

The kernels multiply bf16 operands on ``wgmma``: each k16 step's sixteen
products are exact, and the tensor cores add them into an f32 accumulator,
truncating. Every stage's products go into a fresh accumulator (scale-d = 0
on its first step) that is added to the running sum with one rounding to
nearest: 4 steps a stage for the 1x1 forward and dgrad (64 channels), 9 for
the 3x3 (16 channels x 9 taps), 4 or 7 for the wgrad (a stage of 64
positions, or one 8 x 8 or 14 x 8 pixel tile). Held against float64 sums at
the longest contractions on ResNet-50's path at batch 32, with the operand
scales ``chip_smoke.py`` draws, the error stays within a tenth of what phase
2's bf16 gates allow (``BF16_TRAIN_ULPS`` = 1 ulp of the bf16 result, or
``CONV_TOL`` of the largest where a sum cancels); one truncating
accumulator chained through a whole split errs more and always toward zero.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.ops import conv_bn as cb

# chip_smoke.py CONV_TOL["elementwise"] (c, dx) and CONV_TOL["sums"] (dw)
CONV_TOL = {"elementwise": 1e-5, "sums": 1e-4}
BF16 = torch.bfloat16


def bf16(x):
    """float32 rounded to the nearest bf16 (ties to even), as float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _rz(v):
    """float64 -> float32, rounded toward zero (the tensor cores' adder)."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def wgmma_sums(a, b, chunk, chain=False):
    """Σ_k a[:, k]·b[k, :] of bf16 values as the kernels form it: k16 steps,
    each step's exact sum added into a truncating f32 accumulator, a fresh
    accumulator every ``chunk`` steps added to the running sum rounding to
    nearest (``chain``: one accumulator through all the steps). a (M, K), b
    (K, N), K a multiple of 16."""
    f = np.float64
    steps = a.shape[1] // 16
    prods = a.astype(f).reshape(a.shape[0], steps, 16).transpose(1, 0, 2) @ \
        b.astype(f).reshape(steps, 16, b.shape[1])
    acc = np.zeros(prods.shape[1:], np.float32)
    d = np.zeros_like(acc)
    for i in range(steps):
        d = _rz(d.astype(f) + prods[i])
        if not chain and ((i + 1) % chunk == 0 or i + 1 == steps):
            acc, d = acc + d, np.zeros_like(acc)  # float32: rounded to nearest
    return d if chain else acc


def gate_room(got, exact, tol):
    """The largest error of ``got`` as a share of what a phase 2 gate lets
    the f32 sum err by and still round to within one bf16 ulp of the plain
    version's rounding of its own f32 sum: a quarter of an ulp at the bottom
    of the element's binade (2^-9·|exact|; two such sums round at most one
    ulp apart), or, where the sum cancels, half of ``tol`` of the largest
    |exact|."""
    err = np.abs(got.astype(np.float64) - exact)
    room = np.maximum(np.abs(exact) * 2.0 ** -9, 0.5 * tol * np.abs(exact).max())
    return float((err / room).max())


def conv_operands(Kt, P=48, seed=0):
    """The smoke's forward operands as an implicit GEMM's, in bf16: w He-scaled
    (16, K·taps) and the prologue's output relu(x·scale + shift) (K·taps, P)."""
    rs = np.random.RandomState(seed)
    w = bf16(rs.standard_normal((16, Kt)) * np.sqrt(2.0 / Kt))
    x = bf16(rs.standard_normal((Kt, P)))
    scale = bf16(0.5 + rs.rand(Kt, 1))
    shift = bf16(0.1 * rs.standard_normal((Kt, 1)))
    return w, np.maximum(bf16(bf16(x * scale) + shift), np.float32(0))


def dgrad_operands(Nt, P=48, seed=0):
    """The dgrad's operands: the flipped weight (16, N·taps) and the folded
    cotangent dce = dc + ds + 2·c·dq in bf16 (N·taps, P), dc, c ~ N(0, 1),
    ds ~ 0.01·N(0, 1), dq ~ 1e-3·N(0, 1) as the smoke draws them."""
    rs = np.random.RandomState(seed)
    wt = bf16(rs.standard_normal((16, Nt)) * np.sqrt(2.0 / Nt))
    dc, c = rs.standard_normal((Nt, P)), rs.standard_normal((Nt, P))
    ds, dq = 0.01 * rs.standard_normal((Nt, 1)), 1e-3 * rs.standard_normal((Nt, 1))
    return wt, bf16(dc + ds + 2 * c * dq)


# the longest contractions of the forward and the dgrad on ResNet-50's path:
# stage 3's and stage 4's 3x3 (256 and 512 channels x 9 taps, 9 steps a
# stage) and stage 4's 1x1 2048 -> 512 and its dgrad over 2048 (4 steps)
@pytest.mark.parametrize("Kt,chunk", [(256 * 9, 9), (512 * 9, 9), (2048, 4)])
def test_forward_sums_keep_a_tenth_of_the_bf16_gate(Kt, chunk):
    w, xn = conv_operands(Kt)
    exact = w.astype(np.float64) @ xn.astype(np.float64)
    assert gate_room(wgmma_sums(w, xn, chunk), exact, CONV_TOL["elementwise"]) <= 0.1


@pytest.mark.parametrize("Nt,chunk", [(256 * 9, 9), (512 * 9, 9), (2048, 4)])
def test_dgrad_sums_keep_a_tenth_of_the_bf16_gate(Nt, chunk):
    wt, dce = dgrad_operands(Nt)
    exact = wt.astype(np.float64) @ dce.astype(np.float64)
    assert gate_room(wgmma_sums(wt, dce, chunk), exact, CONV_TOL["elementwise"]) <= 0.1


def _split_sums(a, b, splits, stage, chain=False):
    """dw = a·b over P positions as the bf16 wgrad forms it: the P-long
    contraction cut into stages of ``stage`` positions, those into ``splits``
    ranges of ceil(stages / splits), one a block; within a range a fresh
    truncating accumulator a stage added to the range's sum rounding to
    nearest (``chain``: one accumulator through the range). The ranges'
    partial sums are then added in sum_rows's fixed order (common.cuh): lane
    l of L adds rows l, l + L, ..., then the L lanes in order."""
    M, N = a.shape[0], b.shape[1]
    stages = -(-a.shape[1] // stage)
    per = -(-stages // splits)
    pad = splits * per * stage - a.shape[1]
    a = np.concatenate([a, np.zeros((M, pad), a.dtype)], axis=1)
    b = np.concatenate([b, np.zeros((pad, N), b.dtype)], axis=0)
    part = np.stack([wgmma_sums(a[:, z * per * stage:(z + 1) * per * stage],
                                b[z * per * stage:(z + 1) * per * stage], stage // 16, chain)
                     for z in range(splits)])
    L = 16 if splits >= 64 else (4 if splits >= 8 else 1)
    out = np.zeros((M, N), np.float32)
    for lane in range(L):
        s = np.zeros((M, N), np.float32)
        for r in range(lane, splits, L):
            s = s + part[r]
        out = out + s
    return out


def wgrad_operands(P, ds, seed=0):
    """The wgrad's operands over P positions for 8 output and 8 input
    channels in bf16: dce = dc + ds + 2·c·dq (dc, c ~ N(0, 1), dq ~ 1e-3·N(0,
    1)) and xn = relu(x·scale + shift), as (8, P) and (P, 8)."""
    rs = np.random.RandomState(seed)
    dc, c, x = (rs.standard_normal((8, P)) for _ in range(3))
    dq = 1e-3 * rs.standard_normal((8, 1))
    dce = bf16(dc + ds + 2 * c * dq)
    scale = bf16(0.5 + rs.rand(8, 1))
    shift = bf16(0.1 * rs.standard_normal((8, 1)))
    xn = np.maximum(bf16(bf16(bf16(x) * scale) + shift), np.float32(0))
    return dce, np.ascontiguousarray(xn.T)


def _wgrad_stage(H, taps):
    """Positions a stage of the bf16 wgrad: 64 (1x1), one tile (3x3)."""
    return cb.WGRAD_STEP_P_BF16 if taps == 1 else cb._wgrad_tile_h(H, BF16) * 8


# the longest wgrad sums of ResNet-50 at batch 32, stage 1's 100 352
# positions: the 3x3 64 -> 64 and the 1x1 64 -> 256, as (taps, K, N)
@pytest.mark.parametrize("taps,K,N", [(9, 64, 64), (1, 64, 256)])
def test_wgrad_long_sums_keep_a_tenth_of_the_bf16_gate(taps, K, N):
    P = 32 * 56 * 56
    splits = cb._wgrad_splits(32, K, N, 56, 56, taps, BF16)
    dce, xn = wgrad_operands(P, ds=0.01)
    exact = dce.astype(np.float64) @ xn.astype(np.float64)
    got = _split_sums(dce, xn, splits, _wgrad_stage(56, taps))
    assert gate_room(got, exact, CONV_TOL["sums"]) <= 0.1


def test_one_accumulator_chained_over_a_split_errs_more_and_toward_zero():
    """Stage 1's 3x3 at batch 32 with a statistics cotangent that moves every
    position of a channel alike (ds = 1, as a BatchNorm's dshift does): the
    split's sums grow steadily. One accumulator chained through a split
    truncates every step toward zero, so all of dw shrinks and its error is
    several times the fresh accumulator's, whose roundings to nearest
    cancel."""
    P = 32 * 56 * 56
    splits = cb._wgrad_splits(32, 64, 64, 56, 56, 9, BF16)
    dce, xn = wgrad_operands(P, ds=1.0, seed=5)
    exact = dce.astype(np.float64) @ xn.astype(np.float64)
    err = {chain: _split_sums(dce, xn, splits, _wgrad_stage(56, 9), chain).astype(np.float64)
           - exact for chain in (False, True)}
    assert (np.sign(err[True]) == -np.sign(exact)).all()
    assert np.abs(err[True]).max() > 3 * np.abs(err[False]).max()


# ----------------------------------------------- the tilings, as Python sees them
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


def _fwd_tiles_restated(B, Ho, Wo, taps):
    """The bf16 forward's (and dgrad's) position tile of each output
    position, by walking them all: 64 consecutive positions of the flattened
    (b, oy, ox) axis (1x1), or a pixel tile of one image 8 wide and 14 high
    where 14 divides the grid's height, else 7 where 7 does, else 8 (3x3)."""
    b, oy, ox = np.meshgrid(np.arange(B), np.arange(Ho), np.arange(Wo), indexing="ij")
    if taps == 1:
        return ((b * Ho + oy) * Wo + ox).ravel() // 64
    th = 14 if Ho % 14 == 0 else (7 if Ho % 7 == 0 else 8)
    return ((b * -(-Ho // th) + oy // th) * -(-Wo // 8) + ox // 8).ravel()


def _wgrad_stages_restated(B, Ho, Wo, taps):
    """The bf16 wgrad's stage of each output position: 64 consecutive
    positions (1x1), or a pixel tile 8 wide and 14 high where 14 divides the
    grid's height, else 8 (3x3: a product step takes two pixel rows)."""
    b, oy, ox = np.meshgrid(np.arange(B), np.arange(Ho), np.arange(Wo), indexing="ij")
    if taps == 1:
        return ((b * Ho + oy) * Wo + ox).ravel() // 64
    th = 14 if Ho % 14 == 0 else 8
    return ((b * -(-Ho // th) + oy // th) * -(-Wo // 8) + ox // 8).ravel()


@pytest.mark.parametrize("B", [1, 2, 32])
@pytest.mark.parametrize("H,stride,taps,K,N", RESNET_FUSED_SITES)
def test_bf16_partial_rows_follow_the_tiling(B, H, stride, taps, K, N):
    """The bf16 forward and dgrad write one partial row a position tile:
    every tile of the restated tiling holds a position, and the count is
    ``_fwd_parts`` at bf16; the 3x3 tiles fill ResNet's 56, 28, 14 and 7
    grids with whole tiles in height."""
    Ho, Wo = _out_grid(H, stride, taps)
    tile = _fwd_tiles_restated(B, Ho, Wo, taps)
    parts = cb._fwd_parts(B, Ho, Wo, taps, BF16)
    assert parts == int(tile.max()) + 1 == len(np.unique(tile))
    if taps == 9:
        assert Ho % cb._bf16_tile_h(Ho) == 0


@pytest.mark.parametrize("B", [1, 2, 32])
@pytest.mark.parametrize("H,stride,taps,K,N", RESNET_FUSED_SITES)
def test_bf16_wgrad_splits_cover_the_reduction_in_one_wave(B, H, stride, taps, K, N):
    """Each bf16 wgrad block takes the stages [z·per, (z + 1)·per) of its
    split: every stage of the restated tiling falls in exactly one split, a
    split takes at least WGRAD_MIN_STAGES stages where there are that many,
    and the blocks fit one wave of one block an SM."""
    Ho, Wo = _out_grid(H, stride, taps)
    stage = _wgrad_stages_restated(B, Ho, Wo, taps)
    stages = int(stage.max()) + 1
    assert stages == cb._wgrad_stages(B, Ho, Wo, taps, BF16) == len(np.unique(stage))
    splits = cb._wgrad_splits(B, K, N, Ho, Wo, taps, BF16)
    per = -(-stages // splits)
    owner = stage // per
    assert owner.max() < splits and len(np.unique(owner)) == -(-stages // per)
    assert per >= min(cb.WGRAD_MIN_STAGES, stages)
    tn, tk = cb._wgrad_tile(K, taps, BF16)
    assert (tn, tk) == ((128, 64 if K <= 64 else 128) if taps == 1 else (64, 64))
    blocks = -(-N // tn) * -(-K // tk) * splits
    assert splits == 1 or blocks <= cb.SMS


def test_bf16_tile_heights():
    assert [cb._bf16_tile_h(h) for h in (56, 28, 14, 7, 8, 9, 21, 1)] == \
        [14, 14, 14, 7, 8, 8, 7, 8]
    assert [cb._wgrad_tile_h(h, BF16) for h in (56, 28, 14, 7, 8, 21)] == [14, 14, 14, 8, 8, 8]
    assert [cb._wgrad_tile_h(h) for h in (56, 28, 14, 7)] == [8, 7, 7, 7]
