"""Fused conv + BatchNorm, forward and backward: hand-written CUDA kernels
and their plain versions.

Counterpart of ``mxnet_tpu/ops/pallas_conv_bn.py``. Replaces its two TPU
kernels:

- ``_conv_block_fwd_impl`` (:301, call :373) → ``_kernel`` (:240):
  ``c = conv(relu(x·scale + shift), w) [+ res]`` with the per-channel f32
  Σc and Σc² of the result (the statistics epilogue, elided at inference,
  :460-470). Its port is ``csrc/conv_bn.cu``: an implicit GEMM on the TF32
  tensor cores with f32 accuracy (3xTF32 on ``mma.sync``,
  ``csrc/tf32x3.cuh``), output channels by output positions, the
  contraction streamed through a ``cp.async`` ring, the BatchNorm prologue
  applied to the staged input before its split. A 1x1 kernel tiles the
  flattened B·H'W' positions 128 at a time, so the 14 x 14 and 7 x 7 grids
  of ResNet-50's late stages fill whole tiles; a 3x3 kernel an 8 x 8 pixel
  tile with its border. Bound by operations at the 3x3 sites, by bytes at
  most 1x1 ones (``PERF.md`` §6).

  Its stats-free form on bf16 operands (the TPU kernel computes in its
  input's dtype, :321 and :349-350, and ``MXNET_SERVE_QUANT=bf16`` feeds it
  bf16, JAX ``fusion.py`` :1313-1336) is ``mxt_conv_bn_infer_bf16``
  (``csrc/conv_bn_bf16.cu``): the prologue in bf16, exact bf16 products
  summed in f32, c rounded to bf16. It reads f32 x and w and rounds them as
  it stages them, and writes c as the f32 of its bf16 value, so the serving
  path's casts to and from bf16 cost no pass of their own.
- ``_conv_block_bwd_impl`` (:619, call :692) → ``_bwd_kernel`` (:511): the
  fused dgrad + wgrad with the statistics cotangents folded into the output
  cotangent (``dce = dc + ds + 2·c·dq``), the prologue's backward, dscale,
  dshift and dres. Its port is ``csrc/conv_bn_bwd.cu``, on the same 3xTF32
  core: dce is folded once into one plane (dres where there is a residual),
  w is transposed with its taps flipped, the dgrad runs the forward's
  implicit GEMM and tiling over (w flipped, dce) with the prologue's backward
  in its epilogue (and, at stride 2, the zeros of dx off the sampled
  positions), and the wgrad contracts over B·H'W' split across blocks in
  whole waves: 128 x 64 channels a block for 1x1, 64 x 32 channels and all
  nine taps for 3x3, each stage one 8 x 8 (or 7 x 8) pixel tile of dce
  staged once with the bordered tile of x.

Both training kernels have a bf16 form, for ``SPMDTrainer(compute_dtype=
'bfloat16')`` (the TPU kernels compute in their input's dtype, and JAX's
bf16 step feeds them bf16): ``mxt_conv_bn_fwd_bf16`` and
``mxt_conv_bn_bwd_bf16`` (``csrc/conv_bn_bf16.cu``, ``conv_bn_bf16_bwd.cu``)
on bf16 storage (x, w, scale, shift, res, c and dc, dx, dw, dres 2 bytes an
element; the statistics, dscale and dshift f32), at the TPU kernels'
rounding points: the prologue in bf16 with two roundings, the residual
added to the f32 c, Σc and Σc² from the f32 c
before it is rounded (:284-291); dce folded in f32 and rounded once (dres
and the products' operand, :556-564), the ReLU mask from the bf16 prologue,
dx = da·scale rounded, dscale, dshift and dw summed in f32 and dw rounded
(:715). scale and shift arrive in f32 from the BatchNorm fold and are cast
to bf16, as JAX casts them (:349-350, :684-685).

The bf16 forms (serving, training, stash) run their own kernels, designed
for Hopper (``csrc/conv_bn_bf16.cuh``): bf16 staged as bf16 in shared
memory, the products on ``wgmma`` (a fresh f32 accumulator a stage), on
tilings of their own (``BF16_TILE_P`` positions by up to 128 channels for
1x1, a ``_bf16_tile_h`` x 8 pixel tile that fits ResNet's 56, 28, 14 and 7
grids for 3x3), so their partial rows and wgrad splits differ from the
f32 kernels': the helpers below take the dtype.

Each block of the forward and of the dgrad writes one row of per-channel
partial sums (Σc and Σc², or dscale and dshift) per position tile
(``_fwd_parts`` rows); each wgrad split a partial dw (``_wgrad_splits``
rows). A second pass adds the rows in a fixed order, so two runs give the
same bits.

The shape gate is the JAX package's ``_conv_geometry`` (copied below): a 1x1
kernel with stride 1 or 2, or a 3x3 kernel with stride 1 (pad 1); K % 8 == 0;
H'·W' ≥ 8. The TPU's VMEM budget (``choose_blocks``, ``bn_candidates``) is not
ported: a GPU block stages a K-chunk at a time and never holds a whole image.
At the tests' small shapes JAX's budget admits every site this gate admits
(with N a multiple of 8, as JAX's channel stripes need and the zoo's widths
are), so both packages run the same sites fused.

Both backward policies of the TPU kernels are ported. **recompute**: the
backward rederives ``xn = relu(x·scale + shift)`` from x. **stash**
(``MXNET_FUSED_CONV_BN_BWD=stash``, JAX :482-503): the forward also writes
xn, on the output grid (``conv_block(..., emit_xn=True)``, the TPU
kernel's ``emit_xn``, :270-275), and the backward reads it
(``conv_block_bwd(..., xn=xn)``, :531, :567-568): its ReLU mask and the
wgrad's operand come from xn, dscale still from x. Both training kernels
have a stash form in float32 and bfloat16 (``mxt_conv_bn_fwd_stash[_bf16]``,
``mxt_conv_bn_bwd_stash[_bf16]``): xn holds what the forward's products
consumed, which is what a recompute derives, so the two policies give the
same bits; stash trades one write and one read of xn for the recompute.

``conv_block``, ``conv_block_infer`` and ``conv_block_bwd`` are the
dispatchers: a CPU tensor takes the plain PyTorch version, a CUDA tensor
launches the kernel or raises. ``ConvBlock`` is the autograd Function over
them (the JAX package's ``custom_vjp`` at :435). ``launches``,
``infer_launches``, ``infer_bf16_launches``, ``bwd_launches``, the bf16
training forms' ``fwd_bf16_launches`` and ``bwd_bf16_launches``, and the
stash forms' ``stash_launches``, ``bwd_stash_launches``,
``stash_bf16_launches`` and ``bwd_stash_bf16_launches`` count kernel
launches (a stash launch counts under its own name only). A training
dispatcher picks the form by x's dtype: float32 (all operands float32) or
bfloat16 (x, w, res and c, dc, xn bfloat16).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from . import cuda_build

__all__ = ["strided_dims", "supported", "conv_block", "conv_block_plain", "conv_block_infer",
           "conv_block_infer_plain", "conv_block_bwd", "conv_block_bwd_plain", "ConvBlock",
           "flops", "bf16_ulps", "bf16_compare"]

# the tiling of the forward and the dgrad (csrc/conv_bn.cuh, which the C
# entry point checks): 128 positions of the flattened B·H'W' axis a block for
# a 1x1 kernel, an 8 x 8 pixel tile of one image for a 3x3 kernel; one
# partial-statistics row each
FWD_TILE_P, FWD_TILE_HW = 128, 8
# the bf16 forms' (csrc/conv_bn_bf16.cuh): 64 flattened positions a block for
# 1x1, a _bf16_tile_h x 8 pixel tile for 3x3
BF16_TILE_P, BF16_TILE_W = 64, 8
# the wgrad's (csrc/conv_bn_bwd.cu): (output, input) channels a block, the
# positions of a stage (1x1: 32 of the flattened axis; 3x3: one pixel tile,
# _wgrad_tile_h rows by 8), the blocks an SM holds, and the fewest stages a split takes. The
# splits fill whole waves of an H100's 132 SMs.
WGRAD_TILE = {1: (128, 64), 9: (64, 32)}
WGRAD_BLOCKS_PER_SM = {1: 2, 9: 1}
WGRAD_STEP_P, WGRAD_MIN_STAGES, SMS = 32, 4, 132
# the bf16 wgrad's (csrc/conv_bn_bf16_bwd.cu): 1x1, 128 output by 128 input
# channels (64 where K <= 64) and 64 positions a stage; 3x3, 64 by 64 and
# one _wgrad_tile_h x 8 pixel tile a stage; one block an SM
WGRAD_TILE_BF16 = {1: (128, 128), 9: (64, 64)}
WGRAD_STEP_P_BF16 = 64

launches = 0
infer_launches = 0
infer_bf16_launches = 0
bwd_launches = 0
fwd_bf16_launches = 0
bwd_bf16_launches = 0
stash_launches = 0
bwd_stash_launches = 0
stash_bf16_launches = 0
bwd_stash_bf16_launches = 0


# copied from mxnet_tpu/ops/pallas_conv_bn.py (strided_dims, backend-free)
def strided_dims(H, W, stride):
    """Post-stride spatial dims as the forward computes them: the kernel
    reads ``x[:, :, ::s, ::s]``, which keeps ``ceil(H/s)`` rows for odd H
    (matching the pad-0 stride-s convolution's output)."""
    return (H + stride[0] - 1) // stride[0], (W + stride[1] - 1) // stride[1]


# copied from mxnet_tpu/ops/pallas_conv_bn.py (_conv_geometry, backend-free)
def _conv_geometry(x_shape, w_shape, stride, itemsize):
    """Shared structural gate of the fwd and bwd planners: (B, K, N, HW,
    taps) for an eligible call, else None."""
    if len(x_shape) != 4 or len(w_shape) != 4 or itemsize > 4:
        return None
    B, K, H, W = x_shape
    N, K2, kh, kw = w_shape
    if K != K2:
        return None
    if (kh, kw) == (1, 1):
        if stride[0] != stride[1] or stride[0] not in (1, 2):
            return None
        H, W = strided_dims(H, W, stride)
        taps = 1
    elif (kh, kw) == (3, 3):
        if stride != (1, 1):
            return None
        taps = 9
    else:
        return None
    if K % 8 or H * W < 8:
        return None
    return B, K, N, H * W, taps


def supported(x_shape, w_shape, stride=(1, 1)):
    """Whether the kernels take this conv: the shape gate, the same for the
    float32 kernels and every bf16 form (a GPU block stages a chunk of K at
    a time, so the TPU's VMEM budget, which the dtype's itemsize enters, has
    no counterpart)."""
    return _conv_geometry(tuple(x_shape), tuple(w_shape), tuple(stride), 4) is not None


def _geometry(what, x, w, stride):
    # the shape gate; a CUDA tensor must also be float32 or bfloat16
    # (check_operands), a CPU one may be float64 (gradcheck)
    stride = tuple(int(s) for s in stride)
    geo = _conv_geometry(tuple(x.shape), tuple(w.shape), stride, 4)
    if geo is None:
        raise MXNetError("%s: the kernel does not take x %s, w %s, stride %s (1x1 stride 1 "
                         "or 2, or 3x3 stride 1; K %% 8 == 0; H'W' >= 8)"
                         % (what, tuple(x.shape), tuple(w.shape), stride))
    return stride, geo


def _bf16(dtype):
    return dtype == torch.bfloat16


def _bf16_tile_h(Ho):
    """The bf16 forms' 3x3 pixel-tile height (``tile_h`` of
    ``csrc/conv_bn_bf16.cuh``): 14 where the output grid's height is a
    multiple of 14, 7 where of 7, else 8."""
    return 14 if Ho % 14 == 0 else (7 if Ho % 7 == 0 else 8)


def _fwd_parts(B, Ho, Wo, taps, dtype=torch.float32):
    """The position tiles of the forward and of the dgrad, each writing one
    row of partial sums (Σc, Σc² or dscale, dshift). float32: the flattened
    B·H'W' positions in tiles of 128 for 1x1, 8 x 8 pixel tiles of each
    image for 3x3 (``tc_parts`` of ``csrc/conv_bn.cuh``); bfloat16: tiles of
    64 positions, ``_bf16_tile_h`` x 8 pixel tiles (``parts`` of
    ``csrc/conv_bn_bf16.cuh``)."""
    if _bf16(dtype):
        if taps == 1:
            return -(-B * Ho * Wo // BF16_TILE_P)
        return B * -(-Ho // _bf16_tile_h(Ho)) * -(-Wo // BF16_TILE_W)
    if taps == 1:
        return -(-B * Ho * Wo // FWD_TILE_P)
    return B * -(-Ho // FWD_TILE_HW) * -(-Wo // FWD_TILE_HW)


def _wgrad_tile_h(Ho, dtype=torch.float32):
    """The 3x3 wgrad's pixel-tile height. float32: 8, or 7 where the output
    grid's height is a multiple of 7 and not of 8 (28, 14 and 7 rows fill
    whole tiles; ``wgrad3_tile_h`` of ``csrc/conv_bn_bwd.cu``); bfloat16: 14
    where the height is a multiple of 14, else 8 (a product step takes two
    pixel rows; ``csrc/conv_bn_bf16_bwd.cu``)."""
    if _bf16(dtype):
        return 14 if Ho % 14 == 0 else FWD_TILE_HW
    return 7 if Ho % FWD_TILE_HW and Ho % 7 == 0 else FWD_TILE_HW


def _wgrad_stages(B, Ho, Wo, taps, dtype=torch.float32):
    """The wgrad's stages along its B·H'W' reduction: 32 flattened positions
    each for 1x1 (64 at bfloat16), one pixel tile (``_wgrad_tile_h`` x 8)
    each for 3x3."""
    if taps == 1:
        return -(-B * Ho * Wo // (WGRAD_STEP_P_BF16 if _bf16(dtype) else WGRAD_STEP_P))
    return B * -(-Ho // _wgrad_tile_h(Ho, dtype)) * -(-Wo // FWD_TILE_HW)


def _wgrad_tile(K, taps, dtype=torch.float32):
    """The (output, input) channels of a wgrad block."""
    if not _bf16(dtype):
        return WGRAD_TILE[taps]
    tn, tk = WGRAD_TILE_BF16[taps]
    return tn, (tk if taps == 9 or K > 64 else 64)


def _wgrad_splits(B, K, N, Ho, Wo, taps, dtype=torch.float32):
    """Blocks the wgrad kernel splits its B·H'W' reduction over, each
    writing a partial dw that a fixed-order second pass sums: as many as fit
    one wave of blocks on the card with the (n, k) tiles, with at least
    ``WGRAD_MIN_STAGES`` stages a split (the bf16 kernels hold one block an
    SM)."""
    tn, tk = _wgrad_tile(K, taps, dtype)
    tiles = -(-N // tn) * -(-K // tk)
    stages = _wgrad_stages(B, Ho, Wo, taps, dtype)
    per_sm = 1 if _bf16(dtype) else WGRAD_BLOCKS_PER_SM[taps]
    return max(1, min(SMS * per_sm // tiles, stages // WGRAD_MIN_STAGES))


def _acc_dtype(t):
    """The accumulation dtype: float32, or float64 for float64 (gradcheck)."""
    return torch.promote_types(t.dtype, torch.float32)


# ------------------------------------------------------------ plain versions
def _prologue(x, scale, shift, relu):
    if scale is None:
        return x
    b = (1, -1, 1, 1)
    xn = x * scale.to(x.dtype).reshape(b) + shift.to(x.dtype).reshape(b)
    return torch.relu(xn) if relu else xn


def _pad(w):
    return (w.shape[2] - 1) // 2


def _prologue_bf16(x, scale, shift, relu):
    """The bf16 kernels' prologue on bfloat16 x: scale and shift cast to
    bfloat16, the product rounded to bfloat16 and then the sum
    (``conv_block_infer_plain`` says why two roundings)."""
    if scale is None:
        return x
    bf16, b = torch.bfloat16, (1, -1, 1, 1)
    xn = (x.float() * scale.to(bf16).float().reshape(b)).to(bf16)
    xn = (xn.float() + shift.to(bf16).float().reshape(b)).to(bf16)
    return torch.relu(xn) if relu else xn


def _conv_bf16_f32(x, w, scale, shift, stride, relu):
    """The convolution of bfloat16 x and w as the bf16 kernels take it: the
    prologue in bfloat16, the products of the bfloat16 values (each exact in
    float32) summed in float32. Returns the float32 c, before its rounding."""
    xn = _prologue_bf16(x, scale, shift, relu)
    return F.conv2d(xn.float(), w.to(torch.bfloat16).float(), stride=tuple(stride),
                    padding=_pad(w))


def conv_block_infer_plain(x, w, scale, shift, stride=(1, 1), relu=False):
    """The stats-free forward in plain PyTorch: ``conv(prologue(x), w)``.

    On bfloat16 x and w it computes what the JAX package's kernel computes on
    them (``_kernel`` :256-286): scale and shift cast to bfloat16, the
    prologue's product rounded to bfloat16 and then its sum (two roundings),
    the convolution of the bfloat16 values with a float32 accumulator, and c
    rounded to bfloat16. Two roundings, not one after the add: at seeded
    1x1 and 3x3 sites the two-rounding prologue gives the JAX package's CPU
    output bit for bit, where one rounding leaves about half the elements a
    bfloat16 ulp or more away (``tests/test_torch_serve_bf16.py``). The
    bf16 kernel rounds at the same points (``csrc/bf16_mma.cuh``)."""
    if x.dtype != torch.bfloat16:
        return F.conv2d(_prologue(x, scale, shift, relu), w, stride=tuple(stride),
                        padding=_pad(w))
    return _conv_bf16_f32(x, w, scale, shift, stride, relu).to(torch.bfloat16)


def _stashed_xn(x, w, scale, shift, stride, relu):
    """The stash policy's xn as the kernels write it: the prologue of the
    positions the conv reads, on the output grid (a 1x1 strided conv's
    sampled positions; JAX's ``emit_xn`` output, :306-307), in x's dtype."""
    if w.shape[2] == 1 and tuple(stride) != (1, 1):
        x = x[:, :, ::stride[0], ::stride[1]]
    if x.dtype == torch.bfloat16:
        return _prologue_bf16(x, scale, shift, relu)
    return _prologue(x, scale, shift, relu)


def _on_input_grid(xn, x, stride):
    """A stashed xn on x's grid: itself, or (1x1 at stride 2) the sampled
    positions with zeros between, which no product of the conv reads."""
    if xn.shape == x.shape:
        return xn
    full = xn.new_zeros(x.shape)
    full[:, :, ::stride[0], ::stride[1]] = xn
    return full


def conv_block_plain(x, w, scale, shift, res=None, stride=(1, 1), relu=False, emit_xn=False):
    """The forward kernel's function in plain PyTorch (JAX ``_xla_conv``
    :408 plus ``_stats_of`` :430): ``(c, ssum, ssq)``, the sums over (B, H',
    W') in float32, and with ``emit_xn`` the stash policy's xn
    (``_stashed_xn``) as a fourth.

    On bfloat16 x and w it rounds where the TPU kernel does (``_kernel``
    :256-291): the convolution and the residual added in float32, the sums
    taken from that float32 c, then c rounded to bfloat16."""
    xn = (_stashed_xn(x, w, scale, shift, stride, relu),) if emit_xn else ()
    if x.dtype == torch.bfloat16:
        c32 = _conv_bf16_f32(x, w, scale, shift, stride, relu)
        if res is not None:
            c32 = c32 + res.float()
        return (c32.to(torch.bfloat16), c32.sum(dim=(0, 2, 3)),
                (c32 * c32).sum(dim=(0, 2, 3))) + xn
    c = conv_block_infer_plain(x, w, scale, shift, stride, relu)
    if res is not None:
        c = c + res
    c32 = c.to(_acc_dtype(c))
    return (c, c32.sum(dim=(0, 2, 3)), (c32 * c32).sum(dim=(0, 2, 3))) + xn


def conv_block_bwd_plain(x, w, scale, shift, c, dc, ds, dq, stride=(1, 1), relu=False,
                         has_res=False, xn=None):
    """The backward kernel's function in plain PyTorch (the ``bwd="xla"``
    branch of JAX ``_conv_block_bwd`` :744-785): ``(dx, dw, dscale, dshift,
    dres)``, with dscale, dshift None without a prologue and dres None
    without a residual. For a 1x1 stride-2 conv dx is zero off the sampled
    positions, and dscale, dshift sum over the sampled ones only. ``xn``:
    the stash policy's (``conv_block_plain(..., emit_xn=True)``), used where
    the recompute would rederive it; the same values, so the same bits.

    On bfloat16 operands it rounds where the TPU kernel does
    (``_bwd_kernel`` :511-620, ``_conv_block_bwd_impl`` :715), not where the
    ``bwd="xla"`` branch does: ``_conv_block_bwd_bf16_plain``."""
    if x.dtype == torch.bfloat16:
        return _conv_block_bwd_bf16_plain(x, w, scale, shift, c, dc, ds, dq, stride, relu,
                                          has_res, xn)
    stride, b = tuple(stride), (1, -1, 1, 1)
    acc = _acc_dtype(c)
    dce = (dc.to(acc) + ds.to(acc).reshape(b) + 2.0 * c.to(acc) * dq.to(acc).reshape(b)
           ).to(c.dtype)
    xn = _prologue(x, scale, shift, relu) if xn is None else _on_input_grid(xn, x, stride)
    dxn = torch.nn.grad.conv2d_input(x.shape, w, dce, stride=stride, padding=_pad(w))
    dw = torch.nn.grad.conv2d_weight(xn, w.shape, dce, stride=stride, padding=_pad(w))
    if scale is None:
        return dxn, dw, None, None, dce if has_res else None
    if relu:
        dxn = dxn * (xn > 0).to(dxn.dtype)
    dx = dxn * scale.to(dxn.dtype).reshape(b)
    dxn32 = dxn.to(acc)
    dscale = (dxn32 * x.to(acc)).sum(dim=(0, 2, 3))
    dshift = dxn32.sum(dim=(0, 2, 3))
    return dx, dw, dscale, dshift, dce if has_res else None


def _fold_bf16(c, dc, ds, dq):
    """dce = dc + ds + 2·c·dq in float32 as the JAX package's compiled fold
    computes it, ``fma(2c, dq, dc + ds)`` (XLA contracts the product into the
    add: one rounding, where two roundings leave some elements a bfloat16
    ulp away once dce is rounded), then rounded to bfloat16. The product of
    a bfloat16 and a float32 value is exact in float64, so the float64 sum
    rounded to float32 is the fused one."""
    b = (1, -1, 1, 1)
    first = (dc.float() + ds.float().reshape(b)).double()
    fused = first + 2.0 * c.double() * dq.double().reshape(b)
    return fused.float().to(torch.bfloat16)


def _conv_block_bwd_bf16_plain(x, w, scale, shift, c, dc, ds, dq, stride, relu, has_res,
                               xn=None):
    """The bf16 backward kernel's function: dce (``_fold_bf16``) rounded to
    bfloat16 once (dres, and the products' operand); xn from the bfloat16
    prologue (or the stashed one), the ReLU mask from it; da and dw the
    float32 sums of exact products; dx = da·scale rounded to bfloat16;
    dscale = Σ da·x and dshift = Σ da in float32; dw rounded to bfloat16."""
    stride, b, bf16 = tuple(stride), (1, -1, 1, 1), torch.bfloat16
    dce = _fold_bf16(c, dc, ds, dq)
    w32 = w.to(bf16).float()
    da = torch.nn.grad.conv2d_input(x.shape, w32, dce.float(), stride=stride, padding=_pad(w))
    xn = (_prologue_bf16(x, scale, shift, relu) if xn is None
          else _on_input_grid(xn, x, stride))
    dw = torch.nn.grad.conv2d_weight(xn.float(), w.shape, dce.float(), stride=stride,
                                     padding=_pad(w)).to(bf16)
    res = dce if has_res else None
    if scale is None:
        return da.to(bf16), dw, None, None, res
    if relu:
        da = da * (xn > 0).float()
    dx = (da * scale.to(bf16).float().reshape(b)).to(bf16)
    return (dx, dw, (da * x.float()).sum(dim=(0, 2, 3)), da.sum(dim=(0, 2, 3)), res)


# --------------------------------------------------------------- dispatchers
def _check_vectors(what, x, w, scale, shift, res, stride):
    K, N = x.shape[1], w.shape[0]
    if (scale is None) != (shift is None):
        raise MXNetError("%s: scale and shift come together" % what)
    if scale is not None and (scale.shape != (K,) or shift.shape != (K,)):
        raise MXNetError("%s: scale and shift must be (%d,), got %s, %s"
                         % (what, K, tuple(scale.shape), tuple(shift.shape)))
    if res is not None:
        Ho, Wo = _out_dims(x, w, stride)
        if res.shape != (x.shape[0], N, Ho, Wo):
            raise MXNetError("%s: res must be %s, got %s"
                             % (what, (x.shape[0], N, Ho, Wo), tuple(res.shape)))


def _out_dims(x, w, stride):
    if w.shape[2] == 1:
        return strided_dims(x.shape[2], x.shape[3], stride)
    return x.shape[2], x.shape[3]


def _bf16_vectors(x, scale, shift):
    """scale and shift as the bf16 kernels take them: cast to bfloat16 (the
    TPU kernels' ``scale.astype(dt)``), when x is bfloat16."""
    if x.dtype != torch.bfloat16 or scale is None:
        return scale, shift
    return scale.to(torch.bfloat16).contiguous(), shift.to(torch.bfloat16).contiguous()


def _launch_fwd(what, x, w, scale, shift, res, stride, relu, stats, emit_xn=False):
    """One forward launch: the float32 kernel (stats or not), or on bfloat16
    x the bf16 training form (stats); ``emit_xn``, their stash forms, which
    also return xn."""
    B, K, H, W = x.shape
    N, taps = w.shape[0], w.shape[2] * w.shape[3]
    Ho, Wo = _out_dims(x, w, stride)
    bf16 = x.dtype == torch.bfloat16
    scale, shift = _bf16_vectors(x, scale, shift)
    cuda_build.check_operands(what, *[t for t in (x, w, scale, shift, res) if t is not None],
                              dtypes=(torch.bfloat16,) if bf16 else (torch.float32,))
    c = torch.empty((B, N, Ho, Wo), dtype=x.dtype, device=x.device)
    parts = _fwd_parts(B, Ho, Wo, taps, x.dtype)
    part = torch.empty((parts, 2, N), dtype=torch.float32, device=x.device) if stats else None
    sums = torch.empty((2, N), dtype=torch.float32, device=x.device) if stats else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = cuda_build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    head = (x.data_ptr(), w.data_ptr(), ptr(scale), ptr(shift), ptr(res), c.data_ptr(),
            ptr(part), ptr(sums))
    tail = (B, K, H, W, N, taps, stride[0], int(bool(relu)), parts, stream)
    xn = None
    with torch.cuda.device(x.device):
        if emit_xn:
            xn = torch.empty((B, K, Ho, Wo), dtype=x.dtype, device=x.device)
            fn = lib.mxt_conv_bn_fwd_stash_bf16 if bf16 else lib.mxt_conv_bn_fwd_stash
            code = fn(*head, xn.data_ptr(), *tail)
        else:
            code = (lib.mxt_conv_bn_fwd_bf16 if bf16 else lib.mxt_conv_bn_fwd)(*head, *tail)
    cuda_build.check(code, what)
    return c, sums, xn


def conv_block(x, w, scale, shift, res=None, stride=(1, 1), relu=False, emit_xn=False):
    """Fused (prologue-normalised) conv (+ residual) with the statistics
    epilogue: ``(c, ssum, ssq)``, c (B, N, H', W') in x's dtype and the
    per-channel f32 sums over (B, H', W'). x (B, K, H, W), w (N, K, 1|3,
    1|3) OIHW; scale, shift (K,) or None; res (B, N, H', W') or None.
    On bfloat16 x (w and res bfloat16 too; scale and shift of any float
    dtype, cast to bfloat16) the bf16 training form, ``fwd_bf16_launches``.

    ``emit_xn`` (the stash policy; a prologue required): also returns xn,
    ``relu(x·scale + shift)`` on the output grid (B, K, H', W') in x's
    dtype, the stash forms' output (``stash_launches``,
    ``stash_bf16_launches``)."""
    stride, _ = _geometry("conv_block", x, w, stride)
    _check_vectors("conv_block", x, w, scale, shift, res, stride)
    if emit_xn and scale is None:
        raise MXNetError("conv_block: emit_xn stashes the prologue's output; there is no "
                         "prologue (scale, shift)")
    if x.device.type == "cpu":
        return conv_block_plain(x, w, scale, shift, res, stride, relu, emit_xn)
    global launches, fwd_bf16_launches, stash_launches, stash_bf16_launches
    c, sums, xn = _launch_fwd("conv_block", x, w, scale, shift, res, stride, relu, True,
                              emit_xn)
    bf16 = x.dtype == torch.bfloat16
    if emit_xn:
        if bf16:
            stash_bf16_launches += 1
        else:
            stash_launches += 1
        return c, sums[0], sums[1], xn
    if bf16:
        fwd_bf16_launches += 1
    else:
        launches += 1
    return c, sums[0], sums[1]


def conv_block_infer(x, w, scale, shift, stride=(1, 1), relu=False, compute=None):
    """The grad-less inference forward: the same fused prologue + conv with
    the statistics epilogue dropped (JAX ``conv_block_infer`` :460).
    Returns c; not differentiable.

    It computes in x's dtype, as the JAX package's kernel does, and w must
    have it too: float32 (the 3xTF32 kernel, ``infer_launches``) or bfloat16
    (the bf16 kernel, ``infer_bf16_launches``; c in bfloat16).
    ``compute="bfloat16"`` takes operands of any float dtype and returns
    ``conv_block_infer(x.bfloat16(), w.bfloat16(), ...).to(x.dtype)``, as
    the JAX package's ``MXNET_SERVE_QUANT=bf16`` path computes it (fusion.py
    :1313-1336): on the card the bf16 kernel reads float32 operands as they
    are and writes float32 c, so those casts cost nothing."""
    what = "conv_block_infer"
    stride, _ = _geometry(what, x, w, stride)
    _check_vectors(what, x, w, scale, shift, None, stride)
    if compute not in (None, "bfloat16"):
        raise MXNetError("%s: compute must be None or 'bfloat16', got %r" % (what, compute))
    bf16 = compute == "bfloat16" or x.dtype == torch.bfloat16
    if compute is None and w.dtype != x.dtype:
        raise MXNetError("%s: x is %s and w %s; the kernel computes in one dtype"
                         % (what, x.dtype, w.dtype))
    if x.device.type == "cpu":
        if bf16:
            c = conv_block_infer_plain(x.to(torch.bfloat16), w.to(torch.bfloat16), scale,
                                       shift, stride, relu)
            return c.to(x.dtype)
        return conv_block_infer_plain(x, w, scale, shift, stride, relu)
    if not bf16:
        global infer_launches
        c, _, _ = _launch_fwd(what, x, w, scale, shift, None, stride, relu, False)
        infer_launches += 1
        return c
    operands = [t for t in (x, w, scale, shift) if t is not None]
    cuda_build.check_operands(what, *operands, dtypes=(torch.float32, torch.bfloat16))
    # the kernel reads float32: a bfloat16 operand widens exactly
    x32, w32, sc32, sh32 = (None if t is None else t.float() for t in (x, w, scale, shift))
    B, K, H, W = x.shape
    N, taps = w.shape[0], w.shape[2] * w.shape[3]
    Ho, Wo = _out_dims(x, w, stride)
    c = torch.empty((B, N, Ho, Wo), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = cuda_build.library()
    with torch.cuda.device(x.device):
        code = lib.mxt_conv_bn_infer_bf16(
            x32.data_ptr(), w32.data_ptr(), ptr(sc32), ptr(sh32), c.data_ptr(), B, K, H, W, N,
            taps, stride[0], int(bool(relu)), torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(code, what)
    global infer_bf16_launches
    infer_bf16_launches += 1
    return c.to(x.dtype)


def conv_block_bwd(x, w, scale, shift, c, dc, ds, dq, stride=(1, 1), relu=False,
                   has_res=False, xn=None):
    """Gradients of ``conv_block``: ``(dx, dw, dscale, dshift, dres)`` from
    the raw input x, the saved output c, its cotangent dc and the
    statistics cotangents ds, dq (N,) f32. With ``xn`` (the stash policy: a
    prologue's output from ``conv_block(..., emit_xn=True)``) the stash
    forms read it (``bwd_stash_launches``, ``bwd_stash_bf16_launches``);
    without, the recompute policy rederives it from x. dscale, dshift are
    None without a prologue, dres None without a residual. On bfloat16 x
    (w, c, dc and xn bfloat16 too) the bf16 form, ``bwd_bf16_launches``:
    dx, dw and dres bfloat16, dscale and dshift float32."""
    stride, geo = _geometry("conv_block_bwd", x, w, stride)
    _check_vectors("conv_block_bwd", x, w, scale, shift, None, stride)
    B, K, N, _, taps = geo
    Ho, Wo = _out_dims(x, w, stride)
    if c.shape != (B, N, Ho, Wo) or dc.shape != c.shape or ds.shape != (N,) \
            or dq.shape != (N,):
        raise MXNetError("conv_block_bwd: want c, dc %s and ds, dq (%d,), got %s, %s, %s, %s"
                         % ((B, N, Ho, Wo), N, tuple(c.shape), tuple(dc.shape),
                            tuple(ds.shape), tuple(dq.shape)))
    if xn is not None and (scale is None or xn.shape != (B, K, Ho, Wo)):
        raise MXNetError("conv_block_bwd: a stashed xn is the prologue's output %s; got %s%s"
                         % ((B, K, Ho, Wo), tuple(xn.shape),
                            " without a prologue" if scale is None else ""))
    if x.device.type == "cpu":
        return conv_block_bwd_plain(x, w, scale, shift, c, dc, ds, dq, stride, relu, has_res,
                                    xn)
    what = "conv_block_bwd"
    bf16 = x.dtype == torch.bfloat16
    scale, shift = _bf16_vectors(x, scale, shift)
    if bf16:
        cuda_build.check_operands(what, *[t for t in (x, w, scale, shift, c, dc, xn)
                                          if t is not None], dtypes=(torch.bfloat16,))
        cuda_build.check_operands(what, ds, dq)  # the statistics' cotangents: float32
    else:
        cuda_build.check_operands(what, *[t for t in (x, w, scale, shift, c, dc, ds, dq, xn)
                                          if t is not None])
    H, W = x.shape[2:]
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)  # at stride 2 the kernel writes the zeros too
    dw = torch.empty_like(w)
    parts = _fwd_parts(B, Ho, Wo, taps, x.dtype)
    splits = _wgrad_splits(B, K, N, Ho, Wo, taps, x.dtype)
    dw_part = torch.empty((splits, N * K * taps), **f32)
    pro = scale is not None
    dss_part = torch.empty((parts, 2, K), **f32) if pro else None
    dss = torch.empty((2, K), **f32) if pro else None
    # the folded cotangent, written once and read by both products: the
    # residual's gradient where there is one
    dce = torch.empty_like(c)
    # w transposed, taps flipped
    wt = torch.empty(K * -(-N // 8) * 8 * taps, dtype=x.dtype, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = cuda_build.library()
    head = (x.data_ptr(), w.data_ptr(), ptr(scale), ptr(shift), c.data_ptr(), dc.data_ptr(),
            ds.data_ptr(), dq.data_ptr())
    tail = (dx.data_ptr(), dw.data_ptr(), dw_part.data_ptr(), ptr(dss), ptr(dss_part),
            dce.data_ptr(), wt.data_ptr(), B, K, H, W, N, taps, stride[0], int(bool(relu)),
            parts, splits, torch.cuda.current_stream(x.device).cuda_stream)
    with torch.cuda.device(x.device):
        if xn is not None:
            fn = lib.mxt_conv_bn_bwd_stash_bf16 if bf16 else lib.mxt_conv_bn_bwd_stash
            code = fn(*head, xn.data_ptr(), *tail)
        else:
            code = (lib.mxt_conv_bn_bwd_bf16 if bf16 else lib.mxt_conv_bn_bwd)(*head, *tail)
    cuda_build.check(code, what)
    global bwd_launches, bwd_bf16_launches, bwd_stash_launches, bwd_stash_bf16_launches
    if xn is not None and bf16:
        bwd_stash_bf16_launches += 1
    elif xn is not None:
        bwd_stash_launches += 1
    elif bf16:
        bwd_bf16_launches += 1
    else:
        bwd_launches += 1
    return (dx, dw, None if dss is None else dss[0], None if dss is None else dss[1],
            dce if has_res else None)


class ConvBlock(torch.autograd.Function):
    """``(c, ssum, ssq) = conv_block(x, w, scale, shift, res)`` with its
    gradient by ``bwd``: ``"recompute"`` (the default) the fused backward
    kernel, which saves x, w, scale, shift and c, as JAX
    ``_conv_block_fwd`` :507 does; ``"stash"`` the stash forms, whose
    forward also writes xn, saved with them, and whose backward reads it
    (without a prologue there is nothing to stash, and it runs recompute,
    as JAX's forward demotes it, :486); ``"xla"`` the plain version's
    backward (library products, JAX's ``bwd="xla"``), which the fusion gate
    picks where a tuned verdict or ``MXNET_FUSED_CONV_BN_BWD`` asks for it.
    A cotangent autograd leaves out (an unused statistic) is zero."""

    @staticmethod
    def forward(ctx, x, w, scale, shift, res, stride, relu, bwd="recompute"):
        if bwd not in ("recompute", "stash", "xla"):
            raise MXNetError("ConvBlock: bwd must be 'recompute', 'stash' or 'xla', got %r"
                             % (bwd,))
        if bwd == "stash" and scale is None:
            bwd = "recompute"
        xn = None
        if bwd == "stash":
            c, ssum, ssq, xn = conv_block(x, w, scale, shift, res, stride, relu, emit_xn=True)
        else:
            c, ssum, ssq = conv_block(x, w, scale, shift, res, stride, relu)
        ctx.save_for_backward(x, w, scale, shift, c, xn)
        ctx.stride, ctx.relu, ctx.has_res = tuple(stride), bool(relu), res is not None
        ctx.bwd = bwd
        return c, ssum, ssq

    @staticmethod
    def backward(ctx, dc, ds, dq):
        x, w, scale, shift, c, xn = ctx.saved_tensors
        N, acc = w.shape[0], _acc_dtype(c)
        dc = torch.zeros_like(c) if dc is None else dc.contiguous()
        ds = torch.zeros(N, dtype=acc, device=c.device) if ds is None else ds.contiguous()
        dq = torch.zeros(N, dtype=acc, device=c.device) if dq is None else dq.contiguous()
        run = conv_block_bwd_plain if ctx.bwd == "xla" else conv_block_bwd
        dx, dw, dscale, dshift, dres = run(x, w, scale, shift, c, dc, ds, dq,
                                           ctx.stride, ctx.relu, ctx.has_res, xn)
        return dx, dw, dscale, dshift, dres, None, None, None


def bf16_ulps(a, b):
    """Elementwise distance in bfloat16 ulps of two tensors of bfloat16
    values (held in any float dtype): the count of bfloat16 steps between
    them, read off their bit patterns laid on one monotone integer line
    (-0 and +0 the same point). 1 is a neighbour, whatever the binade."""
    def line(t):
        bits = t.to(torch.bfloat16).view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (line(a) - line(b)).abs()


def _relu_kink_outputs(x, w_shape, scale, shift, stride):
    """The outputs whose inputs hold a bfloat16 ReLU decision the rounding
    of the prologue decides (``conv_block_infer_plain``): an element whose
    pre-activation is above 0 under one of its two definitions (the product
    and the sum each rounded to bfloat16, or one rounding after the add) and
    not under the other. Returns ``(kinks, outputs)``, boolean masks of x's
    shape and of the output's."""
    bf16, b = torch.bfloat16, (1, -1, 1, 1)
    xb = x.to(bf16).float()
    sc, sh = scale.to(bf16).float().reshape(b), shift.to(bf16).float().reshape(b)
    two = ((xb * sc).to(bf16).float() + sh).to(bf16).float()
    one = (xb * sc + sh).to(bf16).float()
    kinks = (two > 0) != (one > 0)
    ones = torch.ones((1, 1) + tuple(w_shape[2:]), dtype=torch.float32, device=x.device)
    hit = F.conv2d(kinks.any(dim=1, keepdim=True).float(), ones, stride=tuple(stride),
                   padding=(w_shape[2] - 1) // 2)
    return kinks, (hit > 0).expand(x.shape[0], w_shape[0], -1, -1)


def bf16_compare(got, want, x, w_shape, scale, shift, stride=(1, 1), relu=False):
    """A bf16 forward's c against another's (the kernel's against its plain
    version's, the plain version's against the JAX package's) on the inputs
    x, scale, shift: the share bitwise equal (``bitwise``), the elements one
    bfloat16 ulp apart (``one_ulp``), those farther (``beyond``) outside the
    outputs of the ReLU decisions the prologue's rounding decides and
    outside 1e-6 of the largest |want|, the same count with those outputs
    kept in (``beyond_at_kinks_too``), the input elements holding such
    decisions (``kinks``) and the largest difference (``max_abs_err``)."""
    got, want = got.float(), want.float()
    ulps = bf16_ulps(got, want)
    small = (got - want).abs() <= 1e-6 * want.abs().max()
    skip, kinks = small, 0
    if scale is not None and relu:
        k_in, k_out = _relu_kink_outputs(x, w_shape, scale, shift, stride)
        skip = small | k_out
        kinks = int(k_in.sum())
    return {"bitwise": float((got == want).float().mean()), "one_ulp": int((ulps == 1).sum()),
            "beyond": int(((ulps > 1) & ~skip).sum()),
            "beyond_at_kinks_too": int(((ulps > 1) & ~small).sum()), "kinks": kinks,
            "max_abs_err": float((got - want).abs().max())}


def flops(x_shape, w_shape, stride):
    """Multiply-adds ×2 of one forward at these shapes (the backward's dgrad
    and wgrad are twice that)."""
    B, K, N, HWo, taps = _conv_geometry(tuple(x_shape), tuple(w_shape), tuple(stride), 4)
    return 2.0 * B * HWo * N * K * taps

