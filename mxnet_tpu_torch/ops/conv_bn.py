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

Only the **recompute** backward is ported: the backward rederives
``xn = relu(x·scale + shift)`` from x. The **stash** policy (the forward
writes xn for the backward) is the same math traded for bytes on the TPU,
and is not ported yet (``ROADMAP.md``).

``conv_block``, ``conv_block_infer`` and ``conv_block_bwd`` are the
dispatchers: a CPU tensor takes the plain PyTorch version, a CUDA tensor
launches the kernel or raises. ``ConvBlock`` is the autograd Function over
them (the JAX package's ``custom_vjp`` at :435). ``launches``,
``infer_launches`` and ``bwd_launches`` count kernel launches.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from . import cuda_build

__all__ = ["strided_dims", "supported", "conv_block", "conv_block_plain", "conv_block_infer",
           "conv_block_infer_plain", "conv_block_bwd", "conv_block_bwd_plain", "ConvBlock",
           "flops"]

# the tiling of the forward and the dgrad (csrc/conv_bn.cuh, which the C
# entry point checks): 128 positions of the flattened B·H'W' axis a block for
# a 1x1 kernel, an 8 x 8 pixel tile of one image for a 3x3 kernel; one
# partial-statistics row each
FWD_TILE_P, FWD_TILE_HW = 128, 8
# the wgrad's (csrc/conv_bn_bwd.cu): (output, input) channels a block, the
# positions of a stage (1x1: 32 of the flattened axis; 3x3: one pixel tile,
# _wgrad_tile_h rows by 8), the blocks an SM holds, and the fewest stages a split takes. The
# splits fill whole waves of an H100's 132 SMs.
WGRAD_TILE = {1: (128, 64), 9: (64, 32)}
WGRAD_BLOCKS_PER_SM = {1: 2, 9: 1}
WGRAD_STEP_P, WGRAD_MIN_STAGES, SMS = 32, 4, 132

launches = 0
infer_launches = 0
bwd_launches = 0


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
    """Whether the kernels take this (float32) conv: the shape gate."""
    return _conv_geometry(tuple(x_shape), tuple(w_shape), tuple(stride), 4) is not None


def _geometry(what, x, w, stride):
    # the shape gate; a CUDA tensor must also be float32 (check_operands), a
    # CPU one may be float64 (gradcheck)
    stride = tuple(int(s) for s in stride)
    geo = _conv_geometry(tuple(x.shape), tuple(w.shape), stride, 4)
    if geo is None:
        raise MXNetError("%s: the kernel does not take x %s, w %s, stride %s (1x1 stride 1 "
                         "or 2, or 3x3 stride 1; K %% 8 == 0; H'W' >= 8)"
                         % (what, tuple(x.shape), tuple(w.shape), stride))
    return stride, geo


def _fwd_parts(B, Ho, Wo, taps):
    """The position tiles of the forward and of the dgrad, each writing one
    row of partial sums (Σc, Σc² or dscale, dshift): the flattened B·H'W'
    positions in tiles of 128 for 1x1, 8 x 8 pixel tiles of each image for
    3x3 (``tc_parts`` of ``csrc/conv_bn.cuh``)."""
    if taps == 1:
        return -(-B * Ho * Wo // FWD_TILE_P)
    return B * -(-Ho // FWD_TILE_HW) * -(-Wo // FWD_TILE_HW)


def _wgrad_tile_h(Ho):
    """The 3x3 wgrad's pixel-tile height: 8, or 7 where the output grid's
    height is a multiple of 7 and not of 8 (28, 14 and 7 rows fill whole
    tiles; ``wgrad3_tile_h`` of ``csrc/conv_bn_bwd.cu``)."""
    return 7 if Ho % FWD_TILE_HW and Ho % 7 == 0 else FWD_TILE_HW


def _wgrad_stages(B, Ho, Wo, taps):
    """The wgrad's stages along its B·H'W' reduction: 32 flattened positions
    each for 1x1, one pixel tile (``_wgrad_tile_h`` x 8) each for 3x3."""
    if taps == 1:
        return -(-B * Ho * Wo // WGRAD_STEP_P)
    return B * -(-Ho // _wgrad_tile_h(Ho)) * -(-Wo // FWD_TILE_HW)


def _wgrad_splits(B, K, N, Ho, Wo, taps):
    """Blocks the wgrad kernel splits its B·H'W' reduction over, each
    writing a partial dw that a fixed-order second pass sums: as many as fit
    one wave of blocks on the card with the (n, k) tiles, with at least
    ``WGRAD_MIN_STAGES`` stages a split."""
    tn, tk = WGRAD_TILE[taps]
    tiles = -(-N // tn) * -(-K // tk)
    stages = _wgrad_stages(B, Ho, Wo, taps)
    return max(1, min(SMS * WGRAD_BLOCKS_PER_SM[taps] // tiles, stages // WGRAD_MIN_STAGES))


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


def conv_block_infer_plain(x, w, scale, shift, stride=(1, 1), relu=False):
    """The stats-free forward in plain PyTorch: ``conv(prologue(x), w)``."""
    return F.conv2d(_prologue(x, scale, shift, relu), w, stride=tuple(stride), padding=_pad(w))


def conv_block_plain(x, w, scale, shift, res=None, stride=(1, 1), relu=False):
    """The forward kernel's function in plain PyTorch (JAX ``_xla_conv``
    :408 plus ``_stats_of`` :430): ``(c, ssum, ssq)``, the sums over (B, H',
    W') in float32."""
    c = conv_block_infer_plain(x, w, scale, shift, stride, relu)
    if res is not None:
        c = c + res
    c32 = c.to(_acc_dtype(c))
    return c, c32.sum(dim=(0, 2, 3)), (c32 * c32).sum(dim=(0, 2, 3))


def conv_block_bwd_plain(x, w, scale, shift, c, dc, ds, dq, stride=(1, 1), relu=False,
                         has_res=False):
    """The backward kernel's function in plain PyTorch (the ``bwd="xla"``
    branch of JAX ``_conv_block_bwd`` :744-785): ``(dx, dw, dscale, dshift,
    dres)``, with dscale, dshift None without a prologue and dres None
    without a residual. For a 1x1 stride-2 conv dx is zero off the sampled
    positions, and dscale, dshift sum over the sampled ones only."""
    stride, b = tuple(stride), (1, -1, 1, 1)
    acc = _acc_dtype(c)
    dce = (dc.to(acc) + ds.to(acc).reshape(b) + 2.0 * c.to(acc) * dq.to(acc).reshape(b)
           ).to(c.dtype)
    xn = _prologue(x, scale, shift, relu)
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


def _launch_fwd(what, x, w, scale, shift, res, stride, relu, stats):
    B, K, H, W = x.shape
    N, taps = w.shape[0], w.shape[2] * w.shape[3]
    Ho, Wo = _out_dims(x, w, stride)
    cuda_build.check_operands(what, *[t for t in (x, w, scale, shift, res) if t is not None])
    c = torch.empty((B, N, Ho, Wo), dtype=x.dtype, device=x.device)
    parts = _fwd_parts(B, Ho, Wo, taps)
    part = torch.empty((parts, 2, N), dtype=torch.float32, device=x.device) if stats else None
    sums = torch.empty((2, N), dtype=torch.float32, device=x.device) if stats else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = cuda_build.library()
    with torch.cuda.device(x.device):
        code = lib.mxt_conv_bn_fwd(
            x.data_ptr(), w.data_ptr(), ptr(scale), ptr(shift), ptr(res), c.data_ptr(),
            ptr(part), ptr(sums), B, K, H, W, N, taps, stride[0], int(bool(relu)), parts,
            torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(code, what)
    return c, sums


def conv_block(x, w, scale, shift, res=None, stride=(1, 1), relu=False):
    """Fused (prologue-normalised) conv (+ residual) with the statistics
    epilogue: ``(c, ssum, ssq)``, c (B, N, H', W') in x's dtype and the
    per-channel f32 sums over (B, H', W'). x (B, K, H, W), w (N, K, 1|3,
    1|3) OIHW; scale, shift (K,) or None; res (B, N, H', W') or None."""
    stride, _ = _geometry("conv_block", x, w, stride)
    _check_vectors("conv_block", x, w, scale, shift, res, stride)
    if x.device.type == "cpu":
        return conv_block_plain(x, w, scale, shift, res, stride, relu)
    global launches
    c, sums = _launch_fwd("conv_block", x, w, scale, shift, res, stride, relu, True)
    launches += 1
    return c, sums[0], sums[1]


def conv_block_infer(x, w, scale, shift, stride=(1, 1), relu=False):
    """The grad-less inference forward: the same fused prologue + conv with
    the statistics epilogue dropped (JAX ``conv_block_infer`` :460).
    Returns c; not differentiable."""
    stride, _ = _geometry("conv_block_infer", x, w, stride)
    _check_vectors("conv_block_infer", x, w, scale, shift, None, stride)
    if x.device.type == "cpu":
        return conv_block_infer_plain(x, w, scale, shift, stride, relu)
    global infer_launches
    c, _ = _launch_fwd("conv_block_infer", x, w, scale, shift, None, stride, relu, False)
    infer_launches += 1
    return c


def conv_block_bwd(x, w, scale, shift, c, dc, ds, dq, stride=(1, 1), relu=False,
                   has_res=False):
    """Gradients of ``conv_block``: ``(dx, dw, dscale, dshift, dres)`` from
    the raw input x, the saved output c, its cotangent dc and the
    statistics cotangents ds, dq (N,) f32 (the recompute policy: xn is
    rederived from x). dscale, dshift are None without a prologue, dres
    None without a residual."""
    stride, geo = _geometry("conv_block_bwd", x, w, stride)
    _check_vectors("conv_block_bwd", x, w, scale, shift, None, stride)
    B, K, N, _, taps = geo
    Ho, Wo = _out_dims(x, w, stride)
    if c.shape != (B, N, Ho, Wo) or dc.shape != c.shape or ds.shape != (N,) \
            or dq.shape != (N,):
        raise MXNetError("conv_block_bwd: want c, dc %s and ds, dq (%d,), got %s, %s, %s, %s"
                         % ((B, N, Ho, Wo), N, tuple(c.shape), tuple(dc.shape),
                            tuple(ds.shape), tuple(dq.shape)))
    if x.device.type == "cpu":
        return conv_block_bwd_plain(x, w, scale, shift, c, dc, ds, dq, stride, relu, has_res)
    what = "conv_block_bwd"
    cuda_build.check_operands(what, *[t for t in (x, w, scale, shift, c, dc, ds, dq)
                                      if t is not None])
    H, W = x.shape[2:]
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)  # at stride 2 the kernel writes the zeros too
    dw = torch.empty_like(w)
    parts = _fwd_parts(B, Ho, Wo, taps)
    splits = _wgrad_splits(B, K, N, Ho, Wo, taps)
    dw_part = torch.empty((splits, N * K * taps), **f32)
    pro = scale is not None
    dss_part = torch.empty((parts, 2, K), **f32) if pro else None
    dss = torch.empty((2, K), **f32) if pro else None
    # the folded cotangent, written once and read by both products: the
    # residual's gradient where there is one
    dce = torch.empty_like(c)
    wt = torch.empty(K * -(-N // 8) * 8 * taps, **f32)  # w transposed, taps flipped
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = cuda_build.library()
    with torch.cuda.device(x.device):
        code = lib.mxt_conv_bn_bwd(
            x.data_ptr(), w.data_ptr(), ptr(scale), ptr(shift), c.data_ptr(), dc.data_ptr(),
            ds.data_ptr(), dq.data_ptr(), dx.data_ptr(), dw.data_ptr(), dw_part.data_ptr(),
            ptr(dss), ptr(dss_part), dce.data_ptr(), wt.data_ptr(), B, K, H, W, N, taps,
            stride[0], int(bool(relu)), parts, splits,
            torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(code, what)
    global bwd_launches
    bwd_launches += 1
    return (dx, dw, None if dss is None else dss[0], None if dss is None else dss[1],
            dce if has_res else None)


class ConvBlock(torch.autograd.Function):
    """``(c, ssum, ssq) = conv_block(x, w, scale, shift, res)`` with the
    fused backward as its gradient (the recompute policy: saves x, w,
    scale, shift and c, as JAX ``_conv_block_fwd`` :507 does). A cotangent
    autograd leaves out (an unused statistic) is zero."""

    @staticmethod
    def forward(ctx, x, w, scale, shift, res, stride, relu):
        c, ssum, ssq = conv_block(x, w, scale, shift, res, stride, relu)
        ctx.save_for_backward(x, w, scale, shift, c)
        ctx.stride, ctx.relu, ctx.has_res = tuple(stride), bool(relu), res is not None
        return c, ssum, ssq

    @staticmethod
    def backward(ctx, dc, ds, dq):
        x, w, scale, shift, c = ctx.saved_tensors
        N, acc = w.shape[0], _acc_dtype(c)
        dc = torch.zeros_like(c) if dc is None else dc.contiguous()
        ds = torch.zeros(N, dtype=acc, device=c.device) if ds is None else ds.contiguous()
        dq = torch.zeros(N, dtype=acc, device=c.device) if dq is None else dq.contiguous()
        dx, dw, dscale, dshift, dres = conv_block_bwd(x, w, scale, shift, c, dc, ds, dq,
                                                      ctx.stride, ctx.relu, ctx.has_res)
        return dx, dw, dscale, dshift, dres, None, None


def flops(x_shape, w_shape, stride):
    """Multiply-adds ×2 of one forward at these shapes (the backward's dgrad
    and wgrad are twice that)."""
    B, K, N, HWo, taps = _conv_geometry(tuple(x_shape), tuple(w_shape), tuple(stride), 4)
    return 2.0 * B * HWo * N * K * taps

