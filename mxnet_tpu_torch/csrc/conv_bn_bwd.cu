// Fused conv + BatchNorm backward: dx, dw, dscale, dshift and dres of
// conv_bn.cu's forward, from the raw input x, the saved output c, its
// cotangent dc and the statistics' cotangents ds, dq (N,).
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_conv_bn.py _bwd_kernel
// (:511), launched by _conv_block_bwd_impl (:619, pallas_call :692), in its
// recompute policy: xn = relu(x·scale + shift) is rederived from x. The
// effective cotangent dce = dc + ds + 2·c·dq folds the statistics into the
// output's cotangent and is computed as dc and c are staged, never stored
// (but as dres, where the forward added a residual).
//
// Bound on an H100: operations, twice the forward's 2·B·H'W'·N·K·taps FLOP,
// in float32 on the CUDA cores. The TPU runs one kernel over (K/bk, B) and
// carries dw across the batch sweep in VMEM. GPU blocks run in no order, so
// the work is split by who owns each output, as the flash backward is split
// into dq and dk/dv:
// - dgrad (a block owns 64 input channels by 64 positions of one image):
//   da[k, p] = Σ_t Σ_n W[n, k, t] · dce[n, p − s_t], the exact transpose of
//   the forward's shifted reads: the same implicit GEMM (conv_bn.cuh) over a
//   staged dce chunk with the taps flipped. Then the prologue's backward:
//   da *= (xn > 0) with xn recomputed from x, dx = da·scale, and per-block
//   partial Σ da·x (dscale) and Σ da (dshift). A 1x1 stride-2 conv writes dx
//   at the sampled positions of the full grid; the caller zeroed the rest
//   (pallas_conv_bn.py:707-709).
// - wgrad (a block owns 64 output by 64 input channels of one tap and a
//   slice of the B·H'W' reduction): dw[n, k, t] = Σ dce[n, p]·xn[k, p + s_t],
//   each block writing a partial dw.
// - a fixed-order second pass adds the partial dw and dscale/dshift rows:
//   no atomics, so two runs give the same bits.
#include "conv_bn.cuh"

namespace {

using namespace mxt::convbn;

constexpr int kStep = 16;  // wgrad: output positions of one reduction step

__device__ __forceinline__ float prologue(float v, float sc, float sh, bool relu) {
  v = __fadd_rn(__fmul_rn(v, sc), sh);
  return relu ? fmaxf(v, 0.f) : v;
}

// dce = dc + ds + 2·c·dq, rounded as the plain version rounds it
__device__ __forceinline__ float dce_of(float dc, float c, float ds, float dq) {
  return __fadd_rn(__fadd_rn(dc, ds), __fmul_rn(2.f * c, dq));
}

template <int TAPS, bool PRO>
__global__ void __launch_bounds__(kThreads)
conv_bn_bwd_dgrad_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ scale, const float* __restrict__ shift,
                         const float* __restrict__ c, const float* __restrict__ dc,
                         const float* __restrict__ ds, const float* __restrict__ dq,
                         float* __restrict__ dx, float* __restrict__ part, Geo g, bool relu) {
  constexpr int XS = TAPS == 1 ? kTileP : kHalo;
  __shared__ __align__(16) float ws[kChunk * TAPS * kWRow];
  __shared__ __align__(16) float es[kChunk * XS];
  const int tid = threadIdx.x, tc = tid >> 4, tp = tid & 15;
  const int pt = blockIdx.x, k0 = blockIdx.y * kTileC, b = blockIdx.z;
  const int HWo = g.Ho * g.Wo;
  const size_t HW = static_cast<size_t>(g.H) * g.W;
  const size_t ob = static_cast<size_t>(b) * g.N * HWo;
  float acc[4][4] = {};
  for (int n0 = 0; n0 < g.N; n0 += kChunk) {
    // row nn * TAPS + t' holds W[n0 + nn][k0 .. k0 + 63][TAPS - 1 - t']: the
    // flipped tap, since da[p] takes dce[p - s_t] where c[o] took xn[o + s_t]
    for (int e = tid; e < kChunk * kTileC * TAPS; e += kThreads) {
      const int nn = e / (kTileC * TAPS), r = e - nn * (kTileC * TAPS);
      const int kk = r / TAPS, t = r - kk * TAPS;
      const int n = n0 + nn, k = k0 + kk;
      ws[(nn * TAPS + TAPS - 1 - t) * kWRow + kk] =
          n < g.N && k < g.K ? w[(static_cast<size_t>(n) * g.K + k0) * TAPS + r] : 0.f;
    }
    // the dce chunk; 0 outside the output grid
    for (int e = tid; e < kChunk * XS; e += kThreads) {
      const int nn = e / XS, j = e - nn * XS, n = n0 + nn;
      int oy, ox;
      float v = 0.f;
      if (n < g.N && staged_pos<TAPS>(g, pt, j, &oy, &ox)) {
        const size_t o = ob + static_cast<size_t>(n) * HWo + oy * g.Wo + ox;
        v = dce_of(dc[o], c[o], ds[n], dq[n]);
      }
      es[e] = v;
    }
    __syncthreads();
    mma_chunk<TAPS>(ws, es, acc, tc, tp);
    __syncthreads();
  }
  float sx[4] = {}, sh[4] = {};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int p = tile_pos<TAPS>(g, pt, tp, j);
    if (p < 0) continue;
    const int oy = p / g.Wo, ox = p - oy * g.Wo;
    const size_t src = static_cast<size_t>(oy * g.stride) * g.W + ox * g.stride;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + tc * 4 + i;
      if (k >= g.K) continue;
      const size_t xo = (static_cast<size_t>(b) * g.K + k) * HW + src;
      float da = acc[i][j];
      if (PRO) {
        const float xv = x[xo];
        if (relu && !(prologue(xv, scale[k], shift[k], false) > 0.f)) da = 0.f;
        dx[xo] = da * scale[k];
        sx[i] = fmaf(da, xv, sx[i]);
        sh[i] += da;
      } else {
        dx[xo] = da;
      }
    }
  }
  if (PRO) {
    const size_t row = static_cast<size_t>(b) * g.ptiles + pt;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = tile_row_sum(sx[i]), d = tile_row_sum(sh[i]);
      const int k = k0 + tc * 4 + i;
      if (tp == 0 && k < g.K) {
        part[(row * 2) * g.K + k] = a;
        part[(row * 2 + 1) * g.K + k] = d;
      }
    }
  }
}

template <int TAPS, bool PRO>
__global__ void __launch_bounds__(kThreads)
conv_bn_bwd_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                         const float* __restrict__ shift, const float* __restrict__ c,
                         const float* __restrict__ dc, const float* __restrict__ ds,
                         const float* __restrict__ dq, float* __restrict__ dw_part,
                         float* __restrict__ dres, Geo g, bool relu, int splits) {
  __shared__ __align__(16) float es[kStep * kWRow];  // es[r][nn]: dce
  __shared__ __align__(16) float xs[kStep * kWRow];  // xs[r][kk]: xn at tap t's source
  const int tid = threadIdx.x, tc = tid >> 4, tp = tid & 15;
  const int n0 = blockIdx.x * kTileC, t = blockIdx.y % TAPS, k0 = (blockIdx.y / TAPS) * kTileC;
  const int dy = TAPS == 1 ? 0 : t / 3 - 1, dx = TAPS == 1 ? 0 : t % 3 - 1;
  const int HWo = g.Ho * g.Wo;
  const size_t HW = static_cast<size_t>(g.H) * g.W;
  const int per_img = ceil_div(HWo, kStep), total = g.B * per_img;
  const int per = ceil_div(total, splits);
  const int s0 = blockIdx.z * per, s1 = min(total, s0 + per);
  // each dce value is staged by one block of tap 0 and input-channel tile 0
  const bool write_res = dres != nullptr && blockIdx.y == 0;
  float acc[4][4] = {};
  for (int s = s0; s < s1; ++s) {
    const int b = s / per_img, p0 = (s - b * per_img) * kStep;
    for (int e = tid; e < kStep * kTileC; e += kThreads) {
      const int nn = e / kStep, r = e - nn * kStep, n = n0 + nn, p = p0 + r;
      float v = 0.f;
      if (n < g.N && p < HWo) {
        const size_t o = (static_cast<size_t>(b) * g.N + n) * HWo + p;
        v = dce_of(dc[o], c[o], ds[n], dq[n]);
        if (write_res) dres[o] = v;
      }
      es[r * kWRow + nn] = v;
    }
    for (int e = tid; e < kStep * kTileC; e += kThreads) {
      const int kk = e / kStep, r = e - kk * kStep, k = k0 + kk, p = p0 + r;
      float v = 0.f;
      if (k < g.K && p < HWo) {
        const int oy = p / g.Wo, ox = p - oy * g.Wo;
        const int iy = oy * g.stride + dy, ix = ox * g.stride + dx;
        if (iy >= 0 && iy < g.H && ix >= 0 && ix < g.W) {
          const size_t k_off = static_cast<size_t>(b) * g.K + k;
          v = x[k_off * HW + static_cast<size_t>(iy) * g.W + ix];
          if (PRO) v = prologue(v, scale[k], shift[k], relu);
        }
      }
      xs[r * kWRow + kk] = v;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kStep; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(es + r * kWRow + tc * 4);
      const float4 b4 = *reinterpret_cast<const float4*>(xs + r * kWRow + tp * 4);
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
      fma4x4(acc, a, bv);
    }
    __syncthreads();
  }
  float* out = dw_part + static_cast<size_t>(blockIdx.z) * g.N * g.K * TAPS;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + tc * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tp * 4 + j;
      if (n < g.N && k < g.K) out[(static_cast<size_t>(n) * g.K + k) * TAPS + t] = acc[i][j];
    }
  }
}

// The second pass: dw (splits rows) and (dscale, dshift) (parts rows).
__global__ void conv_bn_bwd_partials_sum(const float* __restrict__ part,
                                         float* __restrict__ out, int P, int C) {
  sum_rows(part, out, P, C);
}

template <int TAPS, bool PRO>
void launch(cudaStream_t st, const Geo& g, int splits, const float* x, const float* w,
            const float* scale, const float* shift, const float* c, const float* dc,
            const float* ds, const float* dq, float* dx, float* dw_part, float* dss_part,
            float* dres, bool relu) {
  const dim3 dgrid(g.ptiles, ceil_div(g.K, kTileC), g.B);
  conv_bn_bwd_dgrad_kernel<TAPS, PRO>
      <<<dgrid, kThreads, 0, st>>>(x, w, scale, shift, c, dc, ds, dq, dx, dss_part, g, relu);
  const dim3 wgrid(ceil_div(g.N, kTileC), ceil_div(g.K, kTileC) * TAPS, splits);
  conv_bn_bwd_wgrad_kernel<TAPS, PRO>
      <<<wgrid, kThreads, 0, st>>>(x, scale, shift, c, dc, ds, dq, dw_part, dres, g, relu,
                                   splits);
}

}  // namespace

// parts: the dscale/dshift partial rows the caller allocated (B · ptiles);
// splits: the wgrad blocks along the reduction (1 ..= 65535), dw_part holding
// splits rows of N·K·taps. dss (2, K) and dss_part are NULL without a
// prologue (scale == NULL), dres without a residual. A 1x1 stride-2 dx must
// come zeroed.
extern "C" int mxt_conv_bn_bwd(const float* x, const float* w, const float* scale,
                               const float* shift, const float* c, const float* dc,
                               const float* ds, const float* dq, float* dx, float* dw,
                               float* dw_part, float* dss, float* dss_part, float* dres, int B,
                               int K, int H, int W, int N, int taps, int stride, int relu,
                               int parts, int splits, void* stream) {
  const bool pro = scale != nullptr;
  if (!valid_call(B, K, H, W, N, taps, stride) || (shift != nullptr) != pro ||
      (dss != nullptr) != pro || (dss_part != nullptr) != pro || splits < 1 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geo g = make_geo(B, K, H, W, N, taps, stride);
  if (parts != B * g.ptiles) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (taps == 1) {
    if (pro) launch<1, true>(st, g, splits, x, w, scale, shift, c, dc, ds, dq, dx, dw_part,
                             dss_part, dres, relu);
    else launch<1, false>(st, g, splits, x, w, scale, shift, c, dc, ds, dq, dx, dw_part,
                          dss_part, dres, relu);
  } else {
    if (pro) launch<9, true>(st, g, splits, x, w, scale, shift, c, dc, ds, dq, dx, dw_part,
                             dss_part, dres, relu);
    else launch<9, false>(st, g, splits, x, w, scale, shift, c, dc, ds, dq, dx, dw_part,
                          dss_part, dres, relu);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid, block;
  const int C = N * K * taps;
  sum_rows_shape(splits, C, &grid, &block);
  conv_bn_bwd_partials_sum<<<grid, block, 0, st>>>(dw_part, dw, splits, C);
  if (pro) {
    sum_rows_shape(parts, 2 * K, &grid, &block);
    conv_bn_bwd_partials_sum<<<grid, block, 0, st>>>(dss_part, dss, parts, 2 * K);
  }
  return static_cast<int>(cudaGetLastError());
}
