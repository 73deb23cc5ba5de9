// Fused conv + BatchNorm forward: c = conv(relu(x·scale + shift), w) [+ res],
// with the per-channel f32 Σc and Σc² of the result.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_conv_bn.py _kernel (:240),
// launched by _conv_block_fwd_impl (:301, pallas_call :373). x is NCHW
// (B, K, H, W), w OIHW (N, K, 1|3, 1|3): a 1x1 kernel of stride 1 or 2, or a
// 3x3 kernel of stride 1 and pad 1. scale, shift (K,) and res (B, N, H', W')
// are optional (NULL).
//
// Bound on an H100: operations, 2·B·H'W'·N·K·taps FLOP, in float32 on the
// CUDA cores (TF32 off, as for the port's other kernels), against one read
// of x, w, res and one write of c. The design is an implicit GEMM: a block
// owns a 64-channel by 64-position tile of one image (conv_bn.cuh) and loops
// over K in chunks of 8, staging the weight stripe and the input chunk in
// shared memory. What the TPU kernel keeps out of device memory stays out:
// - the prologue relu(x·scale + shift) is applied as x is staged, so the
//   normalised activation is never written (pallas_conv_bn.py:18-21); it
//   rounds the product and the sum each (no fused multiply-add), as the
//   plain version does, so the card and the CPU agree on which side of the
//   ReLU each value falls;
// - a 3x3 kernel's 9 taps are shifted reads of one staged 10 x 10 chunk;
// - the residual is added in the epilogue before the statistics
//   (pallas_conv_bn.py:285-290), and each block writes its per-channel
//   partial Σc, Σc² from the f32 accumulators. The TPU carries the sums
//   across a sequential batch sweep in VMEM; GPU blocks run in no order, so
//   a second pass in this file adds the partial rows in a fixed order, with
//   no atomics, and two runs give the same bits.
// The inference variant (part == NULL) drops the statistics entirely.
#include "conv_bn.cuh"

namespace {

using namespace mxt::convbn;

template <int TAPS, bool PRO, bool STATS>
__global__ void __launch_bounds__(kThreads)
conv_bn_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ scale, const float* __restrict__ shift,
                   const float* __restrict__ res, float* __restrict__ c,
                   float* __restrict__ part, Geo g, bool relu) {
  constexpr int XS = TAPS == 1 ? kTileP : kHalo;
  __shared__ __align__(16) float ws[kChunk * TAPS * kWRow];
  __shared__ __align__(16) float xs[kChunk * XS];
  const int tid = threadIdx.x, tc = tid >> 4, tp = tid & 15;
  const int pt = blockIdx.x, n0 = blockIdx.y * kTileC, b = blockIdx.z;
  const size_t HW = static_cast<size_t>(g.H) * g.W;
  const int HWo = g.Ho * g.Wo;
  const float* xb = x + static_cast<size_t>(b) * g.K * HW;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < g.K; k0 += kChunk) {
    // the weight stripe: row kk * TAPS + t holds w[n0 .. n0 + 63][k0 + kk][t]
    for (int e = tid; e < kTileC * kChunk * TAPS; e += kThreads) {
      const int nn = e / (kChunk * TAPS), r = e - nn * (kChunk * TAPS);
      const int n = n0 + nn;
      ws[r * kWRow + nn] = n < g.N ? w[(static_cast<size_t>(n) * g.K + k0) * TAPS + r] : 0.f;
    }
    // the input chunk through the prologue; 0 outside the image
    for (int e = tid; e < kChunk * XS; e += kThreads) {
      const int kk = e / XS, j = e - kk * XS;
      int oy, ox;
      float v = 0.f;
      if (staged_pos<TAPS>(g, pt, j, &oy, &ox)) {
        const int k = k0 + kk;
        v = xb[k * HW + static_cast<size_t>(oy * g.stride) * g.W + ox * g.stride];
        if (PRO) {
          v = __fadd_rn(__fmul_rn(v, scale[k]), shift[k]);
          if (relu) v = fmaxf(v, 0.f);
        }
      }
      xs[e] = v;
    }
    __syncthreads();
    mma_chunk<TAPS>(ws, xs, acc, tc, tp);
    __syncthreads();
  }
  float s[4] = {}, q[4] = {};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int p = tile_pos<TAPS>(g, pt, tp, j);
    if (p < 0) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + tc * 4 + i;
      if (n >= g.N) continue;
      const size_t o = (static_cast<size_t>(b) * g.N + n) * HWo + p;
      float v = acc[i][j];
      if (res != nullptr) v += res[o];
      c[o] = v;
      if (STATS) {
        s[i] += v;
        q[i] = fmaf(v, v, q[i]);
      }
    }
  }
  if (STATS) {
    const size_t row = static_cast<size_t>(b) * g.ptiles + pt;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float si = tile_row_sum(s[i]), qi = tile_row_sum(q[i]);
      const int n = n0 + tc * 4 + i;
      if (tp == 0 && n < g.N) {
        part[(row * 2) * g.N + n] = si;
        part[(row * 2 + 1) * g.N + n] = qi;
      }
    }
  }
}

// The statistics' second pass: (ssum, ssq) = Σ over the partial rows.
__global__ void conv_bn_fwd_stats_sum(const float* __restrict__ part, float* __restrict__ out,
                                      int P, int C) {
  sum_rows(part, out, P, C);
}

template <int TAPS, bool PRO>
void launch(bool stats, dim3 grid, cudaStream_t st, const float* x, const float* w,
            const float* scale, const float* shift, const float* res, float* c, float* part,
            const Geo& g, bool relu) {
  if (stats)
    conv_bn_fwd_kernel<TAPS, PRO, true>
        <<<grid, kThreads, 0, st>>>(x, w, scale, shift, res, c, part, g, relu);
  else
    conv_bn_fwd_kernel<TAPS, PRO, false>
        <<<grid, kThreads, 0, st>>>(x, w, scale, shift, res, c, part, g, relu);
}

}  // namespace

// parts: the partial rows the caller allocated (B · ptiles), checked here.
extern "C" int mxt_conv_bn_fwd(const float* x, const float* w, const float* scale,
                               const float* shift, const float* res, float* c, float* part,
                               float* sums, int B, int K, int H, int W, int N, int taps,
                               int stride, int relu, int parts, void* stream) {
  if (!valid_call(B, K, H, W, N, taps, stride) || (scale == nullptr) != (shift == nullptr) ||
      (part == nullptr) != (sums == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geo g = make_geo(B, K, H, W, N, taps, stride);
  const bool stats = part != nullptr, pro = scale != nullptr;
  if (stats && parts != B * g.ptiles) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(g.ptiles, ceil_div(N, kTileC), B);
  if (taps == 1) {
    if (pro) launch<1, true>(stats, grid, st, x, w, scale, shift, res, c, part, g, relu);
    else launch<1, false>(stats, grid, st, x, w, scale, shift, res, c, part, g, relu);
  } else {
    if (pro) launch<9, true>(stats, grid, st, x, w, scale, shift, res, c, part, g, relu);
    else launch<9, false>(stats, grid, st, x, w, scale, shift, res, c, part, g, relu);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !stats) return static_cast<int>(err);
  dim3 sgrid, sblock;
  sum_rows_shape(parts, 2 * N, &sgrid, &sblock);
  conv_bn_fwd_stats_sum<<<sgrid, sblock, 0, st>>>(part, sums, parts, 2 * N);
  return static_cast<int>(cudaGetLastError());
}
