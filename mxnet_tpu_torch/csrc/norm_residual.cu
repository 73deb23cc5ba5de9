// LayerNorm + affine over rows, forward and backward, one warp per row.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_norm_residual.py _fwd_kernel
// (launched by _fwd_call): y = (x - mean) * rstd * gamma + beta over the last
// axis, with the per-row mean and rstd written beside y.
//
// Bound on an H100: bytes. Per row it reads D floats and writes D + 2, with
// about 8 operations per element, far below the card's operations-per-byte
// line. The design reads x once: a warp holds its row in registers (D / 32
// values a lane, 16 at D = 512), takes the mean and then the variance of the
// centred values from those registers (two passes, no E[x^2] - E[x]^2
// cancellation), and writes y once. Loads and stores are coalesced: lane l
// touches columns l, l + 32, ... Rows are independent, so any R works and the
// grid is R / 4 blocks of four warps.
//
// Backward, mxt_layer_norm_bwd: replaces the TPU kernel _bwd_kernel
// (launched by _bwd_call): dx = rstd·(dx̂ − mean(dx̂) − x̂·mean(dx̂∘x̂)) with
// dx̂ = dy∘γ, and dγ = Σ dy∘x̂, dβ = Σ dy over the rows. Also bound by bytes:
// it reads x and dy once and writes dx once. Two launches. The first,
// layer_norm_bwd_kernel, writes dx and one partial [dγ | dβ] row a block (the
// TPU kernel's per-block partials): a warp owns a row in registers,
// recomputes x̂ from the saved mean and rstd, and takes the two row means as
// warp reductions; a block owns 16 rows, each lane adds its columns' dγ, dβ
// terms over the rows its warp takes, and the block adds its four warps'
// sums in shared memory in a fixed order. The second, layer_norm_bwd_sums_kernel,
// adds the R / 16 partial rows (which the TPU path sums in XLA) column by
// column in a fixed order (common.cuh's sum_rows, as the other kernels'
// partial rows). Nothing is atomic, so the sums, and so the result, are the
// same run to run.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

template <int VPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
layer_norm_fwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, float* __restrict__ y,
                      float* __restrict__ mean_out, float* __restrict__ rstd_out,
                      int R, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;
  const float* xr = x + row * D;
  float v[VPL];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < D ? xr[c] : 0.f;
    s += v[i];
  }
  const float mean = mxt::warp_sum(s) / static_cast<float>(D);
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    const float d = c < D ? v[i] - mean : 0.f;
    v[i] = d;
    q += d * d;
  }
  const float var = mxt::warp_sum(q) / static_cast<float>(D);
  const float rstd = 1.f / sqrtf(var + eps);
  float* yr = y + row * D;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c < D) yr[c] = v[i] * rstd * gamma[c] + beta[c];
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// Backward: rows_per_block rows per block of kBwdWarps warps, each warp a
// row at a time, and one partial row of 2·D per block: its dgamma, then its
// dbeta.
constexpr int kBwdWarps = 4, kBwdRowsPerBlock = 16, kMaxD = 1024;

template <int VPL>
__global__ void __launch_bounds__(kBwdWarps * 32)
layer_norm_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ mean, const float* __restrict__ rstd,
                      const float* __restrict__ dy, float* __restrict__ dx,
                      float* __restrict__ part, int R, int D) {
  // sized for the widest D this instance takes (32·VPL columns)
  __shared__ float red_g[kBwdWarps * 32 * VPL], red_b[kBwdWarps * 32 * VPL];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float g[VPL], dg[VPL], db[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    g[i] = c < D ? gamma[c] : 0.f;
    dg[i] = db[i] = 0.f;
  }
  const long long row0 = static_cast<long long>(blockIdx.x) * kBwdRowsPerBlock;
  for (int rr = warp; rr < kBwdRowsPerBlock; rr += kBwdWarps) {
    const long long row = row0 + rr;
    if (row >= R) break;  // warp-uniform
    const float mu = mean[row], rs = rstd[row];
    const float* xr = x + row * D;
    const float* dyr = dy + row * D;
    float xh[VPL], dxh[VPL];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      xh[i] = dxh[i] = 0.f;
      if (c < D) {
        const float d = dyr[c];
        xh[i] = (xr[c] - mu) * rs;
        dxh[i] = d * g[i];
        dg[i] += d * xh[i];
        db[i] += d;
        s1 += dxh[i];
        s2 += dxh[i] * xh[i];
      }
    }
    const float m1 = mxt::warp_sum(s1) / static_cast<float>(D);
    const float m2 = mxt::warp_sum(s2) / static_cast<float>(D);
    float* dxr = dx + row * D;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      if (c < D) dxr[c] = rs * (dxh[i] - m1 - xh[i] * m2);
    }
  }
  // the block's partial row: its warps' sums added in a fixed order
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c < D) {
      red_g[warp * D + c] = dg[i];
      red_b[warp * D + c] = db[i];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += kBwdWarps * 32) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) {
      a += red_g[w * D + c];
      b += red_b[w * D + c];
    }
    part[static_cast<size_t>(2 * blockIdx.x) * D + c] = a;
    part[static_cast<size_t>(2 * blockIdx.x + 1) * D + c] = b;
  }
}

// [dgamma | dbeta] = Σ over the P blocks' partial rows of 2·D (sum_rows).
__global__ void layer_norm_bwd_sums_kernel(const float* __restrict__ part,
                                           float* __restrict__ sums, int P, int C) {
  mxt::sum_rows(part, sums, P, C);
}

}  // namespace

extern "C" int mxt_layer_norm_fwd(const float* x, const float* gamma, const float* beta,
                                  float* y, float* mean, float* rstd, int R, int D,
                                  float eps, void* stream) {
  if (R < 1 || D < 1 || D > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((R + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 128) {
    layer_norm_fwd_kernel<4><<<grid, block, 0, st>>>(x, gamma, beta, y, mean, rstd, R, D, eps);
  } else if (D <= 256) {
    layer_norm_fwd_kernel<8><<<grid, block, 0, st>>>(x, gamma, beta, y, mean, rstd, R, D, eps);
  } else if (D <= 512) {
    layer_norm_fwd_kernel<16><<<grid, block, 0, st>>>(x, gamma, beta, y, mean, rstd, R, D, eps);
  } else {
    layer_norm_fwd_kernel<32><<<grid, block, 0, st>>>(x, gamma, beta, y, mean, rstd, R, D, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// part: (ceil(R / 16), 2, D) scratch the caller allocated; sums: (2, D), row 0
// dgamma and row 1 dbeta.
extern "C" int mxt_layer_norm_bwd(const float* x, const float* gamma, const float* mean,
                                  const float* rstd, const float* dy, float* dx, float* part,
                                  float* sums, int R, int D, int rows_per_block,
                                  void* stream) {
  if (R < 1 || D < 1 || D > kMaxD || rows_per_block != kBwdRowsPerBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (R + kBwdRowsPerBlock - 1) / kBwdRowsPerBlock;
  const dim3 block(kBwdWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 128) {
    layer_norm_bwd_kernel<4><<<nb, block, 0, st>>>(x, gamma, mean, rstd, dy, dx, part, R, D);
  } else if (D <= 256) {
    layer_norm_bwd_kernel<8><<<nb, block, 0, st>>>(x, gamma, mean, rstd, dy, dx, part, R, D);
  } else if (D <= 512) {
    layer_norm_bwd_kernel<16><<<nb, block, 0, st>>>(x, gamma, mean, rstd, dy, dx, part, R, D);
  } else {
    layer_norm_bwd_kernel<32><<<nb, block, 0, st>>>(x, gamma, mean, rstd, dy, dx, part, R, D);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 sgrid, sblock;
  mxt::sum_rows_shape(nb, 2 * D, &sgrid, &sblock);
  layer_norm_bwd_sums_kernel<<<sgrid, sblock, 0, st>>>(part, sums, nb, 2 * D);
  return static_cast<int>(cudaGetLastError());
}
