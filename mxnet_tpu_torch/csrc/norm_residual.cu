// LayerNorm + affine forward over rows, one warp per row.
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
