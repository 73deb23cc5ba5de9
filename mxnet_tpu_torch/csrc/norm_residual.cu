// LayerNorm + affine over rows, forward and backward.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_norm_residual.py _fwd_kernel
// (launched by _fwd_call): y = (x - mean) * rstd * gamma + beta over the last
// axis, with the per-row mean and rstd written beside y.
//
// Bound on an H100: bytes. Per row it reads D floats and writes D + 2, with
// about 8 operations per element, far below the card's operations-per-byte
// line; at the decode's 8 rows of 512 the bound (16 KB, 11 ns) is far below
// what any launch costs, so there the kernel is judged against the card's
// launch floor (chip_smoke.py's launch_floor_ms). The design reads x once: a
// warp holds its row in registers, lane l the 4 adjacent columns 128i + 4l
// .. 128i + 4l + 3 of each 128-column chunk i, loaded and stored as float4
// (scalars only for a D that is no multiple of 4 or an operand that is not
// 16-byte aligned). Every load of a row, gamma's and beta's included, is
// issued before the first reduction. The mean, then the variance of the
// centred values held in registers (two passes, no E[x^2] - E[x]^2
// cancellation), each a warp reduction; y is written once. A warp takes one
// row, or two rows at once where R is large (the caller's rows_per_warp,
// ops/norm_residual.py _rows_per_warp): twice the loads in flight a warp and
// gamma and beta loaded once for both; blocks of four warps.
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
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

// v[r] = the sum of v[r] over the warp, the RPW reductions interleaved
template <int RPW>
__device__ __forceinline__ void warp_sums(float (&v)[RPW]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < RPW; ++r) v[r] += __shfl_xor_sync(mxt::kFullMask, v[r], o);
}

// 4 adjacent values from p at column c (< D where taken), zeros past D
template <bool VEC>
__device__ __forceinline__ void load4(const float* __restrict__ p, int c, int D, bool live,
                                      float (&v)[4]) {
  if (VEC) {
    const float4 q = live && c < D ? __ldg(reinterpret_cast<const float4*>(p + c))
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = live && c + j < D ? __ldg(p + c + j) : 0.f;
  }
}

// CH: 128-column chunks a row (D <= 128·CH); RPW: rows a warp; VEC: D % 4
// == 0 and x, gamma, beta, y 16-byte aligned.
template <int CH, int RPW, bool VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
layer_norm_fwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, float* __restrict__ y,
                      float* __restrict__ mean_out, float* __restrict__ rstd_out,
                      int R, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5)) * RPW;
  if (row0 >= R) return;
  float v[RPW][CH][4], gv[CH][4], bv[CH][4];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int i = 0; i < CH; ++i)
      load4<VEC>(x + (row0 + r) * D, 128 * i + 4 * lane, D, row0 + r < R, v[r][i]);
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    load4<VEC>(gamma, 128 * i + 4 * lane, D, true, gv[i]);
    load4<VEC>(beta, 128 * i + 4 * lane, D, true, bv[i]);
  }
  float mean[RPW], sq[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    mean[r] = 0.f;
#pragma unroll
    for (int i = 0; i < CH; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mean[r] += v[r][i][j];
  }
  warp_sums(mean);
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    mean[r] /= static_cast<float>(D);
    sq[r] = 0.f;
#pragma unroll
    for (int i = 0; i < CH; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = 128 * i + 4 * lane + j < D ? v[r][i][j] - mean[r] : 0.f;
        v[r][i][j] = d;
        sq[r] += d * d;
      }
  }
  warp_sums(sq);
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const long long row = row0 + r;
    if (row >= R) break;
    const float rs = 1.f / sqrtf(sq[r] / static_cast<float>(D) + eps);
    float* yr = y + row * D;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = 128 * i + 4 * lane;
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = v[r][i][j] * rs * gv[i][j] + bv[i][j];
      if (VEC) {
        if (c < D) *reinterpret_cast<float4*>(yr + c) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < D) yr[c + j] = o[j];
      }
    }
    if (lane == 0) {
      mean_out[row] = mean[r];
      rstd_out[row] = rs;
    }
  }
}

template <int CH, int RPW>
void launch_fwd(const float* x, const float* gamma, const float* beta, float* y, float* mean,
                float* rstd, int R, int D, float eps, bool vec, cudaStream_t st) {
  const int rows_per_block = kWarpsPerBlock * RPW;
  const dim3 grid((R + rows_per_block - 1) / rows_per_block), block(kWarpsPerBlock * 32);
  if (vec)
    layer_norm_fwd_kernel<CH, RPW, true><<<grid, block, 0, st>>>(x, gamma, beta, y, mean, rstd,
                                                                 R, D, eps);
  else
    layer_norm_fwd_kernel<CH, RPW, false><<<grid, block, 0, st>>>(x, gamma, beta, y, mean, rstd,
                                                                  R, D, eps);
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

// rows_per_warp: 1, or 2 for D <= 512 (ops/norm_residual.py _rows_per_warp).
extern "C" int mxt_layer_norm_fwd(const float* x, const float* gamma, const float* beta,
                                  float* y, float* mean, float* rstd, int R, int D,
                                  int rows_per_warp, float eps, void* stream) {
  if (R < 1 || D < 1 || D > 1024 || rows_per_warp < 1 || rows_per_warp > (D <= 512 ? 2 : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  auto aligned = [](const float* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = D % 4 == 0 && aligned(x) && aligned(gamma) && aligned(beta) && aligned(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool two = rows_per_warp == 2;
  if (D <= 128) {
    if (two) launch_fwd<1, 2>(x, gamma, beta, y, mean, rstd, R, D, eps, vec, st);
    else launch_fwd<1, 1>(x, gamma, beta, y, mean, rstd, R, D, eps, vec, st);
  } else if (D <= 256) {
    if (two) launch_fwd<2, 2>(x, gamma, beta, y, mean, rstd, R, D, eps, vec, st);
    else launch_fwd<2, 1>(x, gamma, beta, y, mean, rstd, R, D, eps, vec, st);
  } else if (D <= 512) {
    if (two) launch_fwd<4, 2>(x, gamma, beta, y, mean, rstd, R, D, eps, vec, st);
    else launch_fwd<4, 1>(x, gamma, beta, y, mean, rstd, R, D, eps, vec, st);
  } else {
    launch_fwd<8, 1>(x, gamma, beta, y, mean, rstd, R, D, eps, vec, st);
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
