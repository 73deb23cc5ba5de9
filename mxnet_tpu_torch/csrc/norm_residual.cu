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
// The bf16 form, mxt_layer_norm_fwd_bf16: the same TPU kernel on bf16 x,
// gamma and beta (KVCacheDecoder(dtype='bfloat16')'s 2L + 1 LayerNorms a
// prefill and a step). It is this kernel over bf16 storage: a lane loads its
// 4 adjacent bf16 columns as 8 bytes and widens them (_fwd_kernel :79),
// the statistics and the affine are f32 (:80-86), y is rounded to bf16 once,
// to nearest even (:87), and mean and rstd stay f32. The affine is one FMA,
// fma(x̂, γ, β) with x̂ = (x − mean)·rstd rounded, as XLA compiles JAX's
// ``xhat * g + b`` (on f32 rows every y of the interpreted TPU kernel is the
// FMA, and many differ from two roundings: tests/test_torch_serve_lm_bf16.py
// test_the_pallas_layer_norm_affine_is_one_fma). Bound: bytes, half the f32
// form's.
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
//
// The backward's bf16 form, mxt_layer_norm_bwd_bf16: the same TPU kernel on
// bf16 x, dy and gamma (SPMDTrainer(compute_dtype='bfloat16')'s 2L + 1
// LayerNorms a step), mean and rstd f32. layer_norm_bwd_bf16_kernel takes the
// forward's layout, a lane's 4 adjacent bf16 columns as 8 bytes widened; the
// arithmetic is f32 and dx is rounded to bf16 once (_bwd_kernel :105). The
// partial rows stay f32, and layer_norm_bwd_bf16_sums_kernel adds them in the
// same fixed order and rounds dγ and dβ once to bf16, gamma's dtype (_ln_bwd
// :189). Whether XLA fuses the TPU kernel's ``rstd * (dxhat - m1 - xhat *
// m2)`` into an FMA cannot be told on the CPU: the row means' f32 sums,
// taken in another order, move dx more than the FMA does, jit or op by op,
// and rounded to bf16 the two differ in about one element in 10^4, by one
// ulp; the kernel contracts as nvcc does by default. Bound: bytes, x and dy
// read and dx written at 2 B an element, ~6.3 MB at the training step's
// (2048, 512) (~1.9 µs at 3.35 TB/s), ~2.0 µs with the partial rows.
#include <cstdint>

#include "bf16_mma.cuh"
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

// 4 adjacent values from p at column c (< D where taken), widened to f32,
// zeros past D
template <bool VEC, typename T>
__device__ __forceinline__ void load4(const T* __restrict__ p, int c, int D, bool live,
                                      float (&v)[4]) {
  if (VEC) {
    const float4 q = live && c < D ? mxt::ldg4(p + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = live && c + j < D ? mxt::ldg1(p + c + j) : 0.f;
  }
}

// CH: 128-column chunks a row (D <= 128·CH); RPW: rows a warp; VEC: D % 4
// == 0 and x, gamma, beta, y aligned to 4 elements (16 bytes of f32, 8 of
// bf16). T: the storage of x, gamma, beta and y, float or __nv_bfloat16.
template <typename T, int CH, int RPW, bool VEC>
__device__ __forceinline__ void layer_norm_fwd_rows(const T* __restrict__ x,
                                                    const T* __restrict__ gamma,
                                                    const T* __restrict__ beta,
                                                    T* __restrict__ y,
                                                    float* __restrict__ mean_out,
                                                    float* __restrict__ rstd_out, int R, int D,
                                                    float eps) {
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
    T* yr = y + row * D;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = 128 * i + 4 * lane;
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (mxt::IsBf16<T>::value)
          o[j] = __fmaf_rn(__fmul_rn(v[r][i][j], rs), gv[i][j], bv[i][j]);
        else
          o[j] = v[r][i][j] * rs * gv[i][j] + bv[i][j];
      }
      if (VEC) {
        if (c < D) mxt::st4(yr + c, make_float4(o[0], o[1], o[2], o[3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < D) mxt::st1(yr + c + j, o[j]);
      }
    }
    if (lane == 0) {
      mean_out[row] = mean[r];
      rstd_out[row] = rs;
    }
  }
}

// The f32 kernel and the bf16 form, under names of their own (the profiler
// attributes device time by name).
template <int CH, int RPW, bool VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
layer_norm_fwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, float* __restrict__ y,
                      float* __restrict__ mean_out, float* __restrict__ rstd_out, int R, int D,
                      float eps) {
  layer_norm_fwd_rows<float, CH, RPW, VEC>(x, gamma, beta, y, mean_out, rstd_out, R, D, eps);
}

template <int CH, int RPW, bool VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
layer_norm_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ gamma,
                           const __nv_bfloat16* __restrict__ beta, __nv_bfloat16* __restrict__ y,
                           float* __restrict__ mean_out, float* __restrict__ rstd_out, int R,
                           int D, float eps) {
  layer_norm_fwd_rows<__nv_bfloat16, CH, RPW, VEC>(x, gamma, beta, y, mean_out, rstd_out, R, D,
                                                   eps);
}

template <int CH, int RPW, bool VEC>
void launch_one(const float* x, const float* gamma, const float* beta, float* y, float* mean,
                float* rstd, int R, int D, float eps, dim3 grid, dim3 block, cudaStream_t st) {
  layer_norm_fwd_kernel<CH, RPW, VEC><<<grid, block, 0, st>>>(x, gamma, beta, y, mean, rstd, R,
                                                              D, eps);
}

template <int CH, int RPW, bool VEC>
void launch_one(const __nv_bfloat16* x, const __nv_bfloat16* gamma, const __nv_bfloat16* beta,
                __nv_bfloat16* y, float* mean, float* rstd, int R, int D, float eps, dim3 grid,
                dim3 block, cudaStream_t st) {
  layer_norm_fwd_bf16_kernel<CH, RPW, VEC><<<grid, block, 0, st>>>(x, gamma, beta, y, mean,
                                                                   rstd, R, D, eps);
}

template <int CH, int RPW, typename T>
void launch_fwd(const T* x, const T* gamma, const T* beta, T* y, float* mean, float* rstd,
                int R, int D, float eps, bool vec, cudaStream_t st) {
  const int rows_per_block = kWarpsPerBlock * RPW;
  const dim3 grid((R + rows_per_block - 1) / rows_per_block), block(kWarpsPerBlock * 32);
  if (vec)
    launch_one<CH, RPW, true>(x, gamma, beta, y, mean, rstd, R, D, eps, grid, block, st);
  else
    launch_one<CH, RPW, false>(x, gamma, beta, y, mean, rstd, R, D, eps, grid, block, st);
}

// The forward's launch for either storage: rows_per_warp 1, or 2 for
// D <= 512 (ops/norm_residual.py _rows_per_warp).
template <typename T>
int layer_norm_fwd(const T* x, const T* gamma, const T* beta, T* y, float* mean, float* rstd,
                   int R, int D, int rows_per_warp, float eps, void* stream) {
  if (R < 1 || D < 1 || D > 1024 || rows_per_warp < 1 || rows_per_warp > (D <= 512 ? 2 : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  // 4 elements a load and a store: 16 bytes of f32, 8 of bf16
  auto aligned = [](const T* p) { return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0; };
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

// The bf16 form of layer_norm_bwd_kernel: x, gamma, dy and dx bf16, mean,
// rstd and the partial rows f32. A lane holds the 4 adjacent columns 128i +
// 4l .. 128i + 4l + 3 of each 128-column chunk i (CH chunks, D <= 128·CH),
// loaded as 8 bytes and widened, as the bf16 forward does (VEC: D % 4 == 0
// and x, gamma, dy, dx aligned to 8 bytes; else 2-byte loads in the same
// layout). The arithmetic is layer_norm_bwd_kernel's, in f32, and dx is
// rounded to bf16 once, to nearest even (_bwd_kernel :105). A block's partial
// row is that kernel's: its warps' column sums added in a fixed order.
template <int CH, bool VEC>
__global__ void __launch_bounds__(kBwdWarps * 32)
layer_norm_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ gamma,
                           const float* __restrict__ mean, const float* __restrict__ rstd,
                           const __nv_bfloat16* __restrict__ dy, __nv_bfloat16* __restrict__ dx,
                           float* __restrict__ part, int R, int D) {
  __shared__ float red_g[kBwdWarps * 128 * CH], red_b[kBwdWarps * 128 * CH];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float g[CH][4], dg[CH][4], db[CH][4];
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    load4<VEC>(gamma, 128 * i + 4 * lane, D, true, g[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) dg[i][j] = db[i][j] = 0.f;
  }
  const long long row0 = static_cast<long long>(blockIdx.x) * kBwdRowsPerBlock;
  for (int rr = warp; rr < kBwdRowsPerBlock; rr += kBwdWarps) {
    const long long row = row0 + rr;
    if (row >= R) break;  // warp-uniform
    const float mu = mean[row], rs = rstd[row];
    float xv[CH][4], dv[CH][4];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      load4<VEC>(x + row * D, 128 * i + 4 * lane, D, true, xv[i]);
      load4<VEC>(dy + row * D, 128 * i + 4 * lane, D, true, dv[i]);
    }
    float xh[CH][4], dxh[CH][4];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < CH; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        xh[i][j] = dxh[i][j] = 0.f;
        if (128 * i + 4 * lane + j < D) {
          const float d = dv[i][j];
          xh[i][j] = (xv[i][j] - mu) * rs;
          dxh[i][j] = d * g[i][j];
          dg[i][j] += d * xh[i][j];
          db[i][j] += d;
          s1 += dxh[i][j];
          s2 += dxh[i][j] * xh[i][j];
        }
      }
    const float m1 = mxt::warp_sum(s1) / static_cast<float>(D);
    const float m2 = mxt::warp_sum(s2) / static_cast<float>(D);
    __nv_bfloat16* dxr = dx + row * D;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = 128 * i + 4 * lane;
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = rs * (dxh[i][j] - m1 - xh[i][j] * m2);
      if (VEC) {
        if (c < D) mxt::st4(dxr + c, make_float4(o[0], o[1], o[2], o[3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < D) mxt::st1(dxr + c + j, o[j]);
      }
    }
  }
  // the block's partial row: its warps' sums added in a fixed order
#pragma unroll
  for (int i = 0; i < CH; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 128 * i + 4 * lane + j;
      if (c < D) {
        red_g[warp * D + c] = dg[i][j];
        red_b[warp * D + c] = db[i][j];
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

// The bf16 form's: the same f32 sums, rounded once to bf16 (_ln_bwd :189's
// cast to gamma's dtype).
__global__ void layer_norm_bwd_bf16_sums_kernel(const float* __restrict__ part,
                                                __nv_bfloat16* __restrict__ sums, int P, int C) {
  mxt::sum_rows(part, sums, P, C);
}

void launch_sums(const float* part, float* sums, int P, int C, dim3 grid, dim3 block,
                 cudaStream_t st) {
  layer_norm_bwd_sums_kernel<<<grid, block, 0, st>>>(part, sums, P, C);
}

void launch_sums(const float* part, __nv_bfloat16* sums, int P, int C, dim3 grid, dim3 block,
                 cudaStream_t st) {
  layer_norm_bwd_bf16_sums_kernel<<<grid, block, 0, st>>>(part, sums, P, C);
}

// The backward's two launches for either storage: the rows' kernel (T =
// float: layer_norm_bwd_kernel; T = __nv_bfloat16: its bf16 form), then the
// partial rows' sums into sums (2, D) of T.
void launch_bwd_rows(const float* x, const float* gamma, const float* mean, const float* rstd,
                     const float* dy, float* dx, float* part, int R, int D, int nb,
                     cudaStream_t st) {
  const dim3 block(kBwdWarps * 32);
  if (D <= 128) {
    layer_norm_bwd_kernel<4><<<nb, block, 0, st>>>(x, gamma, mean, rstd, dy, dx, part, R, D);
  } else if (D <= 256) {
    layer_norm_bwd_kernel<8><<<nb, block, 0, st>>>(x, gamma, mean, rstd, dy, dx, part, R, D);
  } else if (D <= 512) {
    layer_norm_bwd_kernel<16><<<nb, block, 0, st>>>(x, gamma, mean, rstd, dy, dx, part, R, D);
  } else {
    layer_norm_bwd_kernel<32><<<nb, block, 0, st>>>(x, gamma, mean, rstd, dy, dx, part, R, D);
  }
}

template <int CH>
void launch_bwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* gamma, const float* mean,
                     const float* rstd, const __nv_bfloat16* dy, __nv_bfloat16* dx, float* part,
                     int R, int D, int nb, bool vec, cudaStream_t st) {
  const dim3 block(kBwdWarps * 32);
  if (vec)
    layer_norm_bwd_bf16_kernel<CH, true><<<nb, block, 0, st>>>(x, gamma, mean, rstd, dy, dx,
                                                              part, R, D);
  else
    layer_norm_bwd_bf16_kernel<CH, false><<<nb, block, 0, st>>>(x, gamma, mean, rstd, dy, dx,
                                                               part, R, D);
}

void launch_bwd_rows(const __nv_bfloat16* x, const __nv_bfloat16* gamma, const float* mean,
                     const float* rstd, const __nv_bfloat16* dy, __nv_bfloat16* dx, float* part,
                     int R, int D, int nb, cudaStream_t st) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 8 == 0; };
  const bool vec = D % 4 == 0 && aligned(x) && aligned(gamma) && aligned(dy) && aligned(dx);
  if (D <= 128) launch_bwd_bf16<1>(x, gamma, mean, rstd, dy, dx, part, R, D, nb, vec, st);
  else if (D <= 256) launch_bwd_bf16<2>(x, gamma, mean, rstd, dy, dx, part, R, D, nb, vec, st);
  else if (D <= 512) launch_bwd_bf16<4>(x, gamma, mean, rstd, dy, dx, part, R, D, nb, vec, st);
  else launch_bwd_bf16<8>(x, gamma, mean, rstd, dy, dx, part, R, D, nb, vec, st);
}

template <typename T>
int layer_norm_bwd(const T* x, const T* gamma, const float* mean, const float* rstd,
                   const T* dy, T* dx, float* part, T* sums, int R, int D, int rows_per_block,
                   void* stream) {
  if (R < 1 || D < 1 || D > kMaxD || rows_per_block != kBwdRowsPerBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (R + kBwdRowsPerBlock - 1) / kBwdRowsPerBlock;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  launch_bwd_rows(x, gamma, mean, rstd, dy, dx, part, R, D, nb, st);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 sgrid, sblock;
  mxt::sum_rows_shape(nb, 2 * D, &sgrid, &sblock);
  launch_sums(part, sums, nb, 2 * D, sgrid, sblock, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows_per_warp: 1, or 2 for D <= 512 (ops/norm_residual.py _rows_per_warp).
extern "C" int mxt_layer_norm_fwd(const float* x, const float* gamma, const float* beta,
                                  float* y, float* mean, float* rstd, int R, int D,
                                  int rows_per_warp, float eps, void* stream) {
  return layer_norm_fwd(x, gamma, beta, y, mean, rstd, R, D, rows_per_warp, eps, stream);
}

// The bf16 form: x, gamma, beta and y bf16; mean and rstd f32.
extern "C" int mxt_layer_norm_fwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* gamma,
                                       const __nv_bfloat16* beta, __nv_bfloat16* y,
                                       float* mean, float* rstd, int R, int D, int rows_per_warp,
                                       float eps, void* stream) {
  return layer_norm_fwd(x, gamma, beta, y, mean, rstd, R, D, rows_per_warp, eps, stream);
}

// part: (ceil(R / 16), 2, D) scratch the caller allocated; sums: (2, D), row 0
// dgamma and row 1 dbeta.
extern "C" int mxt_layer_norm_bwd(const float* x, const float* gamma, const float* mean,
                                  const float* rstd, const float* dy, float* dx, float* part,
                                  float* sums, int R, int D, int rows_per_block,
                                  void* stream) {
  return layer_norm_bwd(x, gamma, mean, rstd, dy, dx, part, sums, R, D, rows_per_block, stream);
}

// The bf16 form: x, gamma, dy, dx and sums bf16 (dgamma and dbeta rounded once
// from the f32 sums); mean, rstd and part f32.
extern "C" int mxt_layer_norm_bwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* gamma,
                                       const float* mean, const float* rstd,
                                       const __nv_bfloat16* dy, __nv_bfloat16* dx, float* part,
                                       __nv_bfloat16* sums, int R, int D, int rows_per_block,
                                       void* stream) {
  return layer_norm_bwd(x, gamma, mean, rstd, dy, dx, part, sums, R, D, rows_per_block, stream);
}
