// Helpers shared by the port's CUDA kernels (plain C interface, sm_90a).
#pragma once

#include <cuda_runtime.h>

namespace mxt {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// Threads of a sum_rows block.
constexpr int kSumThreads = 256;

// out[col] = Σ_{p < P} part[p · C + col] in a fixed order: lane l of a column
// adds rows l, l + L, l + 2L, ..., then lane 0 adds the L lane sums in order.
// No atomics, so two runs give the same bits. Block (256 / L, L), from
// sum_rows_shape; each kernel that finishes its partial rows calls it.
__device__ __forceinline__ void sum_rows(const float* __restrict__ part,
                                         float* __restrict__ out, int P, int C) {
  __shared__ float red[kSumThreads];
  const int cols = blockDim.x, L = blockDim.y;
  const int col = blockIdx.x * cols + threadIdx.x;
  float s = 0.f;
  if (col < C)
    for (int p = threadIdx.y; p < P; p += L) s += part[static_cast<size_t>(p) * C + col];
  red[threadIdx.y * cols + threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < C) {
    float t = 0.f;
    for (int l = 0; l < L; ++l) t += red[l * cols + threadIdx.x];
    out[col] = t;
  }
}

// The launch shape of sum_rows for P rows of C columns.
inline void sum_rows_shape(int P, int C, dim3* grid, dim3* block) {
  const int L = P >= 64 ? 16 : (P >= 8 ? 4 : 1), cols = kSumThreads / L;
  *block = dim3(cols, L);
  *grid = dim3((C + cols - 1) / cols);
}

// The dynamic shared memory a kernel needs above 48 KB, raised once a process.
template <typename Kernel>
inline cudaError_t raise_smem(Kernel kernel, int bytes, bool* raised) {
  if (*raised) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err == cudaSuccess) *raised = true;
  return err;
}

}  // namespace mxt
