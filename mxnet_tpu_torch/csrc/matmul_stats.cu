// C = A · B with the column sums of C and of C², f32, the sums taken from the
// f32 accumulators: the statistics a BatchNorm after a 1x1 convolution needs,
// without reading C again.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_matmul_stats.py _kernel (:47),
// launched by matmul_with_stats (:71, pallas_call :99). A is (M, K) and B is
// (K, N), both row-major; B is read as it lies, coalesced along N, and no
// transposed copy is made. col_sum and col_sumsq are (N,) f32.
//
// Bound on an H100: operations for ResNet-50's 1x1 convolutions at batch 32
// (2·M·K·N = 3.29 GFLOP each, in float32 on the CUDA cores: TF32 is off, as
// for the port's other kernels), except the widest and shallowest one,
// (100352, 64) · (64, 256), whose 103 MB of C make it nearly as much bound by
// bytes. The design is a shared-memory-tiled GEMM: a 256-thread block owns a
// 128 x 64 tile of C and walks K in slices of 16; each thread keeps an 8 x 4
// sub-tile in registers and reads its operands from shared memory as float4.
// The next slice is fetched into registers while the current one is
// multiplied. Ragged M, N and K are predicated (zeros are staged past the
// edge), so no shape is refused. When K or N is no multiple of 4 the loads
// of A or B fall back from float4 to scalars.
//
// The TPU kernel sweeps M in order and carries the column sums in VMEM
// scratch; CUDA blocks run in no order. So each block reduces its tile's
// columns (registers, one shuffle, then shared memory, always in the same
// order) into one row of an (m_tiles, 2, N) partial buffer, and a second
// kernel below adds the rows in a fixed order. No atomics: two runs give the
// same bits.
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 64, BK = 16, TM = 8, TN = 4;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256
constexpr int kPad = 4;                           // keeps rows 16-byte aligned
constexpr int kWarps = kThreads / 32;

// One thread's share of a (BM x BK) slice of A and a (BK x BN) slice of B.
struct Fetch {
  float4 a[2];
  float4 b;
};

template <bool VEC_A, bool VEC_B>
__device__ __forceinline__ Fetch fetch(const float* __restrict__ A, const float* __restrict__ B,
                                       int M, int N, int K, int m0, int n0, int k0, int tid) {
  Fetch f;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int idx = tid + kThreads * t;      // 512 float4 cover 128 rows x 16
    const int r = idx >> 2, c = (idx & 3) * 4;
    const int gm = m0 + r, gk = k0 + c;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (gm < M) {
      const float* p = A + static_cast<size_t>(gm) * K + gk;
      if (VEC_A && gk + 3 < K) {
        const float4 q = *reinterpret_cast<const float4*>(p);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (gk + i < K) v[i] = p[i];
      }
    }
    f.a[t] = make_float4(v[0], v[1], v[2], v[3]);
  }
  {
    const int r = tid >> 4, c = (tid & 15) * 4;  // 256 float4 cover 16 rows x 64
    const int gk = k0 + r, gn = n0 + c;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (gk < K) {
      const float* p = B + static_cast<size_t>(gk) * N + gn;
      if (VEC_B && gn + 3 < N) {
        const float4 q = *reinterpret_cast<const float4*>(p);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (gn + i < N) v[i] = p[i];
      }
    }
    f.b = make_float4(v[0], v[1], v[2], v[3]);
  }
  return f;
}

template <bool VEC_A, bool VEC_B>
__global__ void __launch_bounds__(kThreads)
matmul_stats_kernel(const float* __restrict__ A, const float* __restrict__ B,
                    float* __restrict__ C, float* __restrict__ part, int M, int N, int K) {
  __shared__ __align__(16) float As[BK][BM + kPad];  // A's slice, transposed
  __shared__ __align__(16) float Bs[BK][BN + kPad];
  __shared__ float red[2][kWarps][BN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // 16 column groups x 16 row groups
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  Fetch f = fetch<VEC_A, VEC_B>(A, B, M, N, K, m0, n0, 0, tid);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int idx = tid + kThreads * t;
      const int r = idx >> 2, c = (idx & 3) * 4;
      As[c + 0][r] = f.a[t].x;
      As[c + 1][r] = f.a[t].y;
      As[c + 2][r] = f.a[t].z;
      As[c + 3][r] = f.a[t].w;
    }
    *reinterpret_cast<float4*>(&Bs[tid >> 4][(tid & 15) * 4]) = f.b;
    __syncthreads();
    if (k0 + BK < K) f = fetch<VEC_A, VEC_B>(A, B, M, N, K, m0, n0, k0 + BK, tid);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // C, and this thread's column sums. Rows past M and columns past N hold
  // zeros (their operands were staged as zeros), so they add nothing.
  float s[TN] = {0.f, 0.f, 0.f, 0.f}, q[TN] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      s[j] += acc[i][j];
      q[j] = fmaf(acc[i][j], acc[i][j], q[j]);
    }
    if (gm >= M) continue;
    float* row = C + static_cast<size_t>(gm) * N + n0 + tx * TN;
    if (VEC_B && n0 + tx * TN + 3 < N) {
      *reinterpret_cast<float4*>(row) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (n0 + tx * TN + j < N) row[j] = acc[i][j];
    }
  }
  // a warp holds two row groups (ty, ty + 1) of the same 16 column groups:
  // add the pair, then the 8 warps through shared memory in warp order
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    s[j] += __shfl_xor_sync(mxt::kFullMask, s[j], 16);
    q[j] += __shfl_xor_sync(mxt::kFullMask, q[j], 16);
    if (lane < 16) {
      red[0][warp][tx * TN + j] = s[j];
      red[1][warp][tx * TN + j] = q[j];
    }
  }
  __syncthreads();
  if (tid < 2 * BN) {
    const int which = tid / BN, col = tid % BN;
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[which][w][col];
    if (n0 + col < N)
      part[(static_cast<size_t>(blockIdx.y) * 2 + which) * N + n0 + col] = t;
  }
}

// sums[c] = Σ_{p < P} part[p · C + c], c < C = 2N, in a fixed order (sum_rows).
__global__ void matmul_stats_sum_kernel(const float* __restrict__ part, float* __restrict__ sums,
                                        int P, int C) {
  mxt::sum_rows(part, sums, P, C);
}

}  // namespace

// part: (m_tiles, 2, N) scratch the caller allocated, m_tiles = ceil(M / 128),
// checked here; sums: (2, N), row 0 the column sums and row 1 the sums of squares.
extern "C" int mxt_matmul_stats_fwd(const float* a, const float* b, float* c, float* part,
                                    float* sums, int M, int K, int N, int m_tiles,
                                    void* stream) {
  if (M < 1 || N < 1 || K < 1 || m_tiles != (M + BM - 1) / BM)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + BN - 1) / BN, m_tiles);
  const bool va = K % 4 == 0, vb = N % 4 == 0;
  if (va && vb) matmul_stats_kernel<true, true><<<grid, kThreads, 0, st>>>(a, b, c, part, M, N, K);
  else if (va) matmul_stats_kernel<true, false><<<grid, kThreads, 0, st>>>(a, b, c, part, M, N, K);
  else if (vb) matmul_stats_kernel<false, true><<<grid, kThreads, 0, st>>>(a, b, c, part, M, N, K);
  else matmul_stats_kernel<false, false><<<grid, kThreads, 0, st>>>(a, b, c, part, M, N, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 sgrid, sblock;
  mxt::sum_rows_shape(m_tiles, 2 * N, &sgrid, &sblock);
  matmul_stats_sum_kernel<<<sgrid, sblock, 0, st>>>(part, sums, m_tiles, 2 * N);
  return static_cast<int>(cudaGetLastError());
}
