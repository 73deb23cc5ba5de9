// C = act(A · Wᵀ + b), f32, with the bias and activation on the accumulator.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_matmul_bias_act.py _kernel
// (launched by _fwd_call). A is (M, K) and W is (N, K), the FullyConnected
// layout: both operands are contiguous along K, and the kernel contracts them
// along that axis, so no transpose is ever made.
//
// Bound on an H100: operations at the prefill's shape (M = 1024, K = 512,
// N = 2048 does 2.1 GFLOP on 10 MB, far above the f32 operations-per-byte
// line), bytes at the decode's (M = 8: W's 4 MB dominate). This first version
// is a shared-memory-tiled GEMM on the f32 CUDA cores (no tensor cores, since
// the path is full f32 with TF32 off): each 256-thread block computes a 64x64
// tile of C, staging 16-deep slices of A and W in shared memory; each thread
// keeps a 4x4 sub-tile in registers and reads its operands from shared memory
// as float4. Ragged M, N and K are masked on load and store (zeros are loaded
// past the edge), so M = 8 works. The epilogue adds the bias and applies the
// activation before the one store of each output.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256
constexpr int kPad = 4;                           // keeps rows 16-byte aligned

enum Act { kRelu = 0, kSigmoid = 1, kTanh = 2, kSoftrelu = 3 };

__device__ __forceinline__ float apply_act(float p, int act) {
  switch (act) {
    case kRelu: return fmaxf(p, 0.f);
    case kSigmoid: return 1.f / (1.f + expf(-p));
    case kTanh: return tanhf(p);
    default: return fmaxf(p, 0.f) + log1pf(expf(-fabsf(p)));  // log(1 + e^p)
  }
}

__global__ void __launch_bounds__(kThreads)
matmul_bias_act_kernel(const float* __restrict__ A, const float* __restrict__ W,
                       const float* __restrict__ bias, float* __restrict__ C,
                       int M, int N, int K, int act) {
  __shared__ __align__(16) float As[BK][BM + kPad];
  __shared__ __align__(16) float Ws[BK][BN + kPad];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int t = 0; t < (BM * BK) / kThreads; ++t) {
      const int idx = tid + kThreads * t;
      const int r = idx / BK, c = idx % BK;
      const int gk = k0 + c;
      const int gm = m0 + r, gn = n0 + r;
      As[c][r] = (gm < M && gk < K) ? A[static_cast<size_t>(gm) * K + gk] : 0.f;
      Ws[c][r] = (gn < N && gk < K) ? W[static_cast<size_t>(gn) * K + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 w = *reinterpret_cast<const float4*>(&Ws[kk][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float wv[TN] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn >= N) continue;
      float p = acc[i][j];
      if (bias != nullptr) p += bias[gn];
      C[static_cast<size_t>(gm) * N + gn] = apply_act(p, act);
    }
  }
}

}  // namespace

extern "C" int mxt_matmul_bias_act_fwd(const float* a, const float* w, const float* bias,
                                       float* c, int M, int N, int K, int act,
                                       void* stream) {
  if (M < 1 || N < 1 || K < 1 || act < kRelu || act > kSoftrelu)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_bias_act_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, w, bias, c, M, N, K, act);
  return static_cast<int>(cudaGetLastError());
}
