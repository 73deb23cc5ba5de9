// Flash attention forward, f32: O = softmax(Q·Kᵀ·scale [+ causal mask])·V and
// the row logsumexp, over (B·H, T, D) tensors.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_attention.py _fwd_kernel
// (launched by _fwd_call). The TPU kernel walks its key tiles as the last,
// sequential grid axis and carries (m, l, acc) in VMEM scratch between grid
// steps; blocks on a GPU run in no order, so here one block owns one
// (bh, 32-query tile) and loops over the key tiles itself, with m, l and acc
// in registers, all in f32.
//
// Bound on an H100: at the prefill's shape (BH = 64, T = S = 128, D = 64,
// causal) the function moves 8.4 MB and does about 0.14 GFLOP of products,
// so bytes bound it; the (T, S) scores never reach device memory. Layout of a
// block: 8 warps, each owning 4 query rows. Per 32-key tile the block stages
// K and V in shared memory (K rows padded to D + 1 floats so that lane j
// reading row j hits its own bank). For Q·Kᵀ lane j owns key j and reads the
// warp's q rows as shared-memory broadcasts; the tile's max and sum are warp
// reductions; for P·V lane l owns output columns l, l + 32, ... and takes
// each key's probability from its owner by shuffle. The causal mask is
// bottom-right aligned (row r sees columns <= r + S - T), key tiles wholly
// above the diagonal of the block's rows are never loaded, and the ragged
// edges of T and S are masked. Masked scores are -1e30, as on the TPU, so a
// masked key contributes exp(-1e30 - m) = 0.
#include "common.cuh"

namespace {

constexpr int kWarps = 8, kRowsPerWarp = 4;
constexpr int BQ = kWarps * kRowsPerWarp;  // 32 query rows per block
constexpr int BK = 32;                     // keys per tile: one per lane
constexpr int kMaxD = 128;                 // 4 output columns per lane
constexpr int kColsPerLane = kMaxD / 32;
constexpr float kNegInf = -1e30f;

__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int T, int S, int D, float scale, int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // BQ x D, pre-scaled
  float* Ks = Qs + BQ * D;          // BK x (D + 1)
  float* Vs = Ks + BK * (D + 1);    // BK x D

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t qbase = static_cast<size_t>(bh) * T * D;
  const size_t kbase = static_cast<size_t>(bh) * S * D;
  const int offset = S - T;

  for (int idx = tid; idx < BQ * D; idx += kWarps * 32) {
    const int row = q0 + idx / D;
    Qs[idx] = row < T ? q[qbase + static_cast<size_t>(row) * D + idx % D] * scale : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kColsPerLane; ++i) acc[r][i] = 0.f;
  }

  const int last_row = min(q0 + BQ, T) - 1;
  const int k_end = causal ? min(S, last_row + offset + 1) : S;
  const float* qw = Qs + warp * kRowsPerWarp * D;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // Qs is written, and the previous tile is consumed
    for (int idx = tid; idx < BK * D; idx += kWarps * 32) {
      const int j = idx / D, d = idx % D, col = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (col < S) {
        const size_t g = kbase + static_cast<size_t>(col) * D + d;
        kv = k[g];
        vv = v[g];
      }
      Ks[j * (D + 1) + d] = kv;
      Vs[j * D + d] = vv;
    }
    __syncthreads();

    // scores: lane j holds s[r] = q_r · k_j
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* kr = Ks + lane * (D + 1);
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] = fmaf(qw[r * D + d], kd, s[r]);
    }

    // online softmax update, one row at a time; s[r] becomes lane j's p_rj
    const int col = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = q0 + warp * kRowsPerWarp + r;
      const bool visible = col < S && (!causal || col <= row + offset);
      const float sc = visible ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], mxt::warp_max(sc));
      const float alpha = expf(m[r] - m_new);
      const float p = expf(sc - m_new);
      l[r] = l[r] * alpha + mxt::warp_sum(p);
      m[r] = m_new;
      s[r] = p;
#pragma unroll
      for (int i = 0; i < kColsPerLane; ++i) acc[r][i] *= alpha;
    }

    // acc += P · V
    for (int j = 0; j < BK; ++j) {
      float pj[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) pj[r] = __shfl_sync(mxt::kFullMask, s[r], j);
#pragma unroll
      for (int i = 0; i < kColsPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          const float vv = Vs[j * D + d];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) acc[r][i] = fmaf(pj[r], vv, acc[r][i]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row >= T) continue;
    const float ll = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < kColsPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < D) o[qbase + static_cast<size_t>(row) * D + d] = acc[r][i] / ll;
    }
    if (lane == 0) lse[static_cast<size_t>(bh) * T + row] = m[r] + logf(ll);
  }
}

}  // namespace

extern "C" int mxt_flash_attention_fwd(const float* q, const float* k, const float* v,
                                       float* o, float* lse, int BH, int T, int S, int D,
                                       float scale, int causal, void* stream) {
  if (BH < 1 || T < 1 || S < 1 || D < 1 || D > kMaxD || (causal && S < T) ||
      (T + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(BQ * D + BK * (D + 1) + BK * D) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(BH, (T + BQ - 1) / BQ);
  flash_fwd_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, o, lse, T, S, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}
