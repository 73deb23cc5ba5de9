// Flash attention backward, f32: dQ, dK and dV of O = softmax(Q·Kᵀ·scale
// [+ causal mask])·V over (B·H, T, D) tensors, from the forward's O and row
// logsumexp (lse) and the upstream dO, with delta = rowsum(dO∘O) computed by
// the caller (one torch reduction, as the TPU path computes it in XLA).
//
// Replaces the TPU kernels mxnet_tpu/ops/pallas_attention.py _dq_kernel and
// _dkv_kernel (both launched by _bwd_call). The TPU split is kept: two
// passes, each owning its output, so neither needs atomics and the result is
// the same run to run.
//
// - dq: one block owns (bh, 32-query tile) and loops over 32-key tiles, as
//   the forward does. Per tile it recomputes the scores with the pre-scaled
//   Q, P = exp(s - lse), dP = dO·Vᵀ and dS = P∘(dP - delta), and adds dS·K to
//   its accumulators in registers; dQ = scale·Σ dS·K at the end (_dq_kernel
//   :148 multiplies by the scale there too).
// - dk/dv: one block owns (bh, 32-key tile) and loops over 32-query tiles
//   (the TPU's grid (BH, S/bk, T/bq) with the query axis innermost). dV +=
//   Pᵀ·dO and dK += dSᵀ·(Q·scale); Q carries the scale, so dK needs none on
//   top (_dkv_kernel :185-186).
//
// Bound on an H100: at the training shape (BH = 64, T = S = 256, D = 64,
// causal) each pass reads Q, K, V, dO, lse and delta (~17 MB) and writes its
// outputs (4 or 8 MB), and does about 6·D (dq) or 8·D (dk/dv) FLOP per
// visible (q, k) pair, ~0.81 and ~1.08 GFLOP; at 67 TFLOP/s of f32 outside
// the tensor cores that is ~12 and ~16 µs against ~6 and ~8 µs for the
// bytes, so operations bound both. The design keeps every
// (T, S) intermediate on chip and reads each tile once per block. Layout of a
// block: 8 warps, each owning 4 rows of the block's 32 (query rows in dq, key
// rows in dk/dv). The other side's 32-row tile is staged in shared memory
// with rows padded to D + 1 floats, so lane j reading row j hits its own
// bank; for the score-like products lane j owns column j of the tile, and
// for the accumulating products lane l owns output columns l, l + 32, ...
// and takes each column's weight from its owner by shuffle. Causal masking
// is bottom-right aligned (row r sees columns <= r + S - T). dq skips key
// tiles wholly above the diagonal; dk/dv skips query tiles whose last row
// cannot see the key tile's first column. A padded query row (>= T) has no
// defined lse, so its P is set to 0 explicitly, and it adds exactly 0 to dK
// and dV; padded key columns (>= S) are masked the same way. At D = 128 the
// four staged tiles take 66 KB, so the launchers raise the dynamic limit.
#include "common.cuh"

namespace {

constexpr int kWarps = 8, kRowsPerWarp = 4;
constexpr int BR = kWarps * kRowsPerWarp;  // rows a block owns: queries (dq), keys (dk/dv)
constexpr int BT = 32;                     // rows of the other side per tile: one per lane
constexpr int kMaxD = 128;                 // 4 output columns per lane
constexpr int kColsPerLane = kMaxD / 32;

__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int T, int S, int D, float scale, int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;                // BR x D, pre-scaled
  float* dOs = Qs + BR * D;        // BR x D
  float* Ks = dOs + BR * D;        // BT x (D + 1)
  float* Vs = Ks + BT * (D + 1);   // BT x (D + 1)

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BR;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t qbase = static_cast<size_t>(bh) * T * D;
  const size_t kbase = static_cast<size_t>(bh) * S * D;
  const int offset = S - T;

  for (int idx = tid; idx < BR * D; idx += kWarps * 32) {
    const int row = q0 + idx / D;
    float qv = 0.f, dv = 0.f;
    if (row < T) {
      const size_t g = qbase + static_cast<size_t>(row) * D + idx % D;
      qv = q[g] * scale;
      dv = dout[g];
    }
    Qs[idx] = qv;
    dOs[idx] = dv;
  }

  float lse_r[kRowsPerWarp], delta_r[kRowsPerWarp], acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    lse_r[r] = row < T ? lse[static_cast<size_t>(bh) * T + row] : 0.f;
    delta_r[r] = row < T ? delta[static_cast<size_t>(bh) * T + row] : 0.f;
#pragma unroll
    for (int i = 0; i < kColsPerLane; ++i) acc[r][i] = 0.f;
  }

  const int last_row = min(q0 + BR, T) - 1;
  const int k_end = causal ? min(S, last_row + offset + 1) : S;
  const float* qw = Qs + warp * kRowsPerWarp * D;
  const float* dow = dOs + warp * kRowsPerWarp * D;

  for (int k0 = 0; k0 < k_end; k0 += BT) {
    __syncthreads();  // Qs/dOs are written, and the previous tile is consumed
    for (int idx = tid; idx < BT * D; idx += kWarps * 32) {
      const int j = idx / D, d = idx % D, col = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (col < S) {
        const size_t g = kbase + static_cast<size_t>(col) * D + d;
        kv = k[g];
        vv = v[g];
      }
      Ks[j * (D + 1) + d] = kv;
      Vs[j * (D + 1) + d] = vv;
    }
    __syncthreads();

    // lane j: s[r] = (q_r·scale)·k_j and dp[r] = dO_r·v_j
    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
    const float* kr = Ks + lane * (D + 1);
    const float* vr = Vs + lane * (D + 1);
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d], vd = vr[d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        s[r] = fmaf(qw[r * D + d], kd, s[r]);
        dp[r] = fmaf(dow[r * D + d], vd, dp[r]);
      }
    }

    // s[r] becomes lane j's dS_rj = P_rj (dP_rj - delta_r)
    const int col = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = q0 + warp * kRowsPerWarp + r;
      const bool visible = row < T && col < S && (!causal || col <= row + offset);
      const float p = visible ? expf(s[r] - lse_r[r]) : 0.f;
      s[r] = p * (dp[r] - delta_r[r]);
    }

    // acc += dS · K
    for (int j = 0; j < BT; ++j) {
      float dsj[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) dsj[r] = __shfl_sync(mxt::kFullMask, s[r], j);
#pragma unroll
      for (int i = 0; i < kColsPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          const float kv = Ks[j * (D + 1) + d];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) acc[r][i] = fmaf(dsj[r], kv, acc[r][i]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row >= T) continue;
#pragma unroll
    for (int i = 0; i < kColsPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < D) dq[qbase + static_cast<size_t>(row) * D + d] = acc[r][i] * scale;
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv,
                     int T, int S, int D, float scale, int causal) {
  extern __shared__ float smem[];
  float* Ks = smem;                // BR x D, the block's keys
  float* Vs = Ks + BR * D;         // BR x D
  float* Qs = Vs + BR * D;         // BT x (D + 1), pre-scaled
  float* dOs = Qs + BT * (D + 1);  // BT x (D + 1)

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BR;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t qbase = static_cast<size_t>(bh) * T * D;
  const size_t kbase = static_cast<size_t>(bh) * S * D;
  const int offset = S - T;

  for (int idx = tid; idx < BR * D; idx += kWarps * 32) {
    const int col = k0 + idx / D;
    float kv = 0.f, vv = 0.f;
    if (col < S) {
      const size_t g = kbase + static_cast<size_t>(col) * D + idx % D;
      kv = k[g];
      vv = v[g];
    }
    Ks[idx] = kv;
    Vs[idx] = vv;
  }

  float acc_k[kRowsPerWarp][kColsPerLane], acc_v[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int i = 0; i < kColsPerLane; ++i) acc_k[r][i] = acc_v[r][i] = 0.f;
  }

  // causal: key column c is seen by query rows >= c - offset; the tile holding
  // the first such row of the block's first key is the first one needed
  const int first_row = causal ? max(0, k0 - offset) : 0;
  const float* kw = Ks + warp * kRowsPerWarp * D;
  const float* vw = Vs + warp * kRowsPerWarp * D;

  for (int q0 = (first_row / BT) * BT; q0 < T; q0 += BT) {
    __syncthreads();  // Ks/Vs are written, and the previous tile is consumed
    for (int idx = tid; idx < BT * D; idx += kWarps * 32) {
      const int i = idx / D, d = idx % D, row = q0 + i;
      float qv = 0.f, dv_ = 0.f;
      if (row < T) {
        const size_t g = qbase + static_cast<size_t>(row) * D + d;
        qv = q[g] * scale;
        dv_ = dout[g];
      }
      Qs[i * (D + 1) + d] = qv;
      dOs[i * (D + 1) + d] = dv_;
    }
    __syncthreads();

    // lane i owns query row q0 + i: s[r] = (q_i·scale)·k_r, dp[r] = dO_i·v_r
    const int row = q0 + lane;
    const bool row_in = row < T;
    const float lse_i = row_in ? lse[static_cast<size_t>(bh) * T + row] : 0.f;
    const float delta_i = row_in ? delta[static_cast<size_t>(bh) * T + row] : 0.f;
    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
    const float* qr = Qs + lane * (D + 1);
    const float* dor = dOs + lane * (D + 1);
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d], dd = dor[d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        s[r] = fmaf(qd, kw[r * D + d], s[r]);
        dp[r] = fmaf(dd, vw[r * D + d], dp[r]);
      }
    }

    // s[r] becomes P_ir, dp[r] becomes dS_ir = P_ir (dP_ir - delta_i); a padded
    // row's lse is not defined, so its P is 0 by the mask, not by exp
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int col = k0 + warp * kRowsPerWarp + r;
      const bool visible = row_in && col < S && (!causal || col <= row + offset);
      const float p = visible ? expf(s[r] - lse_i) : 0.f;
      dp[r] = p * (dp[r] - delta_i);
      s[r] = p;
    }

    // dV += Pᵀ · dO, dK += dSᵀ · (Q·scale)
    for (int i = 0; i < BT; ++i) {
      float pi[kRowsPerWarp], dsi[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        pi[r] = __shfl_sync(mxt::kFullMask, s[r], i);
        dsi[r] = __shfl_sync(mxt::kFullMask, dp[r], i);
      }
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        const int d = lane + 32 * c;
        if (d < D) {
          const float dov = dOs[i * (D + 1) + d], qv = Qs[i * (D + 1) + d];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            acc_v[r][c] = fmaf(pi[r], dov, acc_v[r][c]);
            acc_k[r][c] = fmaf(dsi[r], qv, acc_k[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int col = k0 + warp * kRowsPerWarp + r;
    if (col >= S) continue;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        const size_t g = kbase + static_cast<size_t>(col) * D + d;
        dk[g] = acc_k[r][c];
        dv[g] = acc_v[r][c];
      }
    }
  }
}

bool shapes_taken(int BH, int T, int S, int D, int causal, int rows) {
  return BH >= 1 && T >= 1 && S >= 1 && D >= 1 && D <= kMaxD && !(causal && S < T) &&
         (rows + BR - 1) / BR <= 65535;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

size_t smem_bytes(int D) {
  return static_cast<size_t>(2 * BR * D + 2 * BT * (D + 1)) * sizeof(float);
}

}  // namespace

extern "C" int mxt_flash_attention_bwd_dq(const float* q, const float* k, const float* v,
                                          const float* dout, const float* lse,
                                          const float* delta, float* dq, int BH, int T,
                                          int S, int D, float scale, int causal,
                                          void* stream) {
  if (!shapes_taken(BH, T, S, D, causal, T)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(D);
  const cudaError_t e = allow_smem(flash_bwd_dq_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(BH, (T + BR - 1) / BR);
  flash_bwd_dq_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, dout, lse, delta, dq, T, S, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mxt_flash_attention_bwd_dkv(const float* q, const float* k, const float* v,
                                           const float* dout, const float* lse,
                                           const float* delta, float* dk, float* dv, int BH,
                                           int T, int S, int D, float scale, int causal,
                                           void* stream) {
  if (!shapes_taken(BH, T, S, D, causal, S)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(D);
  const cudaError_t e = allow_smem(flash_bwd_dkv_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(BH, (S + BR - 1) / BR);
  flash_bwd_dkv_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, dout, lse, delta, dk, dv, T, S, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}
