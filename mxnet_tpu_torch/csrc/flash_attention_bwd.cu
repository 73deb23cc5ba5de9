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
// - dq: a block owns (bh, a tile of kRows query rows), each warp 16 of
//   them, and loops over key tiles of kCols. Per tile, with Q and dO staged
//   once for the block's life: S = Q·Kᵀ and dP = dO·Vᵀ (Q and dO the A
//   operands), P = exp(S·scale − lse) (as an exp2f, flash_tc.cuh
//   masked_exp), dS = P∘(dP − delta), and dQ += dS·K
//   with dS taken from the accumulator registers as the A operand;
//   dQ·scale at the end (_dq_kernel :148 scales there too).
// - dk/dv: a block owns (bh, a tile of kRows keys) and loops over query
//   tiles of kCols (the TPU's grid (BH, S/bk, T/bq) with the query axis
//   innermost). The keys are the M rows: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, so Pᵀ
//   and dSᵀ are A fragments in registers for dV += Pᵀ·dO and dK += dSᵀ·Q;
//   lse and delta are indexed by column. dK·scale at the end: the TPU kernel
//   scales Q instead (_dkv_kernel :185-186), which differs by one rounding.
//
// Bound on an H100: at the training shape (BH = 64, T = S = 256, D = 64,
// causal) each pass reads Q, K, V, dO, lse and delta (~17 MB) and writes its
// outputs (4 or 8 MB): ~6 and ~8 µs at 3.35 TB/s. The products are 6·D (dq)
// and 8·D (dk/dv) FLOP a visible (q, k) pair, ~0.81 and ~1.08 GFLOP, and
// must keep f32 accuracy: on the TF32 tensor cores with the 3xTF32 step
// (tf32x3.cuh) that is ~5 and ~7 µs at 495 TFLOP/s, so bytes bound both by a
// little. What holds the kernels is neither: the shape has 1024 warps' worth
// of 16 rows for 132 SMs, two warps a scheduler, so each warp's chain of
// tiles (copies, splits, mma.sync, exp) sets the time; alone on an SM one
// block takes most of the whole call's time. The design therefore shortens
// and overlaps that chain:
// - every product is a 3xTF32 mma.sync with a fresh accumulator a step,
//   issued across the n-tiles (tf32x3.cuh mma3_tiles) so that no mma
//   waits on the one before it; the tiles are straight-line code, with no
//   branch between the products for the scheduler to stop at;
// - P and dS never leave the registers (a score tile's accumulator is the
//   next product's A fragment); the operands' shared-memory loads are free
//   of bank conflicts (flash_tc.cuh);
// - GROUPS groups of warps share a block's rows and take turns over the
//   streaming tiles, which halves each warp's chain for two groups; their
//   sums meet in shared memory in a fixed order at the end;
// - the streaming tiles go through a 2-stage cp.async ring, so the next
//   step's copies overlap this step's products.
// Causal masking is bottom-right aligned (row r sees columns <= r + S - T).
// A block streams only the rows its own rows see (the table's range, so no
// tile is wholly masked) and a warp skips the tiles its own 16 rows cannot
// see; the blocks with the most rows to stream launch first. A padded row or column gets P = 0 from the mask, never from exp. D that is
// not a multiple of 8 is zero-padded in shared memory, up to the width the
// kernel is built for (64 or 128); rows that cannot take 16-byte copies
// (D % 4 != 0 or an unaligned base) take 4-byte ones.
//
// Tiling: a block owns kRows = 64 rows (4 warps of 16) and streams tiles of
// 32 rows; up to D = 64 two groups of warps take turns over the tiles, up
// to D = 128 (twice the accumulators) one. Which rows a block owns and which
// rows of the other side it streams (in launch order) is a table the caller
// builds, ops/flash_attention.py _tiles, so the ranges the kernels run
// are the ones its tests check.
#include "flash_tc.cuh"

namespace {

using namespace mxt::flash;

constexpr int kStages = 2;
constexpr int kMaxD = 128;
constexpr int kWarps = 4;          // a group's warps, 16 own rows each
constexpr int kRows = 16 * kWarps;  // a block's own rows: ops/flash_attention.py _tiles
constexpr int kCols = 32;          // the rows of a streaming tile
// Both kernels state one block an SM in their launch bounds (a second would
// need 128 registers a thread, which spilled): ptxas then schedules for up
// to 255. Without the minimum it settled for far fewer, and both kernels
// ran slower on an H100 at the training shape.

// A pass's block: GROUPS groups of kWarps warps. Every group owns the same
// kRows rows (a warp 16 of them); group g takes the streaming tiles g,
// g + GROUPS, ..., so a block's chain of tiles is GROUPS times shorter, and
// the groups' sums are added in a fixed order at the end. Shared memory:
// the block's own rows (two tiles: Q and dO, or K and V) and kStages
// stages of GROUPS streaming tiles each (two tiles, plus lse and delta for
// dk/dv).
template <int GROUPS, int DMAX, bool DKV>
struct Cfg {
  static constexpr int THREADS = kWarps * GROUPS * 32, BM = kRows, BN = kCols, LD = DMAX + 8;
  static constexpr int NT = BN / 8, ND = DMAX / 8;
  static constexpr int TILE = 2 * BN * LD + (DKV ? 2 * BN : 0);  // one group's
  static constexpr int STAGE = GROUPS * TILE;
  static constexpr int SMEM = (2 * BM * LD + kStages * STAGE) * 4;
  static_assert(LD % 32 == 8, "rows 8 mod 32 floats: conflict-free fragment loads");
  static_assert(GROUPS == 1 || GROUPS == 2, "one or two groups");
};

struct Args {
  const float *q, *k, *v, *dout, *lse, *delta;
  float *out0, *out1;  // dq; or dk, dv
  // by blockIdx.y: the block's first own row, then the first and the end
  // row of the other side's rows it streams
  const int* blocks;
  int BH, T, S, D;
  float scale;
  int causal;
};

// The groups' sums, in place in group 0's acc: group 1 leaves its sums in
// red (kWarps · 32 · N floats of free shared memory), group 0 adds them.
template <int GROUPS, int N>
__device__ __forceinline__ void add_groups(float (&acc)[N][4], float* red) {
  if constexpr (GROUPS == 2) {
    constexpr int PER = kWarps * 32;
    const int tid = threadIdx.x, i0 = tid % PER;
    __syncthreads();  // every group is done with the shared memory red reuses
    if (tid >= PER) {
#pragma unroll
      for (int i = 0; i < 4 * N; ++i) red[i * PER + i0] = acc[i / 4][i % 4];
    }
    __syncthreads();
    if (tid < PER) {
#pragma unroll
      for (int i = 0; i < 4 * N; ++i) acc[i / 4][i % 4] += red[i * PER + i0];
    }
  }
}

template <int GROUPS, int DMAX, bool VEC>
__global__ void __launch_bounds__(kWarps * GROUPS * 32, 1) flash_bwd_dq_kernel(const Args a) {
  using C = Cfg<GROUPS, DMAX, false>;
  constexpr int BQ = C::BM, BK = C::BN, LD = C::LD, NT = C::NT, ND = C::ND;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // BQ x LD
  float* dOs = Qs + BQ * LD;      // BQ x LD
  float* ring = dOs + BQ * LD;    // kStages x GROUPS x {K, V}, BK x LD each

  const int T = a.T, S = a.S, D = a.D, causal = a.causal;
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int group = warp / kWarps;
  const int bh = blockIdx.x;
  const int* blk = a.blocks + 3 * blockIdx.y;
  const int q0 = blk[0], k_begin = blk[1];  // key tile kt starts at k_begin + kt·BK
  const size_t qbase = static_cast<size_t>(bh) * T * D;
  const size_t kbase = static_cast<size_t>(bh) * S * D;
  const int offset = S - T;
  const int nkt = (blk[2] - k_begin + BK - 1) / BK;
  const int steps = (nkt + GROUPS - 1) / GROUPS;  // step it: tiles it·GROUPS + group

  auto load_kv = [&](int it) {
#pragma unroll
    for (int gr = 0; gr < GROUPS; ++gr) {
      const int kt = it * GROUPS + gr;
      if (kt >= nkt) break;
      float* ks = ring + (it % kStages) * C::STAGE + gr * C::TILE;
      const int r0 = k_begin + kt * BK;
      stage_rows<BK, DMAX, LD, C::THREADS, VEC>(ks, a.k + kbase, r0, S, D);
      stage_rows<BK, DMAX, LD, C::THREADS, VEC>(ks + BK * LD, a.v + kbase, r0, S, D);
    }
  };
  stage_rows<BQ, DMAX, LD, C::THREADS, VEC>(Qs, a.q + qbase, q0, T, D);
  stage_rows<BQ, DMAX, LD, C::THREADS, VEC>(dOs, a.dout + qbase, q0, T, D);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {  // Q and dO join the first group
    if (s < steps) load_kv(s);
    cp_async_commit();
  }

  const int row0 = q0 + (warp % kWarps) * 16;  // the warp's first query row
  const int rlast = min(row0 + 15, T - 1);    // and its last (< row0: none)
  float lse_r[2], delta_r[2];  // lse in log2 units
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    lse_r[h] = row < T ? a.lse[static_cast<size_t>(bh) * T + row] * kLog2e : 0.f;
    delta_r[h] = row < T ? a.delta[static_cast<size_t>(bh) * T + row] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int it = 0; it < steps; ++it) {
    cp_async_wait<kStages - 2>();  // this thread's copies of step it landed
    __syncthreads();               // everyone's did, and every warp is done with step it - 1
    if (it + kStages - 1 < steps) load_kv(it + kStages - 1);
    cp_async_commit();
    const int kt = it * GROUPS + group, k0 = k_begin + kt * BK;
    // a warp whose rows see none of the tile's keys (or has no rows) waits
    if (kt >= nkt || rlast < row0 || (causal && k0 > rlast + offset)) continue;
    const float* ks = ring + (it % kStages) * C::STAGE + group * C::TILE;
    const float* vs = ks + BK * LD;

    float s[NT][4], dpv[NT][4];
    score_tile<NT, DMAX, LD>(Qs + (warp % kWarps) * 16 * LD, ks, s);
    score_tile<NT, DMAX, LD>(dOs + (warp % kWarps) * 16 * LD, vs, dpv);
    const bool whole = row0 + 15 < T && k0 + BK <= S && (!causal || k0 + BK - 1 <= row0 + offset);
    masked_exp<NT>(
        s, a.scale * kLog2e, [&](int h, int) { return lse_r[h]; },
        [&](int r, int c) {
          const int row = row0 + r, col = k0 + c;
          return whole || (row < T && col < S && (!causal || col <= row + offset));
        });
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] *= dpv[ni][e] - delta_r[e >> 1];
    // dQ += dS · K, dS straight from the registers
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t a_hi[4], a_lo[4];
      acc_as_a(s[j], a_hi, a_lo);
      accumulate_step<ND, LD>(a_hi, a_lo, ks + j * 8 * LD, acc);
    }
  }
  cp_async_wait<0>();
  add_groups<GROUPS>(acc, smem);
  if (group != 0) return;

#pragma unroll
  for (int ni = 0; ni < ND; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e >> 1), col = ni * 8 + 2 * t + (e & 1);
      if (row < T && col < D) a.out0[qbase + static_cast<size_t>(row) * D + col] =
          acc[ni][e] * a.scale;
    }
}

template <int GROUPS, int DMAX, bool VEC>
__global__ void __launch_bounds__(kWarps * GROUPS * 32, 1) flash_bwd_dkv_kernel(const Args a) {
  using C = Cfg<GROUPS, DMAX, true>;
  constexpr int BKR = C::BM, BQ = C::BN, LD = C::LD, NT = C::NT, ND = C::ND;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;               // BKR x LD, the block's keys
  float* Vs = Ks + BKR * LD;      // BKR x LD
  float* ring = Vs + BKR * LD;    // kStages x GROUPS x {Q, dO (BQ x LD each), lse, delta}

  const int T = a.T, S = a.S, D = a.D, causal = a.causal;
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int group = warp / kWarps;
  const int bh = blockIdx.x;
  const int* blk = a.blocks + 3 * blockIdx.y;
  const int k0 = blk[0], q_begin = blk[1];  // query tile i starts at q_begin + i·BQ
  const size_t qbase = static_cast<size_t>(bh) * T * D;
  const size_t kbase = static_cast<size_t>(bh) * S * D;
  const int offset = S - T;
  const int nqt = (blk[2] - q_begin + BQ - 1) / BQ;
  const int steps = (nqt + GROUPS - 1) / GROUPS;  // step it: tiles it·GROUPS + group

  auto load_q = [&](int it) {
#pragma unroll
    for (int gr = 0; gr < GROUPS; ++gr) {
      const int i = it * GROUPS + gr;
      if (i >= nqt) break;
      float* qs = ring + (it % kStages) * C::STAGE + gr * C::TILE;
      const int r0 = q_begin + i * BQ;
      stage_rows<BQ, DMAX, LD, C::THREADS, VEC>(qs, a.q + qbase, r0, T, D);
      stage_rows<BQ, DMAX, LD, C::THREADS, VEC>(qs + BQ * LD, a.dout + qbase, r0, T, D);
      float* ls = qs + 2 * BQ * LD;
      for (int j = tid; j < 2 * BQ; j += C::THREADS) {
        const int row = r0 + (j % BQ);
        const float* src = j < BQ ? a.lse : a.delta;
        const bool p = row < T;
        cp_async4(ls + j, p ? src + static_cast<size_t>(bh) * T + row : src, p);
      }
    }
  };
  stage_rows<BKR, DMAX, LD, C::THREADS, VEC>(Ks, a.k + kbase, k0, S, D);
  stage_rows<BKR, DMAX, LD, C::THREADS, VEC>(Vs, a.v + kbase, k0, S, D);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {  // K and V join the first group
    if (s < steps) load_q(s);
    cp_async_commit();
  }

  const int key0 = k0 + (warp % kWarps) * 16;  // the warp's first key
  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;

  for (int it = 0; it < steps; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < steps) load_q(it + kStages - 1);
    cp_async_commit();
    const int i = it * GROUPS + group, q0 = q_begin + i * BQ;
    // a warp whose keys no query of the tile sees (or has no keys) waits
    if (i >= nqt || key0 >= S || (causal && key0 > q0 + BQ - 1 + offset)) continue;
    const float* qs = ring + (it % kStages) * C::STAGE + group * C::TILE;
    const float* dos = qs + BQ * LD;
    const float* lse_s = dos + BQ * LD;
    const float* delta_s = lse_s + BQ;

    float s[NT][4], dps[NT][4];
    score_tile<NT, DMAX, LD>(Ks + (warp % kWarps) * 16 * LD, qs, s);
    score_tile<NT, DMAX, LD>(Vs + (warp % kWarps) * 16 * LD, dos, dps);
    const bool whole = key0 + 15 < S && q0 + BQ <= T && (!causal || key0 + 15 <= q0 + offset);
    masked_exp<NT>(
        s, a.scale * kLog2e, [&](int, int c) { return lse_s[c] * kLog2e; },
        [&](int r, int c) {
          const int key = key0 + r, query = q0 + c;
          return whole || (query < T && key < S && (!causal || key <= query + offset));
        });
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const float d0 = delta_s[ni * 8 + col_row(2 * t)];
      const float d1 = delta_s[ni * 8 + col_row(2 * t + 1)];
      dps[ni][0] = s[ni][0] * (dps[ni][0] - d0);
      dps[ni][1] = s[ni][1] * (dps[ni][1] - d1);
      dps[ni][2] = s[ni][2] * (dps[ni][2] - d0);
      dps[ni][3] = s[ni][3] * (dps[ni][3] - d1);
    }
    // dV += Pᵀ · dO and dK += dSᵀ · Q, Pᵀ and dSᵀ straight from the registers
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t a_hi[4], a_lo[4];
      acc_as_a(s[j], a_hi, a_lo);
      accumulate_step<ND, LD>(a_hi, a_lo, dos + j * 8 * LD, acc_v);
      acc_as_a(dps[j], a_hi, a_lo);
      accumulate_step<ND, LD>(a_hi, a_lo, qs + j * 8 * LD, acc_k);
    }
  }
  cp_async_wait<0>();
  add_groups<GROUPS>(acc_k, smem);
  add_groups<GROUPS>(acc_v, smem);
  if (group != 0) return;

#pragma unroll
  for (int ni = 0; ni < ND; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + g + 8 * (e >> 1), col = ni * 8 + 2 * t + (e & 1);
      if (key < S && col < D) {
        const size_t o = kbase + static_cast<size_t>(key) * D + col;
        a.out0[o] = acc_k[ni][e] * a.scale;
        a.out1[o] = acc_v[ni][e];
      }
    }
}

bool shapes_taken(const Args& a) {
  return a.BH >= 1 && a.T >= 1 && a.S >= 1 && a.D >= 1 && a.D <= kMaxD &&
         !(a.causal && a.S < a.T);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// 16-byte copies: every row of Q, K, V and dO starts on 16 bytes.
bool vec_rows(const Args& a) {
  return a.D % 4 == 0 && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
         aligned16(a.dout);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, int smem, bool* raised, int nblocks,
                   const Args& a, cudaStream_t st) {
  const cudaError_t e = mxt::raise_smem(kernel, smem, raised);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.BH, nblocks), threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <bool DKV, int GROUPS, int DMAX, bool VEC>
cudaError_t run(const Args& a, int nblocks, cudaStream_t st) {
  using C = Cfg<GROUPS, DMAX, DKV>;
  static bool raised = false;
  if constexpr (DKV)
    return launch(flash_bwd_dkv_kernel<GROUPS, DMAX, VEC>, C::THREADS, C::SMEM, &raised,
                  nblocks, a, st);
  else
    return launch(flash_bwd_dq_kernel<GROUPS, DMAX, VEC>, C::THREADS, C::SMEM, &raised,
                  nblocks, a, st);
}

// nblocks: the table's rows, one a block of kRows own rows.
template <bool DKV>
int dispatch(const Args& a, int nblocks, void* stream) {
  const int own = DKV ? a.S : a.T;
  if (!shapes_taken(a) || a.blocks == nullptr || nblocks != (own + kRows - 1) / kRows ||
      nblocks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = vec_rows(a);
  if (a.D <= 64)
    return static_cast<int>(vec ? run<DKV, 2, 64, true>(a, nblocks, st)
                                : run<DKV, 2, 64, false>(a, nblocks, st));
  return static_cast<int>(vec ? run<DKV, 1, 128, true>(a, nblocks, st)
                              : run<DKV, 1, 128, false>(a, nblocks, st));
}

}  // namespace

// blocks, nblocks: each block's rows (ops/flash_attention.py _tiles),
// int32 on the card: dq's own rows are queries, its streamed rows keys.
extern "C" int mxt_flash_attention_bwd_dq(const float* q, const float* k, const float* v,
                                          const float* dout, const float* lse,
                                          const float* delta, float* dq, const int* blocks,
                                          int nblocks, int BH, int T, int S, int D,
                                          float scale, int causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, blocks, BH, T, S, D, scale, causal};
  return dispatch<false>(a, nblocks, stream);
}

// As for dq, with keys as the own rows and queries streamed.
extern "C" int mxt_flash_attention_bwd_dkv(const float* q, const float* k, const float* v,
                                           const float* dout, const float* lse,
                                           const float* delta, float* dk, float* dv,
                                           const int* blocks, int nblocks, int BH, int T,
                                           int S, int D, float scale, int causal,
                                           void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, blocks, BH, T, S, D, scale, causal};
  return dispatch<true>(a, nblocks, stream);
}
