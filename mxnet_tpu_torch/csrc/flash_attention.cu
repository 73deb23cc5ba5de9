// Flash attention forward, f32 and bf16: O = softmax(Q·Kᵀ·scale [+ causal
// mask])·V and the row logsumexp, over (B·H, T, D) tensors.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_attention.py _fwd_kernel
// (launched by _fwd_call). The TPU kernel walks its key tiles as the last,
// sequential grid axis and carries (m, l, acc) in VMEM scratch between grid
// steps; blocks on a GPU run in no order, so here one block owns a tile of
// query rows and loops over the key tiles itself, with m, l and acc in
// registers.
//
// Bound on an H100: at the training shape (BH = 64, T = S = 256, D = 64,
// causal) the function reads Q, K, V (12.6 MB) and writes O and lse (4.2 MB),
// ~5 µs at 3.35 TB/s, and its products are 4·D FLOP a visible (q, k) pair,
// ~0.54 GFLOP, which must keep f32 accuracy: on the TF32 tensor cores with
// the 3xTF32 step (tf32x3.cuh) ~3.3 µs at 495 TFLOP/s. The (T, S) scores
// never reach device memory. As in the backward (flash_attention_bwd.cu),
// neither bound holds the kernel: the shape has 1024 warps' worth of 16
// query rows for 132 SMs, so each warp's chain of key tiles (copies,
// splits, mma.sync, the softmax) sets the time. The design is the dq
// kernel's with the online softmax in place of the saved logsumexp:
// - a block owns 64 query rows (4 warps of 16), staged once for the
//   block's life; a warp's S = Q·Kᵀ over a key tile of 32 is flash_tc.cuh's
//   score_tile, 3xTF32 mma.sync with a fresh accumulator a step;
// - the online softmax stays in registers: a thread holds two rows (g and
//   g + 8) of the warp's 16, takes each row's max over the tile's visible
//   scores with its quad (__shfl_xor_sync 1 and 2), rescales its share of
//   the row sum l and its O accumulator by α = 2^(m_old − m_new) (in the
//   log2 domain, so α is exactly 1 when the max stays), and forms P =
//   2^(s·scale·log2 e − m·scale·log2 e) by masked_exp: one FMA and one
//   exp2f, exactly 0 where masked;
// - O += P·V with P split like any other operand and taken from the score
//   accumulator as the A fragment (acc_as_a): V's rows are the keys, so P
//   never leaves the registers;
// - two groups of 4 warps own the same 64 rows and take turns over the key
//   tiles, which halves each warp's chain; their (m, l, O) are merged in
//   shared memory in a fixed order at the end (no atomics: the same bits
//   twice);
// - K and V tiles go through a 2-stage cp.async ring, so the next step's
//   copies overlap this step's products.
// Causal masking is bottom-right aligned (row r sees keys <= r + S − T). A
// block streams only the keys its rows see (the table's range), a warp
// skips the tiles its own 16 rows cannot see, and the query tiles with the
// most keys launch first: which rows a block owns and which keys it streams
// is ops/flash_attention.py _tiles's table, the one the dq kernel reads. A
// padded row or key gets P = 0 from the mask, never from exp, and a padded
// row is never written. D that is not a multiple of 8 is zero-padded in
// shared memory up to the width the kernel is built for (64 or 128); rows
// that cannot take 16-byte copies (D % 4 != 0 or an unaligned base) take
// 4-byte ones.
//
// One layout a head width: 4 warps a group, 32-key tiles, one block an SM in
// the launch bounds; two groups up to D = 64, one up to D = 128 (twice the
// accumulators). Of the layouts timed on the card in scratch builds (PERF.md
// §6: one group, 32 own rows, 64-key tiles, two blocks an SM), none beat
// this one by more than 4 % at the prefill's and the training step's shapes.
//
// The bf16 form (mxt_flash_attention_fwd_bf16, the same TPU kernel on bf16 q,
// k, v: O in q's dtype, pallas_attention.py :223, lse f32) is the same kernel
// over bf16 storage, for the bf16 serving path (KVCacheDecoder(dtype=
// 'bfloat16')'s prefill). Q, K and V are widened into the same f32 tiles,
// through registers (flash_tc.cuh's bf16 stage_rows: the loads are
// synchronous, the ring's cp.async overlap is lost); the scores are one bf16
// mma.sync a step with exact products; P stays f32 and P·V takes two TF32
// products a step (V is exact in TF32); O = acc / l is rounded to bf16 once,
// to nearest even. Its bound at the prefill's shape (BH = 64, T = S = 128,
// D = 64, causal) is its bytes: 4.2 MB at 2 B an element, ~1.3 µs.
#include "flash_tc.cuh"

namespace {

using namespace mxt::flash;

constexpr int kStages = 2;
constexpr int kMaxD = 128;
constexpr int kWarps = 4;           // a group's warps, 16 own rows each
constexpr int kRows = 16 * kWarps;  // a block's own rows: ops/flash_attention.py _tiles
constexpr int kCols = 32;           // the keys of a tile
constexpr float kNoMax = -1e30f;    // a row's max before it has seen a key

// A block: GROUPS groups of kWarps warps, each warp 16 query rows; every
// group owns the same kRows rows and group g takes the key tiles g,
// g + GROUPS, ... Shared memory: the block's Q tile, then kStages stages of
// GROUPS (K, V) tile pairs.
template <int GROUPS, int DMAX>
struct Cfg {
  static constexpr int THREADS = kWarps * GROUPS * 32, BM = kRows, BN = kCols,
                       LD = DMAX + 8, NT = BN / 8, ND = DMAX / 8;
  static constexpr int TILE = 2 * BN * LD;  // one group's K and V
  static constexpr int STAGE = GROUPS * TILE;
  static constexpr int SMEM = (BM * LD + kStages * STAGE) * 4;
  static_assert(LD % 32 == 8, "rows 8 mod 32 floats: conflict-free fragment loads");
  // the merge of the groups' (m, l, O) reuses the shared memory
  static_assert(GROUPS == 1 || kWarps * 32 * (4 + 4 * ND) <= kStages * STAGE, "merge space");
};

template <typename Elem>
struct Args {
  const Elem *q, *k, *v;
  Elem* o;
  float* lse;
  // by blockIdx.y: the block's first query row, then its first and end key
  const int* blocks;
  int BH, T, S, D;
  float scale;
  int causal;
};

// Group 0 takes over the other groups' (m, l, O) in group order: each
// group's share is rescaled to the common max, so the result is that of
// one pass over all the tiles up to the order of the sums. red: free shared
// memory for one group's state.
template <int GROUPS, int ND>
__device__ __forceinline__ void merge_groups(float (&m)[2], float (&ml)[2], float (&l)[2],
                                             float (&acc)[ND][4], float* red, float sl2) {
  constexpr int PER = kWarps * 32;
  const int tid = threadIdx.x, i0 = tid % PER, group = tid / PER;
#pragma unroll
  for (int from = 1; from < GROUPS; ++from) {
    __syncthreads();  // every group is done with the shared memory red reuses
    if (group == from) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        red[h * PER + i0] = m[h];
        red[(2 + h) * PER + i0] = l[h];
      }
#pragma unroll
      for (int i = 0; i < 4 * ND; ++i) red[(4 + i) * PER + i0] = acc[i / 4][i % 4];
    }
    __syncthreads();
    if (group == 0) {
      float a0[2], a1[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m1 = red[h * PER + i0], mn = fmaxf(m[h], m1), mnl = mn * sl2;
        a0[h] = exp2f(ml[h] - mnl);
        a1[h] = exp2f(m1 * sl2 - mnl);
        m[h] = mn;
        ml[h] = mnl;
        l[h] = l[h] * a0[h] + red[(2 + h) * PER + i0] * a1[h];
      }
#pragma unroll
      for (int i = 0; i < 4 * ND; ++i) {
        const int h = (i % 4) >> 1;
        acc[i / 4][i % 4] = acc[i / 4][i % 4] * a0[h] + red[(4 + i) * PER + i0] * a1[h];
      }
    }
  }
}

// The kernels' body. Elem: the operands' storage, float or __nv_bfloat16 (the
// bf16 form, whose pieces are flash_tc.cuh's bf16 ones; everything else is
// shared).
template <typename Elem, int GROUPS, int DMAX, bool VEC>
__device__ __forceinline__ void flash_fwd(const Args<Elem>& a) {
  constexpr bool kBf16 = mxt::IsBf16<Elem>::value;
  using C = Cfg<GROUPS, DMAX>;
  constexpr int BQ = C::BM, BK = C::BN, LD = C::LD, NT = C::NT, ND = C::ND;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // BQ x LD
  float* ring = Qs + BQ * LD;   // kStages x GROUPS x {K, V}, BK x LD each

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
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {  // Q joins the first group
    if (s < steps) load_kv(s);
    cp_async_commit();
  }

  const int row0 = q0 + (warp % kWarps) * 16;  // the warp's first query row
  const int rlast = min(row0 + 15, T - 1);    // and its last (< row0: none)
  const float sl2 = a.scale * kLog2e;
  // rows g and g + 8 of the warp's 16: the max of the raw scores seen (m),
  // m·scale·log2(e) rounded once (ml), and this thread's columns' share of
  // the row sum (l); the quad's four shares are added at the end
  float m[2] = {kNoMax, kNoMax}, ml[2] = {kNoMax * sl2, kNoMax * sl2}, l[2] = {0.f, 0.f};
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

    float s[NT][4];
    if constexpr (kBf16) score_tile_bf16<NT, DMAX, LD>(Qs + (warp % kWarps) * 16 * LD, ks, s);
    else score_tile<NT, DMAX, LD>(Qs + (warp % kWarps) * 16 * LD, ks, s);
    const bool whole = row0 + 15 < T && k0 + BK <= S && (!causal || k0 + BK - 1 <= row0 + offset);
    auto visible = [&](int r, int c) {
      const int row = row0 + r, col = k0 + c;
      return whole || (row < T && col < S && (!causal || col <= row + offset));
    };
    // the new row max over the tile's visible scores, with the quad
    float mx[2] = {kNoMax, kNoMax};
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (visible(g + 8 * (e >> 1), ni * 8 + col_row(2 * t + (e & 1))))
          mx[e >> 1] = fmaxf(mx[e >> 1], s[ni][e]);
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(mxt::kFullMask, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(mxt::kFullMask, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h]), mnl = mn * sl2;
      alpha[h] = exp2f(ml[h] - mnl);
      m[h] = mn;
      ml[h] = mnl;
    }
    masked_exp<NT>(s, sl2, [&](int h, int) { return ml[h]; }, visible);
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] *= alpha[h];
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      l[0] += s[ni][0] + s[ni][1];
      l[1] += s[ni][2] + s[ni][3];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // O += P · V, P straight from the registers
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t a_hi[4], a_lo[4];
      acc_as_a(s[j], a_hi, a_lo);
      if constexpr (kBf16) accumulate_step_exact_b<ND, LD>(a_hi, a_lo, vs + j * 8 * LD, acc);
      else accumulate_step<ND, LD>(a_hi, a_lo, vs + j * 8 * LD, acc);
    }
  }
  cp_async_wait<0>();
  if constexpr (GROUPS > 1) merge_groups<GROUPS>(m, ml, l, acc, smem, sl2);
  if (group != 0) return;

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(mxt::kFullMask, l[h], 1);
    l[h] += __shfl_xor_sync(mxt::kFullMask, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int ni = 0; ni < ND; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e >> 1), col = ni * 8 + 2 * t + (e & 1);
      if (row < T && col < D)  // the bf16 form rounds O once, to nearest even
        mxt::st1(a.o + qbase + static_cast<size_t>(row) * D + col, acc[ni][e] / l[e >> 1]);
    }
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + 8 * h;
      if (row < T) a.lse[static_cast<size_t>(bh) * T + row] = m[h] * a.scale + logf(l[h]);
    }
  }
}

// The f32 kernel and the bf16 form, under names of their own (the profiler
// attributes device time by name).
template <int GROUPS, int DMAX, bool VEC>
__global__ void __launch_bounds__(kWarps * GROUPS * 32, 1)
flash_fwd_kernel(const Args<float> a) {
  flash_fwd<float, GROUPS, DMAX, VEC>(a);
}

template <int GROUPS, int DMAX, bool VEC>
__global__ void __launch_bounds__(kWarps * GROUPS * 32, 1)
flash_fwd_bf16_kernel(const Args<__nv_bfloat16> a) {
  flash_fwd<__nv_bfloat16, GROUPS, DMAX, VEC>(a);
}

template <typename Elem, int GROUPS, int DMAX, bool VEC>
auto kernel_of() {
  if constexpr (mxt::IsBf16<Elem>::value) return &flash_fwd_bf16_kernel<GROUPS, DMAX, VEC>;
  else return &flash_fwd_kernel<GROUPS, DMAX, VEC>;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// A launch over the table's nblocks blocks of kRows query rows; refuses a
// table of any other length.
template <typename Elem, int GROUPS, int DMAX>
int run(const Args<Elem>& a, int nblocks, cudaStream_t st) {
  using C = Cfg<GROUPS, DMAX>;
  if (a.blocks == nullptr || nblocks != (a.T + kRows - 1) / kRows || nblocks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte loads: every row of Q, K and V starts on 16 bytes (4 floats or
  // 8 bf16 a load)
  const bool vec = a.D % (16 / static_cast<int>(sizeof(Elem))) == 0 && aligned16(a.q) &&
                   aligned16(a.k) && aligned16(a.v);
  void (*kernel)(const Args<Elem>) = vec ? kernel_of<Elem, GROUPS, DMAX, true>()
                                         : kernel_of<Elem, GROUPS, DMAX, false>();
  static bool raised[2] = {false, false};
  const cudaError_t e = mxt::raise_smem(kernel, C::SMEM, &raised[vec]);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(a.BH, nblocks), C::THREADS, C::SMEM, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Elem>
bool shapes_taken(const Args<Elem>& a) {
  return a.BH >= 1 && a.T >= 1 && a.S >= 1 && a.D >= 1 && a.D <= kMaxD &&
         !(a.causal && a.S < a.T);
}

template <typename Elem>
int launch(const Args<Elem>& a, int nblocks, void* stream) {
  if (!shapes_taken(a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.D <= 64) return run<Elem, 2, 64>(a, nblocks, st);
  return run<Elem, 1, 128>(a, nblocks, st);
}

}  // namespace

// blocks, nblocks: each block's query rows and key range (ops/flash_attention.py
// _tiles, the dq kernel's table), int32 on the card.
extern "C" int mxt_flash_attention_fwd(const float* q, const float* k, const float* v,
                                       float* o, float* lse, const int* blocks, int nblocks,
                                       int BH, int T, int S, int D, float scale, int causal,
                                       void* stream) {
  return launch(Args<float>{q, k, v, o, lse, blocks, BH, T, S, D, scale, causal}, nblocks,
                stream);
}

// The bf16 form: q, k, v and o bf16, lse f32; the same table and shapes.
extern "C" int mxt_flash_attention_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                            const __nv_bfloat16* v, __nv_bfloat16* o,
                                            float* lse, const int* blocks, int nblocks, int BH,
                                            int T, int S, int D, float scale, int causal,
                                            void* stream) {
  return launch(Args<__nv_bfloat16>{q, k, v, o, lse, blocks, BH, T, S, D, scale, causal},
                nblocks, stream);
}
