// The pieces of the flash-attention kernels on the tensor cores (3xTF32 on
// mma.sync, tf32x3.cuh): the staging of row tiles through cp.async, a warp's
// score tile, the masked exp against a per-row offset (the running max in
// the forward, the logsumexp in the backward), and the reuse of a score
// tile's accumulator as the A operand of the next product. The forward
// (flash_attention.cu) and the backward's two passes (flash_attention_bwd.cu)
// are built from them, and the bf16 forms of all three from the bf16 pieces
// at the end.
//
// The layout they share: every operand tile lies in shared memory row-major,
// LD floats a row with LD = 8 mod 32, one row a query or key, its columns the
// head dimension d. A warp owns 16 rows of the A side. Products along d
// (scores) read a thread's two k of an 8-deep step, columns 2t and 2t + 1,
// as one 8-byte load (tf32x3.cuh's k permutation). A score tile's column c
// of n-tile ni is row ni·8 + col_row(c) of the B tile: a thread's accumulator
// columns 2t and 2t + 1 are then B rows t and 4 + (t + 2) % 4, and the
// product that accumulates along those rows (dS·K, Pᵀ·dO) takes them as its
// k = t and k = t + 4 (acc_as_a, accumulate_step). Both products' loads are
// free of bank conflicts: the 8-byte loads of rows col_row(g) of a half-warp
// fall on the bank groups 0, 16, 8, 24 (g = 0..3) and 16, 0, 24, 8 (g = 4..7),
// and the 4-byte loads of rows t and 4 + (t + 2) % 4 at column g on 0, 8,
// 16, 24 and 16, 24, 0, 8.
#pragma once

#include "bf16_mma.cuh"
#include "tf32x3.cuh"

namespace mxt {
namespace flash {

using namespace mxt::tf32x3;

// The B row behind column c (0..7) of a score n-tile.
__device__ __forceinline__ int col_row(int c) {
  return (c & 1) ? 4 + (((c >> 1) + 2) & 3) : c >> 1;
}

// Rows r0 .. r0 + ROWS - 1, columns 0 .. DW - 1 of an (n, D) row-major
// matrix into shared memory, LD floats a row, by cp.async: rows >= n and
// columns >= D are zero-filled, so products may run over all DW columns.
// VEC: 16-byte copies (D % 4 == 0 and a 16-byte aligned base), else 4-byte
// copies. The caller commits the group.
template <int ROWS, int DW, int LD, int THREADS, bool VEC>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int r0, int n, int D) {
  constexpr int W = VEC ? 4 : 1, PER_ROW = DW / W;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * W;
    const bool p = r0 + r < n && c < D;
    const float* from = p ? src + static_cast<size_t>(r0 + r) * D + c : src;
    if (VEC) cp_async16(dst + r * LD + c, from, p);
    else cp_async4(dst + r * LD + c, from, p);
  }
}

// One warp's score tile: acc[ni] = a · bᵀ over the DW columns for the 16
// rows at a and the NT·8 rows of b (column c of n-tile ni is row ni·8 +
// col_row(c)). No branch inside: the whole tile is one block of
// straight-line code.
template <int NT, int DW, int LD>
__device__ __forceinline__ void score_tile(const float* a, const float* b, float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) acc[ni][0] = acc[ni][1] = acc[ni][2] = acc[ni][3] = 0.f;
  const float* ar = a + g * LD + 2 * t;
  const float* br = b + col_row(g) * LD + 2 * t;
#pragma unroll
  for (int kk = 0; kk < DW; kk += 8) {
    uint32_t a_hi[4], a_lo[4], b_hi[NT][2], b_lo[NT][2];
    split2(ar + kk, a_hi[0], a_lo[0], a_hi[2], a_lo[2]);
    split2(ar + 8 * LD + kk, a_hi[1], a_lo[1], a_hi[3], a_lo[3]);
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
      split2(br + ni * 8 * LD + kk, b_hi[ni][0], b_lo[ni][0], b_hi[ni][1], b_lo[ni][1]);
    mma3_tiles(acc, a_hi, a_lo, b_hi, b_lo);
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// In place over a score tile: P = exp(s·scale − m) = 2^(s·scale_log2 −
// m_log2) where visible(r, c), else exactly 0, so that a padded row, whose
// m is not defined, and a masked score never reach the exponential.
// scale_log2 = scale·log2(e) and m_log2(h, c) = m·log2(e), each rounded to
// f32 once, make the argument one FMA and the exponential one exp2f: at the
// training shape that keeps O and the logsumexp within a tenth of 1e-5, and
// dQ, dK and dV within a tenth of 1e-4, of float64 (tests/test_torch_tf32x3.py
// emulates both). Element e
// of n-tile ni is the tile's row r = g + 8·(e / 2) and column c = ni·8 +
// col_row(2t + e % 2); m_log2(h, c) is the offset of row g + 8h at column c
// (the row's logsumexp, times log2(e)).
template <int NT, typename Offset, typename Visible>
__device__ __forceinline__ void masked_exp(float (&s)[NT][4], float scale_log2, Offset m_log2,
                                           Visible visible) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e >> 1), c = ni * 8 + col_row(2 * t + (e & 1));
      s[ni][e] = visible(r, c) ? exp2f(s[ni][e] * scale_log2 - m_log2(e >> 1, c)) : 0.f;
    }
  }
}

// A score n-tile's accumulator as the split A fragment of one 8-deep step
// of the next product: a thread holds d[0] (g, 2t), d[1] (g, 2t + 1),
// d[2] (g + 8, 2t), d[3] (g + 8, 2t + 1), and the A fragment wants (g, k = t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4). With k = t at column 2t and
// k = t + 4 at column 2t + 1 that is d[0], d[2], d[1], d[3]: no shuffle and
// no trip through shared memory.
__device__ __forceinline__ void acc_as_a(const float (&d)[4], uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split(d[0], hi[0], lo[0]);
  split(d[2], hi[1], lo[1]);
  split(d[1], hi[2], lo[2]);
  split(d[3], hi[3], lo[3]);
}

// acc[ni] += a · b for one 8-deep step whose 8 rows (k) start at b, over
// the output columns ni·8 .. ni·8 + 7: k = t is row col_row(2t) and
// k = t + 4 row col_row(2t + 1), as acc_as_a's columns.
template <int ND, int LD>
__device__ __forceinline__ void accumulate_step(const uint32_t (&a_hi)[4],
                                                const uint32_t (&a_lo)[4], const float* b,
                                                float (&acc)[ND][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* b0 = b + t * LD + g;
  const float* b1 = b + (4 + ((t + 2) & 3)) * LD + g;
  constexpr int N = ND < 8 ? ND : 8;  // n-tiles in flight: 8 at D = 128 too
#pragma unroll
  for (int n0 = 0; n0 < ND; n0 += N) {
    uint32_t b_hi[N][2], b_lo[N][2];
    float part[N][4];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      split(b0[(n0 + n) * 8], b_hi[n][0], b_lo[n][0]);
      split(b1[(n0 + n) * 8], b_hi[n][1], b_lo[n][1]);
#pragma unroll
      for (int i = 0; i < 4; ++i) part[n][i] = acc[n0 + n][i];
    }
    mma3_tiles(part, a_hi, a_lo, b_hi, b_lo);
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n0 + n][i] = part[n][i];
  }
}

// ---- bf16 operands: the bf16 forms (flash_attention.cu's
// mxt_flash_attention_fwd_bf16, flash_attention_bwd.cu's _dq_bf16 and
// _dkv_bf16). Q, K, V (and dO) are bf16 in device memory and are widened into
// the f32 shared-memory tiles above, so every layout note holds.
// A bf16 value is exact in f32 and in TF32, which sets the products' cost:
// - S = Q·Kᵀ: one bf16 mma.sync a step (bf16_mma.cuh), its products exact
//   and summed in f32, where the f32 form takes three TF32 products;
// - O += P·V: P stays f32, as the TPU kernel keeps it (pallas_attention.py
//   :106-108 rounds nothing before the product), split into TF32 hi and lo
//   as in the f32 form; V has no lo part, so a step takes two products for
//   three, at the same f32 accuracy.

// stage_rows for a bf16 matrix: its rows widened into the same f32 tiles
// (zeros past n and D). The loads go through registers, since cp.async copies
// words and cannot widen them: VEC loads 8 bf16 at once (D % 8 == 0 and a
// 16-byte aligned base), else one. The stores are plain, so the caller's
// __syncthreads, which the f32 form's cp.async ring has anyway, publishes them.
template <int ROWS, int DW, int LD, int THREADS, bool VEC>
__device__ __forceinline__ void stage_rows(float* dst, const __nv_bfloat16* src, int r0, int n,
                                           int D) {
  constexpr int W = VEC ? 8 : 1, PER_ROW = DW / W;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * W;
    const bool p = r0 + r < n && c < D;
    float* to = dst + r * LD + c;
    if (VEC) {
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (p) {
        const uint4 u =
            __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * D + c));
        lo = make_float4(bits_lo(u.x), bits_hi(u.x), bits_lo(u.y), bits_hi(u.y));
        hi = make_float4(bits_lo(u.z), bits_hi(u.z), bits_lo(u.w), bits_hi(u.w));
      }
      *reinterpret_cast<float4*>(to) = lo;
      *reinterpret_cast<float4*>(to + 4) = hi;
    } else {
      *to = p ? ldg1(src + static_cast<size_t>(r0 + r) * D + c) : 0.f;
    }
  }
}

// score_tile on bf16 values held in f32 tiles: one bf16 mma.sync m16n8k8 a
// step, whose register holds k = 2t and 2t + 1, read as columns 2t and 2t + 1
// (score_tile's 8-byte loads: one permutation of a step's k for both operands
// leaves the product as it is). Each step goes into a fresh accumulator added
// to acc with one rounding, as mma3 does.
template <int NT, int DW, int LD>
__device__ __forceinline__ void score_tile_bf16(const float* a, const float* b,
                                                float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) acc[ni][0] = acc[ni][1] = acc[ni][2] = acc[ni][3] = 0.f;
  const float* ar = a + g * LD + 2 * t;
  const float* br = b + col_row(g) * LD + 2 * t;
#pragma unroll
  for (int kk = 0; kk < DW; kk += 8) {
    const float2 a0 = *reinterpret_cast<const float2*>(ar + kk);
    const float2 a1 = *reinterpret_cast<const float2*>(ar + 8 * LD + kk);
    const uint32_t af[2] = {bf16::pack(a0.x, a0.y), bf16::pack(a1.x, a1.y)};
    float d[NT][4];
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const float2 bv = *reinterpret_cast<const float2*>(br + ni * 8 * LD + kk);
      d[ni][0] = d[ni][1] = d[ni][2] = d[ni][3] = 0.f;
      bf16::mma(d[ni], af, bf16::pack(bv.x, bv.y));
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[ni][i] += d[ni][i];
  }
}

// accumulate_step for a b whose values are exact in TF32 (bf16 values
// widened): its lo part is zero, so a step is a_lo·b then a_hi·b into a fresh
// accumulator, added to acc with one rounding (mma3's order without the
// b_lo term).
template <int ND, int LD>
__device__ __forceinline__ void accumulate_step_exact_b(const uint32_t (&a_hi)[4],
                                                        const uint32_t (&a_lo)[4],
                                                        const float* b, float (&acc)[ND][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* b0 = b + t * LD + g;
  const float* b1 = b + (4 + ((t + 2) & 3)) * LD + g;
  constexpr int N = ND < 8 ? ND : 8;
#pragma unroll
  for (int n0 = 0; n0 < ND; n0 += N) {
    uint32_t bf[N][2];
    float d[N][4];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      bf[n][0] = __float_as_uint(b0[(n0 + n) * 8]);
      bf[n][1] = __float_as_uint(b1[(n0 + n) * 8]);
      d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < N; ++n) mma(d[n], a_lo, bf[n]);
#pragma unroll
    for (int n = 0; n < N; ++n) mma(d[n], a_hi, bf[n]);
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n0 + n][i] += d[n][i];
  }
}

}  // namespace flash
}  // namespace mxt
