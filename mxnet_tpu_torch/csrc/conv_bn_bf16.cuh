// The bf16 implicit GEMM of the conv + BatchNorm kernels on Hopper: bf16
// staged as bf16 in shared memory, the products on wgmma (wgmma.cuh). The
// forward's three bf16 forms (conv_bn_bf16.cu) and the backward's dgrad
// (conv_bn_bf16_bwd.cu) run it; the f32 kernels keep conv_bn.cuh's
// tc_mainloop.
//
// It computes, for one block's tile,
//   acc[m, q] = Σ_c Σ_t A[m, c·TAPS + t] · xn[c, q + s_t],
// the rows m of A (M, KC·TAPS) against a staged NCHW operand X (B, C, H, W),
// xn = prologue(X) or X, s_t the tap's shift (3x3, pad 1) or the stride's
// sampling (1x1), as tc_mainloop does (the forward: A = w, X = x; the dgrad:
// A = w transposed and flipped, X = dce). What the TPU kernel it replaces
// computes is mxnet_tpu/ops/pallas_conv_bn.py _kernel (:240-291) on bf16
// operands: the prologue in bf16 with two roundings, exact bf16 products
// summed in f32.
//
// Why this design (the kernels it replaces widened bf16 to f32 in shared
// memory, loaded each chunk with synchronous loads and built every bf16
// fragment from scalar f32 reads, one m16n8k8 a step, which left them bound
// by instruction issue at 2.4-8.5x the library's bf16 convolution):
// - Two warpgroups a block (256 threads). The block owns BM = 64 or 128 rows
//   (64 where M ≤ 64: then the two groups split the positions) by BN
//   positions: 64 of the flattened B·H'W' axis (1x1), or a TH x 8 pixel tile
//   of one image (3x3; TH = 14 where the grid's height is a multiple of 14,
//   7 where of 7, else 8), so ResNet-50's 56, 28, 14 and 7 grids waste at
//   most an eighth of a tile, where 8 x 8 tiles staged 23-31 % padding.
// - A (w or wt) is copied as it lies (rows along the contraction) into the
//   ring with 16-byte cp.async, in its storage type (the serving form's f32
//   too), and the warps build wgmma's A fragments from it in registers: a
//   3x3 w row interleaves the taps along its channels (OIHW), so a tap's 16
//   channels are 18 bytes apart and no 16-byte row of a core matrix exists
//   for a descriptor; from registers each element is read once a warp.
// - X is staged as bf16 core matrices of 8 x 16 bytes, by cp.async where
//   NCHW rows allow it and register-staged elsewhere, with the BatchNorm
//   prologue applied once an element in bf16 with the two roundings of
//   bf16::prologue (0 outside the image or past the channels) before any
//   product reads it:
//   - 1x1 at stride 1 on bf16 x with H'W' even (XVEC): MN-major rows of 8
//     positions of one channel, copied by cp.async (one 16-byte copy where
//     H'W' % 8 == 0, four 4-byte pairs where the 8 span two images), the
//     prologue applied in place by the thread that copied the row once it
//     landed; EMIT (the stash forms) writes xn from those values.
//   - 1x1 elsewhere (stride 2, odd H'W', the serving form's f32 x): K-major
//     rows of 8 channels of one position, gathered into registers a stage
//     ahead (the loads run while the current stage's products do), then
//     the prologue, the packing and a 16-byte store.
//   - 3x3: a thread a (channel, halo row): the row's 10 pixels ox0 − 1 ..
//     ox0 + 8 in the widest aligned loads W allows (16 bytes where W % 8 ==
//     0) a stage ahead, then stored three times as MN-major rows of 8
//     pixels shifted by 0, 1 and 2 columns ([shift][halo row][channel
//     group][8 channels][8 pixels]): a tap (dy, dx) is then the shift-dx
//     copy from dy rows in, a descriptor with no misaligned row (a 1-pixel
//     shift is 2 bytes, and a core-matrix row must be 16-byte aligned).
// - The epilogue stages the f32 tile in the ring (stage_tile) and writes c
//   (dx) a row a warp along consecutive positions; the training forward's
//   residual and the dgrad's x and xn tiles are copied past the ring by
//   cp.async before the main loop (copy_tile), so their loads hide behind
//   the products, and the per-channel sums run a row a thread over the
//   staged tile (row_sums2), in a fixed order, with no shuffles.
// - The ring is 3 stages deep (2 for the serving form's f32 3x3 A); a stage
//   is 64 channels (1x1) or 16 channels x 9 taps (3x3).
// - Accumulation: the products of bf16 values are exact in f32, but the
//   tensor cores truncate as they accumulate. Each stage's products go into
//   a fresh accumulator (scale-d = 0 on its first product: the first stage's
//   is acc itself), added to acc with one rounding to nearest, as
//   tf32x3.cuh's mma3 and the kernels before did for each stage
//   (tests/test_torch_conv_bn_bf16_tiles.py emulates the sums).
#pragma once

#include "bf16_mma.cuh"
#include "common.cuh"
#include "conv_bn.cuh"
#include "tf32x3.cuh"
#include "wgmma.cuh"

namespace mxt {
namespace convbn16 {

using convbn::ceil_div;
using convbn::Geo;
using tf32x3::cp_async16;
using tf32x3::cp_async4;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kTileP = 64;     // 1x1: flattened positions a block
constexpr int kTileW = 8;      // 3x3: pixel columns a tile
constexpr int kHaloW = kTileW + 2;

// The 3x3 tile's height for an output grid of Ho rows (ops/conv_bn.py
// _bf16_tile_h).
__host__ __device__ inline int tile_h(int Ho) {
  return Ho % 14 == 0 ? 14 : (Ho % 7 == 0 ? 7 : 8);
}

// Warpgroups along rows: 2 where there are more than 64 rows, or where a
// 7-row tile (56 positions) cannot be halved into whole pixel rows.
__host__ __device__ inline int tile_wm(int M, int taps, int th) {
  return M > 64 || (taps == 9 && th == 7) ? 2 : 1;
}

// The position tiles of the forward and the dgrad, one partial-statistics
// row each (ops/conv_bn.py _fwd_parts at bf16).
inline int parts(const Geo& g, int taps) {
  if (taps == 1) return ceil_div(g.B * g.Ho * g.Wo, kTileP);
  return g.B * ceil_div(g.Ho, tile_h(g.Ho)) * ceil_div(g.Wo, kTileW);
}

// The shapes of one instantiation: TAPS, the 3x3 tile height TH, WM
// warpgroups along rows, T the storage of A (and X).
template <int TAPS, int TH, int WM, typename T>
struct Fwd {
  static constexpr int BN = TAPS == 1 ? kTileP : kTileW * TH;  // positions a block
  static constexpr int GM = WM;                                 // warpgroups along rows
  static constexpr int WN = 2 / WM;                             // ... and along positions
  static constexpr int BM = 64 * WM;                            // rows a block
  static constexpr int NW = BN / WN;                            // a warpgroup's columns
  static constexpr int R = NW / 2;                              // its results a thread
  static constexpr int BK = TAPS == 1 ? 64 : 16;                // channels a stage
  static constexpr int KW = BK * TAPS;                          // A columns a stage
  static constexpr int STEPS = TAPS == 1 ? BK / 16 : 9;         // k16 products a stage
  static constexpr int ES = sizeof(T);
  // A rows padded so that the fragment reads of a warp fall on distinct banks
  static constexpr int AROW = KW * ES + (TAPS == 1 && ES == 4 ? 32 : 16);  // 144, 288, 304, 592
  static constexpr int ABYTES = BM * AROW;
  static constexpr int HROWS = TH + 2;
  static constexpr int DXB = HROWS * 2 * 128;  // 3x3: one column shift of the bordered tile
  static constexpr int XBYTES = TAPS == 1 ? BN * BK * 2 : 3 * DXB;
  static constexpr int STAGE = ABYTES + XBYTES;
  static constexpr int S = TAPS == 9 && ES == 4 ? 2 : 3;
  static constexpr int SMEM = S * STAGE;
  // blocks an SM: two for the bf16 1x1 tiles (at most 128 registers a
  // thread), whose short contractions leave a block's loads and epilogue
  // exposed unless another block computes beside it
  static constexpr int MINB = TAPS == 1 && ES == 2 ? 2 : 1;
  // the epilogue's f32 tile [BM][LD], LD ≡ 8 (mod 32) floats: the wgmma
  // layout's float2 stores of a half-warp fall on distinct banks
  static constexpr int LD = BN + (40 - BN % 32) % 32;
  // a [BM][BN] bf16 tile past the ring: the training forward's residual,
  // the dgrad's x and xn (copy_tile)
  static constexpr int RES = ES == 2 ? BM * BN * 2 : 0;
  static_assert(NW % 8 == 0 && NW <= 128, "a warpgroup's columns are whole pixel rows");
  static_assert(STAGE % 16 == 0 && SMEM + 2 * RES <= 227 * 1024, "shared memory");
  static_assert(2 * BM * LD * 4 <= SMEM, "the epilogue's two tiles fit the ring");
};

// The operands of one implicit GEMM, stored as T (float: the serving form,
// rounded to bf16 as staged; __nv_bfloat16). X has C channels on the grid
// (H, W) that the output grid (Ho, Wo) samples with stride; A has M rows of
// KC·TAPS columns, KC ≥ C a multiple of 8 (columns of the channels c ≥ C
// are zero in A, and X's are staged as zeros).
template <typename T>
struct Args {
  const T* a;
  const T* x;
  const T* scale;  // the prologue on X (PRO), else unused
  const T* shift;
  int M, KC, C;
  int B, H, W, Ho, Wo, stride;
  bool relu;
  T* xn;  // EMIT: the prologue's output (B, C, Ho, Wo), else unused
};

// An X element as the products take it: the bf16 prologue on the bf16
// roundings of v, sc and sh (PRO), or v rounded to bf16.
template <bool PRO>
__device__ __forceinline__ float staged(float v, float sc, float sh, bool relu) {
  if (PRO)
    return bf16::prologue(bf16::round_bf16(v), bf16::round_bf16(sc), bf16::round_bf16(sh), relu);
  return bf16::round_bf16(v);
}

__device__ __forceinline__ uint32_t bits2(float lo, float hi) { return bf16::pack(lo, hi); }

__device__ __forceinline__ void sts128(void* p, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  *reinterpret_cast<uint4*>(p) = make_uint4(a, b, c, d);
}

// Two A elements (row-major T in shared memory, element offsets e0 and e1 of
// one row) as one register of two bf16, e0 in the low half.
template <typename T>
__device__ __forceinline__ uint32_t a_pair(const char* row, int e0, int e1) {
  if constexpr (IsBf16<T>::value) {
    const uint32_t lo = *reinterpret_cast<const unsigned short*>(row + 2 * e0);
    const uint32_t hi = *reinterpret_cast<const unsigned short*>(row + 2 * e1);
    return lo | (hi << 16);
  } else {
    return bf16::pack(*reinterpret_cast<const float*>(row + 4 * e0),
                      *reinterpret_cast<const float*>(row + 4 * e1));
  }
}

// Two consecutive A elements (e, e + 1; e even) as one bf16 register.
template <typename T>
__device__ __forceinline__ uint32_t a_pair2(const char* row, int e) {
  if constexpr (IsBf16<T>::value) {
    return *reinterpret_cast<const uint32_t*>(row + 2 * e);
  } else {
    const float2 v = *reinterpret_cast<const float2*>(row + 4 * e);
    return bf16::pack(v.x, v.y);
  }
}

// Column col of position tile pt: its image b and output pixel (oy, ox);
// false past the grid's edge.
template <int TAPS, int TH>
__device__ __forceinline__ bool tile_col(const Geo& geo, int pt, int col, int* b, int* oy,
                                         int* ox) {
  const int HWo = geo.Ho * geo.Wo;
  if (TAPS == 1) {
    const int q = pt * kTileP + col;
    *b = q < geo.B * HWo ? q / HWo : 0;
    const int p = q - *b * HWo;
    *oy = p / geo.Wo;
    *ox = p - *oy * geo.Wo;
    return q < geo.B * HWo;
  }
  const int tiles_x = ceil_div(geo.Wo, kTileW);
  const int per_img = ceil_div(geo.Ho, TH) * tiles_x;
  *b = pt / per_img;
  const int tile = pt - *b * per_img;
  *oy = (tile / tiles_x) * TH + col / kTileW;
  *ox = (tile % tiles_x) * kTileW + col % kTileW;
  return *oy < geo.Ho && *ox < geo.Wo;
}

// Issues one stage's products into d (scale-d = 0 on the first: a fresh
// accumulator). a: the stage's A fragments; xs: its X staging; r0: the
// warpgroup's first column group (1x1: 8 positions; 3x3: a pixel row).
template <class F, int TAPS, bool XVEC>
__device__ __forceinline__ void issue(float (&d)[F::R], const uint32_t (&a)[F::STEPS][4],
                                      const char* xs, int r0) {
  if constexpr (TAPS == 1 && XVEC) {
    // MN-major [channel group][position group][8 channels][8 positions]: K
    // (channels) steps 8 · 128 bytes, N (positions) 128
    const uint64_t b = wg::desc(xs + r0 * 128, (F::BN / 8) * 128, 128);
#pragma unroll
    for (int s = 0; s < F::STEPS; ++s)
      wg::Mma<F::NW>::template rs<1>(d, a[s], wg::advance(b, s * 2 * (F::BN / 8) * 128), s);
  } else if constexpr (TAPS == 1) {
    // [position group][channel group][8 positions][8 channels]: K (channels)
    // steps 128 bytes, N (positions) 8 · 128
    const uint64_t b = wg::desc(xs + r0 * (F::BK / 8) * 128, 128, (F::BK / 8) * 128);
#pragma unroll
    for (int s = 0; s < F::STEPS; ++s)
      wg::Mma<F::NW>::template rs<0>(d, a[s], wg::advance(b, s * 256), s);
  } else {
    // MN-major [column shift][halo row][channel group][8 channels][8
    // pixels]: K (channels) steps 128 bytes, N (pixel rows) 256; tap (dy,
    // dx) reads shift dx from dy rows in
    const uint64_t b = wg::desc(xs + r0 * 256, 128, 256);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      wg::Mma<F::NW>::template rs<1>(d, a[tap],
                                     wg::advance(b, (tap % 3) * F::DXB + (tap / 3) * 256), tap);
  }
}

// Elements ox0 .. ox0 + 7 of a row of W elements (ox0 a multiple of 8, the
// row's first element at an offset that is a multiple of W from a 16-byte
// aligned base) into v, 0 past the row: in the widest loads the alignment
// allows (16 bytes where W % 8 == 0 for bf16, W % 4 == 0 for f32).
template <typename T>
__device__ __forceinline__ void load8(const T* row, int ox0, int W, float (&v)[8]) {
  const T* p = row + ox0;
  if constexpr (IsBf16<T>::value) {
    if (W % 8 == 0) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) v[2 * i] = bits_lo(w[i]), v[2 * i + 1] = bits_hi(w[i]);
      return;
    }
    if (W % 4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 f = ox0 + 4 * h < W ? ldg4(p + 4 * h) : make_float4(0.f, 0.f, 0.f, 0.f);
        v[4 * h] = f.x, v[4 * h + 1] = f.y, v[4 * h + 2] = f.z, v[4 * h + 3] = f.w;
      }
      return;
    }
  } else if (W % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 f = ox0 + 4 * h < W ? ldg4(p + 4 * h) : make_float4(0.f, 0.f, 0.f, 0.f);
      v[4 * h] = f.x, v[4 * h + 1] = f.y, v[4 * h + 2] = f.z, v[4 * h + 3] = f.w;
    }
    return;
  }
  if (W % 2 == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = ox0 + 2 * i < W ? ldg2(p + 2 * i) : make_float2(0.f, 0.f);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = ox0 + i < W ? ldg1(p + i) : 0.f;
}

// Fills acc with the block's tile (position tile pt, rows m0 .. m0 + BM − 1)
// in the wgmma layout (wgmma.cuh) of warpgroup wg: rows 64·wm + 16·warp +
// g (+ 8), columns wn·NW + 8j + 2t (+ 1), wm = WM == 2 ? wg : 0, wn = WM ==
// 2 ? 0 : wg. smem: F::SMEM bytes, free on return. EMIT (with PRO): the
// blocks with m0 == 0 write g.xn, each element once, the value the products
// take (3x3: the pixels the block owns, not its border). XVEC (1x1, bf16,
// stride 1, H'W' even): X's rows of 8 positions are copied MN-major, one
// 16-byte copy where H'W' % 8 == 0, else four 4-byte pairs (the 8 may span
// two images), and normalised in place as they land.
template <int TAPS, int TH, int WM, typename T, bool PRO, bool EMIT, bool XVEC>
__device__ __forceinline__ void mainloop(const Args<T>& g, int pt, int m0, char* smem,
                                         float (&acc)[Fwd<TAPS, TH, WM, T>::R]) {
  using F = Fwd<TAPS, TH, WM, T>;
  static_assert(PRO || !EMIT, "xn is the prologue's output");
  static_assert(!XVEC || (TAPS == 1 && IsBf16<T>::value), "copies of bf16 1x1 rows");
  const bool emit = EMIT && m0 == 0;
  const int tid = threadIdx.x, lane = tid & 31, wgi = tid >> 7, warp = (tid >> 5) & 3;
  const int gq = lane >> 2, t = lane & 3;
  const int wm = WM == 2 ? wgi : 0, wn = WM == 2 ? 0 : wgi;
  const int HWo = g.Ho * g.Wo;
  const size_t HW = static_cast<size_t>(g.H) * g.W;
  const int a_row = g.KC * TAPS;
  constexpr int EPC = 16 / F::ES;     // A elements a 16-byte copy
  constexpr int CPR = F::KW / EPC;    // copies along a staged A row

  // ---- where this thread's X items come from, once a block.
  // 1x1: an item is 8 channels of one position (K-major) or, XVEC, 8
  //      positions of one channel (MN-major: [channel group][position
  //      group][8 channels][8 positions], each 16-byte row one copy); two
  //      items a thread: position n and channel groups kg0, kg0 + 4 of a
  //      stage, or (XVEC) position group (tid >> 3) & 7 and channels kl,
  //      kl + 32.
  // 3x3: one item a thread, channel tid % 16 of a stage and halo row tid /
  //      16: the row's 10 pixels ox0 − 1 .. ox0 + 8, read as one aligned
  //      piece of 8 (load8) and its two neighbours, staged three times as
  //      MN-major core-matrix rows of 8 pixels, shifted by 0, 1 and 2
  //      columns, so that every tap's B is a descriptor into one of them.
  constexpr int kItems = TAPS == 1 ? 2 : 1;
  size_t src[kItems];   // X offset at channel 0 (3x3: of the halo row)
  size_t xo[kItems];    // EMIT: xn offset at channel 0
  int dst[kItems];      // byte offset in the X staging; -1: no item
  int kg[kItems];       // the item's channel group (XVEC, 3x3: its channel)
  bool ok[kItems];      // a position of the grid (1x1) / the halo row inside the image (3x3)
  bool own[kItems];     // 3x3: a pixel row of the block's own tile
  int ox0 = 0;          // 3x3: the tile's first column
  // XVEC with H'W' % 8 != 0: the X offsets (channel 0) of the row's four
  // position pairs, and which of them are positions of the grid
  const bool x4 = XVEC && HWo % 8 != 0;
  size_t pof[4] = {0, 0, 0, 0};
  unsigned pin = 0;
  if (TAPS == 1) {
    const int n = XVEC ? ((tid >> 3) & 7) * 8 : tid & 63;
    const int q = pt * kTileP + n;
    const bool valid = q < g.B * HWo;  // XVEC: the row's first pair in the grid
    if (x4) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qj = q + 2 * j;
        const int bj = qj < g.B * HWo ? qj / HWo : 0;
        pof[j] = static_cast<size_t>(bj) * g.C * HW + (qj - bj * HWo);
        pin |= (qj < g.B * HWo ? 1u : 0u) << j;
      }
    }
    const int b = valid ? q / HWo : 0, p = q - b * HWo;
    const int oy = p / g.Wo, ox = p - oy * g.Wo;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      kg[i] = XVEC ? (tid & 7) + 8 * (tid >> 6) + 32 * i : (tid >> 6) + 4 * i;
      ok[i] = valid;
      own[i] = valid;
      src[i] = static_cast<size_t>(b) * g.C * HW + static_cast<size_t>(oy * g.stride) * g.W +
               ox * g.stride;
      xo[i] = static_cast<size_t>(b) * g.C * HWo + p;
      dst[i] = XVEC ? ((kg[i] >> 3) * (F::BN / 8) + (n >> 3)) * 128 + (kg[i] & 7) * 16
                    : ((n >> 3) * (F::BK / 8) + kg[i]) * 128 + (n & 7) * 16;
    }
  } else {
    const int tiles_x = ceil_div(g.Wo, kTileW);
    const int per_img = ceil_div(g.Ho, TH) * tiles_x;
    const int b3 = pt / per_img, tile = pt - b3 * per_img;
    const int oy0 = (tile / tiles_x) * TH;
    ox0 = (tile % tiles_x) * kTileW;
    const int hy = tid >> 4, iy = oy0 - 1 + hy;
    kg[0] = tid & 15;
    ok[0] = hy < F::HROWS && iy >= 0 && iy < g.H;
    own[0] = ok[0] && hy >= 1 && hy <= TH;
    src[0] = static_cast<size_t>(b3) * g.C * HW + (ok[0] ? static_cast<size_t>(iy) * g.W : 0);
    xo[0] = src[0];
    dst[0] = hy < F::HROWS ? (hy * 2 + (kg[0] >> 3)) * 128 + (kg[0] & 7) * 16 : -1;
  }

  // ---- a chunk's asynchronous copies: A's rows, and XVEC X's
  auto copy = [&](int s, int k0) {
    char* as = smem + s * F::STAGE;
    for (int ch = tid; ch < F::BM * CPR; ch += kThreads) {
      const int r = ch / CPR, c = ch - r * CPR;
      const int col = k0 * TAPS + c * EPC;
      const bool p = m0 + r < g.M && col < a_row;
      cp_async16(as + r * F::AROW + c * 16, p ? g.a + static_cast<size_t>(m0 + r) * a_row + col
                                              : g.a, p);
    }
    if constexpr (XVEC) {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int ch = k0 + kg[i];
        const bool p = ok[i] && ch < g.C;
        char* to = as + F::ABYTES + dst[i];
        if (!x4) {
          cp_async16(to, p ? g.x + src[i] + static_cast<size_t>(ch) * HW : g.x, p);
          continue;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool pj = p && (pin >> j & 1u);
          cp_async4(to + 4 * j, pj ? g.x + pof[j] + static_cast<size_t>(ch) * HW : g.x, pj);
        }
      }
    }
  };
  // XVEC: the prologue (and EMIT's xn) on this thread's copied rows once
  // they landed; a row past the channels or the positions stays 0
  auto normalise = [&](int s, int k0) {
    if (!XVEC || !PRO) return;
    char* xs = smem + s * F::STAGE + F::ABYTES;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int ch = k0 + kg[i];
      if (!(ok[i] && ch < g.C)) continue;
      const float sc = bf16::round_bf16(ldg1(g.scale + ch));
      const float sh = bf16::round_bf16(ldg1(g.shift + ch));
      char* row = xs + dst[i];
      const uint4 u = *reinterpret_cast<const uint4*>(row);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)  // a pair past the grid stays 0
        o[e] = x4 && !(pin >> e & 1u)
                   ? 0u
                   : bits2(bf16::prologue(bits_lo(w[e]), sc, sh, g.relu),
                           bf16::prologue(bits_hi(w[e]), sc, sh, g.relu));
      sts128(row, o[0], o[1], o[2], o[3]);
      if (EMIT && emit && !x4) {
        *reinterpret_cast<uint4*>(g.xn + xo[i] + static_cast<size_t>(ch) * HWo) =
            make_uint4(o[0], o[1], o[2], o[3]);
      } else if (EMIT && emit) {
#pragma unroll
        for (int e = 0; e < 4; ++e)  // xn's grid is x's (stride 1)
          if (pin >> e & 1u)
            *reinterpret_cast<uint32_t*>(g.xn + pof[e] + static_cast<size_t>(ch) * HWo) = o[e];
      }
    }
  };
  // the register-staged X (not XVEC): a chunk's loads, issued a stage
  // before they are stored ...
  constexpr int kVals = TAPS == 1 ? 8 : kHaloW;
  float v[kItems][kVals];
  auto load_x = [&](int k0) {
    if (XVEC) return;
    if (TAPS == 1) {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int c0 = k0 + kg[i] * 8;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bool p = ok[i] && c0 + j < g.C;
          v[i][j] = p ? ldg1(g.x + src[i] + static_cast<size_t>(c0 + j) * HW) : 0.f;
        }
      }
    } else {
      const int c = k0 + kg[0];
      const bool in = ok[0] && c < g.C;
      const T* row = g.x + src[0] + static_cast<size_t>(c) * HW;
      float m[8];
      if (in) {
        load8<T>(row, ox0, g.W, m);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) m[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) v[0][j + 1] = m[j];
      v[0][0] = in && ox0 > 0 ? ldg1(row + ox0 - 1) : 0.f;
      v[0][9] = in && ox0 + 8 < g.W ? ldg1(row + ox0 + 8) : 0.f;
    }
  };
  // ... then the prologue, the packing and the 16-byte stores (and EMIT's xn)
  auto store_x = [&](int s, int k0) {
    if (XVEC) return;
    char* xs = smem + s * F::STAGE + F::ABYTES;
    if (TAPS == 1) {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int c0 = k0 + kg[i] * 8;
        float u[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int ch = c0 + j;
          const bool in = ok[i] && ch < g.C;
          u[j] = in ? staged<PRO>(v[i][j], PRO ? ldg1(g.scale + ch) : 1.f,
                                  PRO ? ldg1(g.shift + ch) : 0.f, g.relu)
                    : 0.f;
          if (EMIT && emit && in) st1(g.xn + xo[i] + static_cast<size_t>(ch) * HWo, u[j]);
        }
        sts128(xs + dst[i], bits2(u[0], u[1]), bits2(u[2], u[3]), bits2(u[4], u[5]),
               bits2(u[6], u[7]));
      }
      return;
    }
    if (dst[0] < 0) return;
    const int c = k0 + kg[0];
    const bool in = ok[0] && c < g.C;
    const float sc = PRO && in ? ldg1(g.scale + c) : 1.f;
    const float sh = PRO && in ? ldg1(g.shift + c) : 0.f;
    float u[kHaloW];
#pragma unroll
    for (int j = 0; j < kHaloW; ++j) {
      const int ix = ox0 - 1 + j;
      u[j] = in && ix >= 0 && ix < g.W ? staged<PRO>(v[0][j], sc, sh, g.relu) : 0.f;
    }
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      sts128(xs + dx * F::DXB + dst[0], bits2(u[dx], u[dx + 1]), bits2(u[dx + 2], u[dx + 3]),
             bits2(u[dx + 4], u[dx + 5]), bits2(u[dx + 6], u[dx + 7]));
    if (EMIT && emit && in && own[0]) {
      T* o = g.xn + xo[0] + static_cast<size_t>(c) * HW + ox0;
      if (IsBf16<T>::value && g.W % 8 == 0) {
        *reinterpret_cast<uint4*>(o) = make_uint4(bits2(u[1], u[2]), bits2(u[3], u[4]),
                                                  bits2(u[5], u[6]), bits2(u[7], u[8]));
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (ox0 + j < g.W) st1(o + j, u[j + 1]);
      }
    }
  };

  const int KT = ceil_div(g.KC, F::BK);
#pragma unroll
  for (int s = 0; s < F::S - 1; ++s) {
    if (s < KT) {
      copy(s, s * F::BK);
      load_x(s * F::BK);
      store_x(s, s * F::BK);
    }
    cp_async_commit();
  }
  if (F::S - 1 < KT) load_x((F::S - 1) * F::BK);
  const int ra = 64 * wm + 16 * warp + gq;  // the thread's A rows ra, ra + 8
  const int r0 = wn * (F::NW / 8);
  float d[F::R] = {};
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<F::S - 2>();  // this thread's copies of chunk kt landed
    normalise(kt % F::S, kt * F::BK);
    wg::fence_proxy_async();
    __syncthreads();  // chunk kt ready for all; every product of chunk kt − 1 is done
    const int nk = kt + F::S - 1;
    if (nk < KT) copy(nk % F::S, nk * F::BK);
    cp_async_commit();
    const char* as = smem + (kt % F::S) * F::STAGE;
    const char* lo = as + ra * F::AROW;
    const char* hi = lo + 8 * F::AROW;
    uint32_t a[F::STEPS][4];
#pragma unroll
    for (int s = 0; s < F::STEPS; ++s) {
      if (TAPS == 1) {
        const int e = 16 * s + 2 * t;
        a[s][0] = a_pair2<T>(lo, e), a[s][1] = a_pair2<T>(hi, e);
        a[s][2] = a_pair2<T>(lo, e + 8), a[s][3] = a_pair2<T>(hi, e + 8);
      } else {
        // step s is tap s; k = 2t, 2t + 1 are the chunk's channels 2t, 2t + 1
        const int e0 = 2 * t * 9 + s, e1 = e0 + 9;
        a[s][0] = a_pair<T>(lo, e0, e1), a[s][1] = a_pair<T>(hi, e0, e1);
        a[s][2] = a_pair<T>(lo, e0 + 72, e1 + 72), a[s][3] = a_pair<T>(hi, e0 + 72, e1 + 72);
      }
    }
    const char* xs = as + F::ABYTES;
    wg::fence_operand(acc);
    wg::fence_operand(d);
    wg::fence();
    if (kt == 0) issue<F, TAPS, XVEC>(acc, a, xs, r0);
    else issue<F, TAPS, XVEC>(d, a, xs, r0);
    wg::commit();
    // while the products run: store the chunk loaded an iteration ago, and
    // load the next
    if (nk < KT) store_x(nk % F::S, nk * F::BK);
    if (nk + 1 < KT) load_x((nk + 1) * F::BK);
    wg::wait<0>();
    wg::fence_operand(acc);
    wg::fence_operand(d);
    if (kt > 0) {
#pragma unroll
      for (int i = 0; i < F::R; ++i) acc[i] += d[i];
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the epilogue
}

// Whether copy_tile takes a tile of this grid: pairs of positions (two
// adjacent columns, the first even) are adjacent and 4-byte aligned (1x1:
// H'W' even; 3x3: W' even); wide: whole 8-column groups are 16-byte pieces
// (H'W' % 8 == 0; W' % 8 == 0).
template <int TAPS>
__host__ __device__ inline bool tile_pairs(const Geo& g, int m) {
  return TAPS == 1 ? (g.Ho * g.Wo) % m == 0 : g.Wo % m == 0;
}

// Copies a [BM][BN] bf16 tile of a (B, C, H', W') tensor on the output
// grid into shared memory `to`: rows c0 .. c0 + BM − 1, the block's
// position columns, an 8-column group a 16-byte cp.async (wide) or four
// 4-byte ones (tile_pairs; 16-byte aligned src). Rows past C and positions
// past the grid are zero-filled. The copies join the caller's next
// committed group: issued before the main loop, its first.
template <class F, int TAPS, int TH>
__device__ __forceinline__ void copy_tile(const Geo& geo, int pt, const __nv_bfloat16* src,
                                          int C, int c0, char* to, bool wide) {
  const size_t HWo = static_cast<size_t>(geo.Ho) * geo.Wo;
  for (int it = threadIdx.x; it < F::BM * (F::BN / 8); it += kThreads) {
    const int r = it / (F::BN / 8), j = it - r * (F::BN / 8);
    char* d = to + (r * F::BN + 8 * j) * 2;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (wide && e > 0) break;
      int b = 0, oy = 0, ox = 0;
      const bool p = c0 + r < C && tile_col<TAPS, TH>(geo, pt, 8 * j + 2 * e, &b, &oy, &ox);
      const size_t o = (static_cast<size_t>(b) * C + c0 + r) * HWo +
                       static_cast<size_t>(oy) * geo.Wo + ox;
      if (wide) cp_async16(d, p ? src + o : src, p);
      else cp_async4(d + 4 * e, p ? src + o : src, p);
    }
  }
}

// Two bf16 of such a tile (row r, columns col, col + 1; col even) as f32.
template <class F>
__device__ __forceinline__ float2 tile_pair(const char* t, int r, int col) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(t + (r * F::BN + col) * 2);
  return make_float2(bits_lo(u), bits_hi(u));
}

// The epilogue's staging: the block's tile of f32 sums, [BM][F::LD] in the
// ring, written from the wgmma layout; the caller then reads it a row (an
// output channel) a warp, two columns a lane, so that each warp's loads and
// stores of a row run along consecutive positions, and sums its rows one a
// thread (row_sums2).
template <class F>
__device__ __forceinline__ float* stage_tile(const float (&acc)[F::R], char* smem) {
  const int tid = threadIdx.x, lane = tid & 31, wgi = tid >> 7, warp = (tid >> 5) & 3;
  const int gq = lane >> 2, t = lane & 3;
  const int wm = F::GM == 2 ? wgi : 0, wn = F::GM == 2 ? 0 : wgi;
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < F::NW / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 64 * wm + 16 * warp + gq + 8 * h, col = wn * F::NW + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(tile + row * F::LD + col) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  __syncthreads();
  return tile;
}

// Two sums of each of the first BM rows of the staged tiles a and b (LD
// floats a row, F::BN columns), one row a thread, in a fixed order that
// starts at column tid % BN (so the 32 rows a warp reads fall on distinct
// banks): FMA (the dgrad's dscale, dshift) Σ a·b and Σ a, else (the
// forward's Σc, Σc²) Σ a and Σ a². Columns past the grid hold zeros.
template <class F, bool FMA>
__device__ __forceinline__ void row_sums2(const float* a, const float* b, float* s1,
                                          float* s2) {
  const int tid = threadIdx.x;
  const float* ra = a + tid * F::LD;
  const float* rb = b + tid * F::LD;
  float u = 0.f, v = 0.f;
  int col = tid % F::BN;
#pragma unroll 8
  for (int j = 0; j < F::BN; ++j) {
    const float e = ra[col];
    if (FMA) {
      u = fmaf(e, rb[col], u);
      v += e;
    } else {
      u += e;
      v = fmaf(e, e, v);
    }
    col = col + 1 == F::BN ? 0 : col + 1;
  }
  *s1 = u;
  *s2 = v;
}


}  // namespace convbn16
}  // namespace mxt
