// Shared pieces of the fused conv + BatchNorm kernels (conv_bn.cu forward,
// conv_bn_bwd.cu backward): the shape gate, the tensor-core implicit GEMM
// that the forward and the backward's dgrad both run, and the fixed-order
// sum of per-block partial rows.
//
// The implicit GEMM (tc_mainloop) computes, for one block's tile,
//   acc[m, q] = Σ_c Σ_t A[m, c·TAPS + t] · xn[c, q + s_t],
// the rows m of A (M, KC·TAPS) against a staged NCHW operand X (B, C, H, W),
// xn = prologue(X) or X itself, with s_t the tap's shift (3x3, pad 1) or the
// stride's sampling (1x1). The forward takes A = w, X = x; the dgrad A = w
// transposed and flipped, X = dce (conv_bn_bwd.cu). Products are 3xTF32 on
// mma.sync (tf32x3.cuh). A block of 8 warps (2 along rows x 4 along
// positions) owns 64 rows by 128 positions of the flattened B·H'W' axis
// (1x1; a tile may span images) or an 8 x 8 pixel tile of one image (3x3,
// staged with its one-pixel border, so the 9 taps are shifted reads of one
// staged chunk and a border pixel outside the image is a 0: the pad-1
// semantics of the TPU kernel's _shift_masks, pallas_conv_bn.py:216). The
// contraction streams through a 4-stage cp.async ring in chunks of 32
// channels (1x1) or 8 channels x 9 taps (3x3).
#pragma once

#include "common.cuh"
#include "tf32x3.cuh"

namespace mxt {
namespace convbn {

using namespace mxt::tf32x3;

constexpr int kThreads = 256;      // 8 warps
constexpr int kTileM = 64;         // GEMM rows a block
constexpr int kStages = 4;
constexpr int kTileP = 128;        // 1x1: flattened positions a block
constexpr int kTileHW = 8;         // 3x3: an 8 x 8 pixel tile ...
constexpr int kHaloW = 10;         // ... staged with its border
constexpr int kHalo = kHaloW * kHaloW;

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <int TAPS>
struct Cfg {
  static constexpr int BM = kTileM;
  static constexpr int BN = TAPS == 1 ? kTileP : kTileHW * kTileHW;
  static constexpr int BK = TAPS == 1 ? 32 : 8;          // contraction channels a stage
  static constexpr int KW = BK * TAPS;                   // A columns a stage
  static constexpr int AS = TAPS == 1 ? KW + 8 : KW + 4;  // A row: 40 or 76 floats
  static constexpr int BS = TAPS == 1 ? BN + 4 : 104;     // B row: 132 or 104 floats
  static constexpr int STAGE = BM * AS + BK * BS;
  static constexpr int SMEM = kStages * STAGE * 4;        // 108 544 or 91 136 bytes
  static constexpr int WARPS_M = 2, WARPS_N = 4;          // a warp: 32 rows x 32 or 16
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MT = WM / 16, NT = WN / 8;
  // Fragment loads are free of bank conflicts. 1x1: a thread's two k of a
  // step are A's columns 2t, 2t + 1, one 8-byte load (rows 8 mod 32), and
  // B's rows 2t, 2t + 1 at column g (rows 4 mod 32). 3x3: A at rows g and
  // columns 9t + tap (rows 4 · odd), B at rows t and columns g (rows 8 mod
  // 32).
  static_assert(TAPS == 1 ? AS % 32 == 8 && BS % 32 == 4 : (AS / 4) % 2 == 1 && BS % 32 == 8,
                "padding");
};

// The geometry of one call: x (B, K, H, W), w (N, K, taps), output grid
// (Ho, Wo) (a 1x1 kernel of stride 2 samples every second row and column).
struct Geo {
  int B, K, H, W, N, Ho, Wo, stride;
};

inline Geo make_geo(int B, int K, int H, int W, int N, int taps, int stride) {
  Geo g;
  g.B = B, g.K = K, g.H = H, g.W = W, g.N = N, g.stride = stride;
  g.Ho = taps == 1 ? ceil_div(H, stride) : H;
  g.Wo = taps == 1 ? ceil_div(W, stride) : W;
  return g;
}

// The position tiles of the implicit GEMM, one partial-statistics row each
// (ops/conv_bn.py _tc_parts): 128 flattened positions (1x1), 8 x 8 pixels
// of one image (3x3).
inline int tc_parts(const Geo& g, int taps) {
  if (taps == 1) return ceil_div(g.B * g.Ho * g.Wo, kTileP);
  return g.B * ceil_div(g.Ho, kTileHW) * ceil_div(g.Wo, kTileHW);
}

// The shape gate of pallas_conv_bn._conv_geometry (K % 8 == 0 also makes the
// forward's K chunks exact), plus the launch limits.
inline bool valid_call(int B, int K, int H, int W, int N, int taps, int stride) {
  if (B < 1 || B > 65535 || N < 1 || K < 8 || K % 8 || H < 1 || W < 1) return false;
  if (taps == 1) {
    if (stride != 1 && stride != 2) return false;
  } else if (taps != 9 || stride != 1) {
    return false;
  }
  const Geo g = make_geo(B, K, H, W, N, taps, stride);
  const long long blocks = static_cast<long long>(tc_parts(g, taps)) * ceil_div(N > K ? N : K,
                                                                                 kTileM);
  return g.Ho * g.Wo >= 8 && blocks < (1LL << 31);
}

__device__ __forceinline__ float prologue(float v, float sc, float sh, bool relu) {
  v = __fadd_rn(__fmul_rn(v, sc), sh);
  return relu ? fmaxf(v, 0.f) : v;
}

// Column col of position tile pt: its image b and output pixel (oy, ox);
// false past the grid's edge.
template <int TAPS>
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
  const int tiles_x = ceil_div(geo.Wo, kTileHW);
  const int per_img = ceil_div(geo.Ho, kTileHW) * tiles_x;
  *b = pt / per_img;
  const int tile = pt - *b * per_img;
  *oy = (tile / tiles_x) * kTileHW + col / kTileHW;
  *ox = (tile % tiles_x) * kTileHW + col % kTileHW;
  return *oy < geo.Ho && *ox < geo.Wo;
}

// The operands of one implicit GEMM. X has C channels on the grid (H, W)
// that the output grid (Ho, Wo) samples with stride; A has M rows of
// a_row = KC·TAPS columns, where KC ≥ C is a multiple of 8 (columns of the
// channels c ≥ C are zero in A and never read from X: they are zero-filled).
struct TcArgs {
  const float* a;
  const float* x;
  const float* scale;  // the prologue on X (PRO), else unused
  const float* shift;
  int M, KC, C;
  int B, H, W, Ho, Wo, stride;
  bool relu;
};

// Fills acc with the block's tile (position tile pt, rows m0 .. m0 + 63).
// smem: Cfg<TAPS>::SMEM bytes of dynamic shared memory, free on return.
template <int TAPS, bool VEC, bool PRO>
__device__ __forceinline__ void tc_mainloop(const TcArgs& g, int pt, int m0, float* smem,
                                            float (&acc)[Cfg<TAPS>::MT][Cfg<TAPS>::NT][4]) {
  using C = Cfg<TAPS>;
  constexpr int BM = C::BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int wm = warp % C::WARPS_M, wn = warp / C::WARPS_M;
  const int HWo = g.Ho * g.Wo;
  const size_t HW = static_cast<size_t>(g.H) * g.W;
  const int a_row = g.KC * TAPS;

  // ---- where this thread's staged X comes from, computed once a block
  // 1x1: one position (VEC: 4) and the channels kl0 + i · kStepK of a chunk
  constexpr int kPerRow = VEC ? C::BN / 4 : C::BN;   // copies along a B row
  constexpr int kStepK = kThreads / kPerRow;         // B rows apart
  constexpr int k1x1 = TAPS == 1 ? C::BK / kStepK : 1;
  // 3x3: elements e = tid + i · 256 of the BK x 10 x 10 halo chunk
  constexpr int k3x3 = TAPS == 1 ? 1 : (C::BK * kHalo + kThreads - 1) / kThreads;
  size_t off = 0;         // 1x1: X offset of the position at channel 0
  int pos = 0, kl0 = 0;   // 1x1: B column and first row
  bool valid = false;     // 1x1: the position exists
  size_t src[k3x3];       // 3x3: X offset at the chunk's channel 0
  int dst[k3x3];          // 3x3: shared offset in the B block; -1 past the chunk
  int kls[k3x3];          // 3x3: its channel in the chunk
  bool ok[k3x3];          // 3x3: inside the image (else zero-filled)
  if (TAPS == 1) {
    pos = (tid % kPerRow) * (VEC ? 4 : 1);
    kl0 = tid / kPerRow;
    const int q = pt * C::BN + pos;
    valid = q < g.B * HWo;  // VEC: H'W' % 4 == 0, so the 4 are all in or all out
    const int b = valid ? q / HWo : 0, p = q - b * HWo;
    const int oy = p / g.Wo, ox = p - oy * g.Wo;
    off = static_cast<size_t>(b) * g.C * HW + static_cast<size_t>(oy * g.stride) * g.W +
          ox * g.stride;
  } else {
    const int tiles_x = ceil_div(g.Wo, kTileHW);
    const int per_img = ceil_div(g.Ho, kTileHW) * tiles_x;
    const int b3 = pt / per_img, tile = pt - b3 * per_img;
    const int oy0 = (tile / tiles_x) * kTileHW, ox0 = (tile % tiles_x) * kTileHW;
#pragma unroll
    for (int i = 0; i < k3x3; ++i) {
      const int e = tid + i * kThreads;
      const int kl = e / kHalo, hp = e - kl * kHalo;
      const int hy = hp / kHaloW, hx = hp - hy * kHaloW;
      const int iy = oy0 - 1 + hy, ix = ox0 - 1 + hx;
      ok[i] = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
      src[i] = (static_cast<size_t>(b3) * g.C + kl) * HW +
               (ok[i] ? static_cast<size_t>(iy) * g.W + ix : 0);
      dst[i] = e < C::BK * kHalo ? kl * C::BS + hp : -1;
      kls[i] = kl;
    }
  }

  // ---- one contraction chunk (channels k0 .. k0 + BK - 1) into stage s
  auto load = [&](int s, int k0) {
    float* as = smem + s * C::STAGE;
    float* bs = as + BM * C::AS;
    constexpr int kRowChunks = C::KW / 4;
    for (int ch = tid; ch < BM * kRowChunks; ch += kThreads) {
      const int r = ch / kRowChunks, col = (ch - r * kRowChunks) * 4;
      const bool p = m0 + r < g.M && (TAPS != 1 || k0 + col < g.KC);
      cp_async16(as + r * C::AS + col,
                 p ? g.a + static_cast<size_t>(m0 + r) * a_row + k0 * TAPS + col : g.a, p);
    }
    if (TAPS == 1) {
#pragma unroll
      for (int i = 0; i < k1x1; ++i) {
        const int kl = kl0 + i * kStepK;
        const bool p = valid && k0 + kl < g.C;
        const float* from = p ? g.x + off + static_cast<size_t>(k0 + kl) * HW : g.x;
        if (VEC) cp_async16(bs + kl * C::BS + pos, from, p);
        else cp_async4(bs + kl * C::BS + pos, from, p);
      }
    } else {
      const size_t koff = static_cast<size_t>(k0) * HW;
#pragma unroll
      for (int i = 0; i < k3x3; ++i) {
        if (dst[i] < 0) continue;
        const bool p = ok[i] && k0 + kls[i] < g.C;
        cp_async4(bs + dst[i], p ? g.x + src[i] + koff : g.x, p);
      }
    }
  };

  const int KT = ceil_div(g.KC, C::BK);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load(s, s * C::BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    const int k0 = kt * C::BK;
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk kt landed
    if (TAPS != 1 && PRO) {
      // 3x3: the prologue once an element, on the elements this thread
      // copied (its 9 taps x 2 warps read each many times); 0 outside the image
      float* bs = smem + (kt % kStages) * C::STAGE + BM * C::AS;
#pragma unroll
      for (int i = 0; i < k3x3; ++i) {
        if (dst[i] < 0) continue;
        const int k = k0 + kls[i];
        bs[dst[i]] = ok[i] ? prologue(bs[dst[i]], __ldg(g.scale + k), __ldg(g.shift + k), g.relu)
                           : 0.f;
      }
    }
    __syncthreads();  // chunk kt ready for all; every warp is done with chunk kt - 1's stage
    const int nk = kt + kStages - 1;
    if (nk < KT) load(nk % kStages, nk * C::BK);
    cp_async_commit();
    const float* as = smem + (kt % kStages) * C::STAGE + (wm * C::WM + gq) * C::AS;
    const float* bs = smem + (kt % kStages) * C::STAGE + BM * C::AS;
    if (TAPS == 1) {
#pragma unroll
      for (int kk = 0; kk < C::BK; kk += 8) {
        if (k0 + kk >= g.KC) break;  // KC % 8 == 0: an 8-deep step is all in or all out
        // k = t and t + 4 of the step are channels kk + 2t and kk + 2t + 1
        // (tf32x3.cuh): A's from one 8-byte load, B's from two rows
        float2 sc = make_float2(1.f, 1.f), sh = make_float2(0.f, 0.f);
        if (PRO) {
          sc = __ldg(reinterpret_cast<const float2*>(g.scale + k0 + kk + 2 * t));
          sh = __ldg(reinterpret_cast<const float2*>(g.shift + k0 + kk + 2 * t));
        }
        uint32_t b_hi[C::NT][2], b_lo[C::NT][2];
#pragma unroll
        for (int ni = 0; ni < C::NT; ++ni) {
          const float* br = bs + (kk + 2 * t) * C::BS + wn * C::WN + ni * 8 + gq;
          float v0 = br[0], v1 = br[C::BS];
          if (PRO) v0 = prologue(v0, sc.x, sh.x, g.relu), v1 = prologue(v1, sc.y, sh.y, g.relu);
          split(v0, b_hi[ni][0], b_lo[ni][0]);
          split(v1, b_hi[ni][1], b_lo[ni][1]);
        }
#pragma unroll
        for (int mi = 0; mi < C::MT; ++mi) {
          const float* ar = as + mi * 16 * C::AS + kk + 2 * t;
          uint32_t a_hi[4], a_lo[4];
          split2(ar, a_hi[0], a_lo[0], a_hi[2], a_lo[2]);
          split2(ar + 8 * C::AS, a_hi[1], a_lo[1], a_hi[3], a_lo[3]);
#pragma unroll
          for (int ni = 0; ni < C::NT; ++ni) mma3(acc[mi][ni], a_hi, a_lo, b_hi[ni], b_lo[ni]);
        }
      }
    } else {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        uint32_t b_hi[C::NT][2], b_lo[C::NT][2];
#pragma unroll
        for (int ni = 0; ni < C::NT; ++ni) {
          // the tap's halo pixel, normalised (or 0 outside the image) above
          const float* br = bs + t * C::BS + (wn * C::NT + ni + dy) * kHaloW + gq + dx;
          split(br[0], b_hi[ni][0], b_lo[ni][0]);
          split(br[4 * C::BS], b_hi[ni][1], b_lo[ni][1]);
        }
#pragma unroll
        for (int mi = 0; mi < C::MT; ++mi) {
          const float* ar = as + mi * 16 * C::AS + t * 9 + tap;
          uint32_t a_hi[4], a_lo[4];
          split(ar[0], a_hi[0], a_lo[0]);
          split(ar[8 * C::AS], a_hi[1], a_lo[1]);
          split(ar[36], a_hi[2], a_lo[2]);  // channel t + 4: 4 · 9 columns on
          split(ar[8 * C::AS + 36], a_hi[3], a_lo[3]);
#pragma unroll
          for (int ni = 0; ni < C::NT; ++ni) mma3(acc[mi][ni], a_hi, a_lo, b_hi[ni], b_lo[ni]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring's stages are free for the epilogue
}

// Two per-row sums of a block's tile (Σc and Σc², or dscale and dshift):
// s[mi][h] and q[mi][h] are the thread's sums of row wm·WM + mi·16 + g + 8h
// over its columns. Lanes t = 0..3 of a row add theirs, then the 4 warps
// along positions, in order, through shared memory (red: 2 · WARPS_N · BM
// floats, free when called); thread tid < BM ends with row tid's block sums
// in *s_out, *q_out.
template <int TAPS>
__device__ __forceinline__ void tile_row_sums(float (&s)[Cfg<TAPS>::MT][2],
                                              float (&q)[Cfg<TAPS>::MT][2], float* red,
                                              float* s_out, float* q_out) {
  using C = Cfg<TAPS>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int wm = warp % C::WARPS_M, wn = warp / C::WARPS_M;
#pragma unroll
  for (int mi = 0; mi < C::MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        s[mi][h] += __shfl_xor_sync(kFullMask, s[mi][h], o);
        q[mi][h] += __shfl_xor_sync(kFullMask, q[mi][h], o);
      }
  constexpr int WN_ = C::WARPS_N, BM = C::BM;
  if (t == 0) {
#pragma unroll
    for (int mi = 0; mi < C::MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lc = wm * C::WM + mi * 16 + gq + 8 * h;
        red[wn * BM + lc] = s[mi][h];
        red[(WN_ + wn) * BM + lc] = q[mi][h];
      }
  }
  __syncthreads();
  if (tid < BM) {
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int j = 0; j < WN_; ++j) sum += red[j * BM + tid], sq += red[(WN_ + j) * BM + tid];
    *s_out = sum;
    *q_out = sq;
  }
}

inline bool misaligned(const void* p, int a) { return reinterpret_cast<uintptr_t>(p) % a != 0; }

}  // namespace convbn
}  // namespace mxt
