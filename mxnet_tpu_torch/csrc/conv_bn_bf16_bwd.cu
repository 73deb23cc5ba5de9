// The bf16 forms of the fused conv + BatchNorm backward: dx, dw, dscale,
// dshift and dres of conv_bn_bf16.cu's training forward, on Hopper's
// warpgroup products.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_conv_bn.py _bwd_kernel
// (:511), launched by _conv_block_bwd_impl (:619, pallas_call :692), on the
// bf16 operands of SPMDTrainer(compute_dtype='bfloat16'), in both of its
// policies: recompute (mxt_conv_bn_bwd_bf16: xn = relu(x·scale + shift)
// rederived from x) and stash (mxt_conv_bn_bwd_stash_bf16: xn written by
// the forward's stash form and read here, :531, :567-568). x, w, scale,
// shift, c, dc, dx, dw, dce (dres) and wt are bf16; ds, dq, dscale, dshift
// f32. The rounding points are the TPU kernel's: dce = dc + ds + 2·c·dq in
// f32 with the product fused into the second add (as the JAX package's
// compiled fold computes it: conv_bn.cuh dce_of), rounded to bf16 once (dres
// and the products' operand, :556-564); xn in bf16 from bf16 scale and shift
// with the forward's two roundings, the ReLU mask from it; exact bf16
// products summed in f32; dx = da·scale rounded to bf16; dscale = Σ da·x and
// dshift = Σ da in f32; dw summed in f32 and rounded to bf16 (:715).
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s, 2 bytes an element): the
// products, twice the forward's 2·B·H'W'·N·K·taps FLOP, bind it at the 3x3
// sites past stage 1; bytes and operations about equally at stage 1's 3x3;
// bytes at the 1x1 sites (PERF.md §6). Five passes, each under a name of
// its own (conv_bn_bf16_bwd_*, conv_bn_stash_bf16_bwd_*), split by who owns
// each output as the f32 backward (conv_bn_bwd.cu) is:
// - fold: dce written once, read by both products (conv_bn.cuh fold).
// - wflip: w transposed with its taps flipped into wt (K, N'·taps).
// - dgrad: conv_bn_bf16.cuh's mainloop with A = wt and X = dce (bf16
//   staged as bf16, the products on wgmma with A from registers), then the
//   prologue's backward in the epilogue: the ReLU mask (from the recomputed
//   bf16 prologue, or from xn), dx = da·scale, one partial row of dscale and
//   dshift a position tile, and at stride 2 the zeros of dx off the sampled
//   positions. At stride 1 the tile's x (and xn) are copied into shared
//   memory by cp.async under the products, so the epilogue waits on no
//   load; at stride 2 each row's loads are issued a row ahead.
// - wgrad: dw[n, k, t] = Σ_p dce[n, p] · xn[k, p + s_t] over P = B·H'W',
//   both operands running along p, the contraction wgmma's K: so both are
//   staged K-major as core matrices of 8 channels x 8 positions and read by
//   descriptors. Where H'W' is even (x: at stride 1) a row of 8 positions
//   is copied with cp.async (one 16-byte copy where H'W' % 8 == 0, else
//   four 4-byte pairs), and x's prologue is then applied in shared memory
//   by the thread that copied it, once an element, as its copy lands;
//   elsewhere (7 x 7 grids, x at stride 2) rows are gathered in registers
//   while the products of the stage before run. P is split over blocks to fill the card, each split
//   writing a partial dw. 1x1: a block owns 128 output by 64 or 128 input
//   channels, 64 positions a stage (a 4-stage ring). 3x3: a block owns 64
//   output by 64 input channels and all nine taps, a stage one TH x 8 pixel
//   tile (TH = 14 where the grid's height is a multiple of 14, else 8); the
//   taps are shifted windows of x's bordered tile, a 1-pixel column shift
//   being 2 bytes, so x is staged three times, shifted by 0, 1 and 2
//   columns, and each tap's B is a descriptor into one of them. The nine
//   taps' sums stay in registers; each stage's products of a tap go into a
//   fresh accumulator (two, alternating), added to the tap's sum with one
//   rounding.
// - a fixed-order second pass adds the partial dw and dscale/dshift rows:
//   no atomics, so two runs give the same bits.
// Every product takes a fresh accumulator a stage added with one rounding
// to nearest: a wgrad split adds up to hundreds of stages
// (tests/test_torch_conv_bn_bf16_tiles.py emulates the sums).
#include "conv_bn_bf16.cuh"

namespace {

using namespace mxt;  // the storage loads and stores, bf16::
using namespace mxt::convbn16;
using convbn::make_geo;
using convbn::misaligned;
using convbn::valid_call;
using bf16_t = __nv_bfloat16;

// ---- fold and wflip: conv_bn.cuh's passes, under the forms' names
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
conv_bn_bf16_bwd_fold_kernel(const bf16_t* __restrict__ dc, const bf16_t* __restrict__ c,
                             const float* __restrict__ ds, const float* __restrict__ dq,
                             bf16_t* __restrict__ dce, int N, int HWo, size_t total) {
  convbn::fold<VEC>(dc, c, ds, dq, dce, N, HWo, total);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
conv_bn_stash_bf16_bwd_fold_kernel(const bf16_t* __restrict__ dc, const bf16_t* __restrict__ c,
                                   const float* __restrict__ ds, const float* __restrict__ dq,
                                   bf16_t* __restrict__ dce, int N, int HWo, size_t total) {
  convbn::fold<VEC>(dc, c, ds, dq, dce, N, HWo, total);
}

template <int TAPS>
__global__ void __launch_bounds__(kThreads)
conv_bn_bf16_bwd_wflip_kernel(const bf16_t* __restrict__ w, bf16_t* __restrict__ wt, int N,
                              int K, int np) {
  convbn::wflip<TAPS>(w, wt, N, K, np);
}

template <int TAPS>
__global__ void __launch_bounds__(kThreads)
conv_bn_stash_bf16_bwd_wflip_kernel(const bf16_t* __restrict__ w, bf16_t* __restrict__ wt,
                                    int N, int K, int np) {
  convbn::wflip<TAPS>(w, wt, N, K, np);
}

// ---- dgrad: the forward's mainloop over (wt, dce), then the prologue's
// backward. The input-channel blocks of one position tile run one after
// another, so the tile's dce is read from device memory once. STASH: the
// ReLU mask from xn (B, K, H', W').
template <int TAPS, int TH, int WM, bool PRO, bool STASH, bool XVEC>
__device__ __forceinline__ void dgrad_body(const bf16_t* __restrict__ x,
                                           const bf16_t* __restrict__ wt,
                                           const bf16_t* __restrict__ scale,
                                           const bf16_t* __restrict__ shift,
                                           const bf16_t* __restrict__ dce,
                                           bf16_t* __restrict__ dx, float* __restrict__ part,
                                           const Geo& geo, int np, bool relu,
                                           const bf16_t* __restrict__ xn) {
  using F = Fwd<TAPS, TH, WM, bf16_t>;
  extern __shared__ __align__(128) char smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int kblocks = ceil_div(geo.K, F::BM);
  const int pt = blockIdx.x / kblocks, k0 = (blockIdx.x - pt * kblocks) * F::BM;
  const int K = geo.K;
  const Args<bf16_t> args{wt, dce, nullptr, nullptr, K, np, geo.N, geo.B,
                          geo.Ho, geo.Wo, geo.Ho, geo.Wo, 1, false, nullptr};
  // x's (PRO) and xn's (STASH) tiles, copied past the ring while the
  // products run, where their position pairs are aligned (stride 1,
  // copy_tile)
  const bool tvec = geo.stride == 1 && tile_pairs<TAPS>(geo, 2);
  const bool wide = tile_pairs<TAPS>(geo, 8);
  char* xs = smem + F::SMEM;
  char* ns = xs + (PRO ? F::RES : 0);
  if (tvec && PRO) copy_tile<F, TAPS, TH>(geo, pt, x, K, k0, xs, wide);
  if (tvec && STASH && relu) copy_tile<F, TAPS, TH>(geo, pt, xn, K, k0, ns, wide);
  float acc[F::R] = {};
  mainloop<TAPS, TH, WM, bf16_t, false, false, XVEC>(args, pt, k0, smem, acc);

  // ---- epilogue, through the ring (stage_tile): a warp a row (input
  // channel k) at a time, lane l the columns 2l, 2l + 1 (+ 64), so a warp's
  // loads of x (xn) and stores of dx run along consecutive positions. PRO:
  // the masked da goes back into the tile and x into a second one (0 past
  // the grid), whose rows are then summed one a thread into dscale, dshift.
  float* tile = stage_tile<F>(acc, smem);
  float* xt = tile + F::BM * F::LD;
  const size_t HW = static_cast<size_t>(geo.H) * geo.W, HWo = static_cast<size_t>(geo.Ho) * geo.Wo;
  const bool s2 = geo.stride == 2;
  constexpr int CI = (F::BN + 63) / 64;
  size_t xb[CI][2], nb[CI][2];  // x's and xn's offsets at channel 0
  bool in[CI][2], right[CI][2], down[CI][2], vec[CI], nvec[CI];
#pragma unroll
  for (int i = 0; i < CI; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 64 * i + 2 * lane + e;
      int b = 0, oy = 0, ox = 0;
      in[i][e] = col < F::BN && tile_col<TAPS, TH>(geo, pt, col, &b, &oy, &ox);
      const int iy = oy * geo.stride, ix = ox * geo.stride;
      xb[i][e] = static_cast<size_t>(b) * K * HW + static_cast<size_t>(iy) * geo.W + ix;
      nb[i][e] = static_cast<size_t>(b) * K * HWo + static_cast<size_t>(oy) * geo.Wo + ox;
      // stride 2: the unsampled neighbours of (iy, ix) inside the grid
      right[i][e] = s2 && ix + 1 < geo.W;
      down[i][e] = s2 && iy + 1 < geo.H;
    }
    // the pair as one access: stride 1, two adjacent positions (4 bytes);
    // stride 2, the 2 x 4 cell of two sampled positions and their unsampled
    // neighbours (an 8-byte row of x and dx, and one of zeros below it)
    vec[i] = in[i][0] && in[i][1] &&
             (s2 ? xb[i][1] == xb[i][0] + 2 && xb[i][0] % 4 == 0 && geo.W % 4 == 0
                 : xb[i][1] == xb[i][0] + 1 && xb[i][0] % 2 == 0 && HW % 2 == 0);
    nvec[i] = in[i][0] && in[i][1] && nb[i][1] == nb[i][0] + 1 && nb[i][0] % 2 == 0 &&
              HWo % 2 == 0;
  }
  // a row's loads: scale, shift, x (PRO) and xn (STASH, where the mask needs
  // it) at the lane's columns, from the copied tiles or (not tvec) device
  // memory; each row's are issued before the row before it is computed, so
  // their latency hides behind it
  struct RowIn {
    float sc, sf, x[CI][2], n[CI][2];
  };
  auto load_row = [&](int k, RowIn& o) {
    const size_t koff = static_cast<size_t>(k) * HW, nkoff = static_cast<size_t>(k) * HWo;
    o.sc = PRO ? ldg1(scale + k) : 1.f;
    o.sf = PRO ? ldg1(shift + k) : 0.f;
#pragma unroll
    for (int i = 0; i < CI; ++i) {
      o.x[i][0] = o.x[i][1] = o.n[i][0] = o.n[i][1] = 0.f;
      const int col = 64 * i + 2 * lane;
      if (col >= F::BN) continue;
      if (tvec) {
        if (PRO) {
          const float2 f = tile_pair<F>(xs, k - k0, col);
          o.x[i][0] = f.x, o.x[i][1] = f.y;
        }
        if (STASH && relu) {
          const float2 f = tile_pair<F>(ns, k - k0, col);
          o.n[i][0] = f.x, o.n[i][1] = f.y;
        }
        continue;
      }
      if (PRO && vec[i] && s2) {
        const float4 f = ldg4(x + xb[i][0] + koff);
        o.x[i][0] = f.x, o.x[i][1] = f.z;
      } else if (PRO && vec[i]) {
        const float2 f = ldg2(x + xb[i][0] + koff);
        o.x[i][0] = f.x, o.x[i][1] = f.y;
      } else if (PRO) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (in[i][e]) o.x[i][e] = ldg1(x + xb[i][e] + koff);
      }
      if (STASH && relu && nvec[i]) {
        const float2 f = ldg2(xn + nb[i][0] + nkoff);
        o.n[i][0] = f.x, o.n[i][1] = f.y;
      } else if (STASH && relu) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (in[i][e]) o.n[i][e] = ldg1(xn + nb[i][e] + nkoff);
      }
    }
  };
  RowIn cur{}, next{};
  if (tid >> 5 < F::BM && k0 + (tid >> 5) < K) load_row(k0 + (tid >> 5), cur);
  for (int r = tid >> 5; r < F::BM && k0 + r < K; r += kThreads / 32) {
    const int k = k0 + r;
    if (r + kThreads / 32 < F::BM && k + kThreads / 32 < K) load_row(k + kThreads / 32, next);
    const float sc = cur.sc, sf = cur.sf;
    const size_t koff = static_cast<size_t>(k) * HW;
#pragma unroll
    for (int i = 0; i < CI; ++i) {
      const int col = 64 * i + 2 * lane;
      if (col >= F::BN) continue;
      float2* tp = reinterpret_cast<float2*>(tile + r * F::LD + col);
      const float2 d2 = *tp;
      const float* xv = cur.x[i];
      // the prologue's backward: the ReLU mask on da (past the grid, 0)
      float da[2] = {d2.x, d2.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pre = STASH ? cur.n[i][e] : bf16::prologue(xv[e], sc, sf, false);
        if (!in[i][e] || (PRO && relu && !(pre > 0.f))) da[e] = 0.f;
      }
      const float g0 = PRO ? da[0] * sc : da[0], g1 = PRO ? da[1] * sc : da[1];
      if (PRO) {
        *tp = make_float2(da[0], da[1]);
        *reinterpret_cast<float2*>(xt + r * F::LD + col) = make_float2(xv[0], xv[1]);
      }
      if (vec[i]) {
        const size_t o = xb[i][0] + koff;
        if (s2) {
          st4(dx + o, make_float4(g0, 0.f, g1, 0.f));
          if (down[i][0]) st4(dx + o + geo.W, make_float4(0.f, 0.f, 0.f, 0.f));
        } else {
          st2(dx + o, g0, g1);
        }
        continue;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (!in[i][e]) continue;
        const size_t o = xb[i][e] + koff;
        st1(dx + o, e ? g1 : g0);
        if (right[i][e]) st1(dx + o + 1, 0.f);
        if (down[i][e]) st1(dx + o + geo.W, 0.f);
        if (right[i][e] && down[i][e]) st1(dx + o + geo.W + 1, 0.f);
      }
    }
    cur = next;
  }
  if (PRO) {
    __syncthreads();
    if (tid < F::BM && k0 + tid < K) {
      float a, d;
      row_sums2<F, true>(tile, xt, &a, &d);
      part[(static_cast<size_t>(pt) * 2) * K + k0 + tid] = a;
      part[(static_cast<size_t>(pt) * 2 + 1) * K + k0 + tid] = d;
    }
  }
}

template <int TAPS, int TH, int WM, bool PRO, bool XVEC>
__global__ void __launch_bounds__(kThreads, (Fwd<TAPS, TH, WM, bf16_t>::MINB))
conv_bn_bf16_bwd_dgrad_kernel(const bf16_t* __restrict__ x, const bf16_t* __restrict__ wt,
                              const bf16_t* __restrict__ scale, const bf16_t* __restrict__ shift,
                              const bf16_t* __restrict__ dce, bf16_t* __restrict__ dx,
                              float* __restrict__ part, Geo geo, int np, bool relu) {
  dgrad_body<TAPS, TH, WM, PRO, false, XVEC>(x, wt, scale, shift, dce, dx, part, geo, np, relu,
                                             nullptr);
}

template <int TAPS, int TH, int WM, bool XVEC>
__global__ void __launch_bounds__(kThreads, (Fwd<TAPS, TH, WM, bf16_t>::MINB))
conv_bn_stash_bf16_bwd_dgrad_kernel(const bf16_t* __restrict__ x, const bf16_t* __restrict__ wt,
                                    const bf16_t* __restrict__ scale,
                                    const bf16_t* __restrict__ shift,
                                    const bf16_t* __restrict__ dce, bf16_t* __restrict__ dx,
                                    float* __restrict__ part, Geo geo, int np, bool relu,
                                    const bf16_t* __restrict__ xn) {
  dgrad_body<TAPS, TH, WM, true, true, XVEC>(x, wt, scale, shift, dce, dx, part, geo, np, relu,
                                             xn);
}

// ---- the wgrad's staging: 8 positions of one channel row as one 16-byte
// core-matrix row. The positions q0 .. q0 + 7 of the flattened B·H'W' axis
// (1x1) are decoded once a stage into each operand's offsets at channel 0
// (32-bit: bwd_run refuses tensors of 2^31 elements or more): dce's on the
// output grid, x's on its own grid, sampled with stride.
struct Pos8 {
  int e[8], x[8];  // dce's and x's offsets at channel 0; -1 past the positions
};

__device__ __forceinline__ void decode8(int q0, const Geo& g, int stride, Pos8* d) {
  const int HWo = g.Ho * g.Wo;
  int b = q0 / HWo, p = q0 - b * HWo;
  int oy = p / g.Wo, ox = p - oy * g.Wo;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool in = b < g.B;
    d->e[j] = in ? b * g.N * HWo + p : -1;
    d->x[j] = in ? b * g.K * g.H * g.W + oy * stride * g.W + ox * stride : -1;
    ++p;
    if (++ox == g.Wo) {
      ox = 0;
      if (++oy == g.Ho) oy = 0, p = 0, ++b;
    }
  }
}

// Loads channel c (of C, planes of HW elements) at the 8 decoded offsets
// off into v, 0 past the channels or the positions.
__device__ __forceinline__ void gather8(const bf16_t* __restrict__ src, int c, int C, int HW,
                                        const int (&off)[8], float (&v)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = c < C && off[j] >= 0 ? ldg1(src + off[j] + c * HW) : 0.f;
}

__device__ __forceinline__ void store8(char* dst, const float (&v)[8]) {
  sts128(dst, bits2(v[0], v[1]), bits2(v[2], v[3]), bits2(v[4], v[5]), bits2(v[6], v[7]));
}

// The prologue, in place, on one 16-byte row of 8 bf16 in shared memory.
__device__ __forceinline__ void prologue8(char* p, float sc, float sh, bool relu) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = bits2(bf16::prologue(bits_lo(w[i]), sc, sh, relu),
                 bf16::prologue(bits_hi(w[i]), sc, sh, relu));
  sts128(p, w[0], w[1], w[2], w[3]);
}

// ---- wgrad, 1x1: 128 output (n) by BNK input (k) channels a block, 64
// positions a stage. Warpgroup g owns n rows 64g .. 64g + 63 and all BNK
// columns (wgmma N = BNK). A stage: dce's 128 rows then x's BNK rows, each
// [channel group][position group][8 channels][8 positions].
constexpr int kW1N = 128, kW1P = 64, kW1Stages = 4;

template <int BNK>
struct W1 {
  static constexpr int ABYTES = kW1N * kW1P * 2;
  static constexpr int BBYTES = BNK * kW1P * 2;
  static constexpr int STAGE = ABYTES + BBYTES;
  static constexpr int SMEM = kW1Stages * STAGE;  // 98 304 or 131 072 bytes
};

// The input channels a 1x1 wgrad block owns (ops/conv_bn.py WGRAD_TILE_BF16).
inline int wgrad1_bnk(int K) { return K > 64 ? 128 : 64; }

// EVEC: dce's rows of 8 positions copied (H'W' even: one 16-byte copy
// where H'W' % 8 == 0, else four 4-byte pairs, the 8 may span two images);
// XVEC: x's too (stride 1).
template <int BNK, bool EVEC, bool XVEC, bool PRO>
__device__ __forceinline__ void wgrad1_body(const bf16_t* __restrict__ x,
                                            const bf16_t* __restrict__ scale,
                                            const bf16_t* __restrict__ shift,
                                            const bf16_t* __restrict__ dce,
                                            float* __restrict__ dw_part, const Geo& geo,
                                            bool relu, int splits) {
  using L = W1<BNK>;
  extern __shared__ __align__(128) char smem[];
  const int tid = threadIdx.x, lane = tid & 31, wgi = tid >> 7, warp = (tid >> 5) & 3;
  const int gq = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kW1N, k0 = blockIdx.y * BNK;
  const int N = geo.N, K = geo.K, HWo = geo.Ho * geo.Wo;
  const int chunks = ceil_div(geo.B * HWo, kW1P), per = ceil_div(chunks, splits);
  const int c0 = blockIdx.z * per, nch = max(0, min(chunks, c0 + per) - c0);
  // a thread's items: position group pg (the same in every item) of rows
  // r0 + 32i
  const int pg = tid & 7, r0 = tid >> 3;
  constexpr int kAItems = kW1N / 32, kBItems = BNK / 32;
  const size_t HW = static_cast<size_t>(geo.H) * geo.W;
  auto dst = [&](int row) { return ((row >> 3) * (kW1P / 8) + pg) * 128 + (row & 7) * 16; };
  float sc[kBItems], sf[kBItems];
#pragma unroll
  for (int i = 0; i < kBItems; ++i) {
    const int k = k0 + r0 + 32 * i;
    sc[i] = PRO && k < K ? ldg1(scale + k) : 1.f;
    sf[i] = PRO && k < K ? ldg1(shift + k) : 0.f;
  }
  // the asynchronous part of a chunk's staging: a row's 8 positions in one
  // 16-byte copy (wide), else as four 4-byte pairs, each from its image (a
  // pair past the positions is zero-filled, and so adds nothing: dce is 0
  // there)
  const bool wide = HWo % 8 == 0;
  auto copy = [&](int s, int ch) {
    char* as = smem + s * L::STAGE;
    char* bs = as + L::ABYTES;
    int b[4], p[4];
    bool pin[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (wide && e > 0) break;  // the 8 share an image
      const int q = ch * kW1P + pg * 8 + 2 * e;
      pin[e] = q < geo.B * HWo;
      b[e] = pin[e] ? q / HWo : 0;
      p[e] = q - b[e] * HWo;
    }
    auto row = [&](char* to, const bf16_t* t, int C, int c, size_t plane) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (wide && e > 0) break;
        const bool pr = pin[e] && c < C;
        const bf16_t* from = pr ? t + (static_cast<size_t>(b[e]) * C + c) * plane + p[e] : t;
        if (wide) cp_async16(to, from, pr);
        else cp_async4(to + 4 * e, from, pr);
      }
    };
    if (EVEC) {
#pragma unroll
      for (int i = 0; i < kAItems; ++i) row(as + dst(r0 + 32 * i), dce, N, n0 + r0 + 32 * i, HWo);
    }
    if (XVEC) {
#pragma unroll
      for (int i = 0; i < kBItems; ++i) row(bs + dst(r0 + 32 * i), x, K, k0 + r0 + 32 * i, HW);
    }
  };
  // the register-staged part: gathers of 8 positions, every load of the
  // chunk first, then the prologue and the 16-byte stores
  auto gather = [&](int s, int ch) {
    if (EVEC && XVEC) return;
    char* as = smem + s * L::STAGE;
    char* bs = as + L::ABYTES;
    Pos8 d;
    decode8(ch * kW1P + pg * 8, geo, geo.stride, &d);
    float va[EVEC ? 1 : kAItems][8], vb[XVEC ? 1 : kBItems][8];
    if (!EVEC) {
#pragma unroll
      for (int i = 0; i < kAItems; ++i) gather8(dce, n0 + r0 + 32 * i, N, HWo, d.e, va[i]);
    }
    if (!XVEC) {
#pragma unroll
      for (int i = 0; i < kBItems; ++i)
        gather8(x, k0 + r0 + 32 * i, K, geo.H * geo.W, d.x, vb[i]);
    }
    if (!EVEC) {
#pragma unroll
      for (int i = 0; i < kAItems; ++i) store8(as + dst(r0 + 32 * i), va[i]);
    }
    if (!XVEC) {
#pragma unroll
      for (int i = 0; i < kBItems; ++i) {
        const bool row = k0 + r0 + 32 * i < K;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (PRO && row && d.x[j] >= 0) vb[i][j] = bf16::prologue(vb[i][j], sc[i], sf[i], relu);
        store8(bs + dst(r0 + 32 * i), vb[i]);
      }
    }
  };
  // XVEC with the prologue: applied in place once this thread's copies of a
  // chunk landed (past the positions a copy zero-filled, it stays 0)
  auto normalise = [&](int s, int ch) {
    if (!(XVEC && PRO)) return;
    char* bs = smem + s * L::STAGE + L::ABYTES;
    const bool pin = ch * kW1P + pg * 8 < geo.B * HWo;
#pragma unroll
    for (int i = 0; i < kBItems; ++i)
      if (pin && k0 + r0 + 32 * i < K) prologue8(bs + dst(r0 + 32 * i), sc[i], sf[i], relu);
  };

  float acc[BNK / 2] = {}, d[BNK / 2] = {};
#pragma unroll
  for (int s = 0; s < kW1Stages - 1; ++s) {
    if (s < nch) copy(s, c0 + s), gather(s, c0 + s);
    cp_async_commit();
  }
  for (int it = 0; it < nch; ++it) {
    cp_async_wait<kW1Stages - 2>();
    normalise(it % kW1Stages, c0 + it);
    wg::fence_proxy_async();
    __syncthreads();
    const int nk = it + kW1Stages - 1;
    if (nk < nch) copy(nk % kW1Stages, c0 + nk);
    cp_async_commit();
    const char* as = smem + (it % kW1Stages) * L::STAGE;
    // [channel group][position group]: K (positions) steps 128 bytes, M/N
    // (channels) 8 · 128
    const uint64_t da = wg::desc(as + wgi * 8 * 1024, 128, 1024);
    const uint64_t db = wg::desc(as + L::ABYTES, 128, 1024);
    wg::fence_operand(acc);
    wg::fence_operand(d);
    wg::fence();
#pragma unroll
    for (int s = 0; s < kW1P / 16; ++s) {
      if (it == 0) wg::Mma<BNK>::ss(acc, wg::advance(da, 256 * s), wg::advance(db, 256 * s), s);
      else wg::Mma<BNK>::ss(d, wg::advance(da, 256 * s), wg::advance(db, 256 * s), s);
    }
    wg::commit();
    if (nk < nch) gather(nk % kW1Stages, c0 + nk);
    wg::wait<0>();
    wg::fence_operand(acc);
    wg::fence_operand(d);
    if (it > 0) {
#pragma unroll
      for (int i = 0; i < BNK / 2; ++i) acc[i] += d[i];
    }
  }
  cp_async_wait<0>();
  // an empty split writes its zeros too: the second pass reads every row
  float* out = dw_part + static_cast<size_t>(blockIdx.z) * N * K;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + 64 * wgi + 16 * warp + gq + 8 * h;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < BNK / 8; ++j) {
      const int k = k0 + 8 * j + 2 * t;  // even, and K % 8 == 0
      if (k < K)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(n) * K + k) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

template <int BNK, bool EVEC, bool XVEC, bool PRO>
__global__ void __launch_bounds__(kThreads, 1)
conv_bn_bf16_bwd_wgrad1_kernel(const bf16_t* __restrict__ x, const bf16_t* __restrict__ scale,
                               const bf16_t* __restrict__ shift, const bf16_t* __restrict__ dce,
                               float* __restrict__ dw_part, Geo geo, bool relu, int splits) {
  wgrad1_body<BNK, EVEC, XVEC, PRO>(x, scale, shift, dce, dw_part, geo, relu, splits);
}

// The stash form's 1x1 wgrad: the bare-input path on xn, geo its grid (H, W
// = H', W', stride 1), so xn takes dce's copies (EVEC both).
template <int BNK, bool EVEC>
__global__ void __launch_bounds__(kThreads, 1)
conv_bn_stash_bf16_bwd_wgrad1_kernel(const bf16_t* __restrict__ xn,
                                     const bf16_t* __restrict__ dce, float* __restrict__ dw_part,
                                     Geo geo, int splits) {
  wgrad1_body<BNK, EVEC, EVEC, false>(xn, nullptr, nullptr, dce, dw_part, geo, false, splits);
}

// ---- wgrad, 3x3: 64 output (n) by 64 input (k) channels a block and all
// nine taps; a stage is one TH x 8 pixel tile. Both warpgroups share dce's
// 64 rows (A); warpgroup g owns k 32g .. 32g + 31 (wgmma N = 32) of each
// tap. A stage: dce [n group][pixel row][8 n][8 pixels], then x's bordered
// tile three times, shifted 0, 1, 2 columns: [shift][k group][halo row][8
// k][8 pixels]. A k16 step is two pixel rows.
constexpr int kW3N = 64, kW3K = 64, kW3Stages = 3;

// The wgrad's tile height for an output grid of Ho rows (ops/conv_bn.py
// _wgrad_tile_h at bf16).
__host__ __device__ inline int wgrad3_tile_h(int Ho) { return Ho % 14 == 0 ? 14 : 8; }

template <int TH>
struct W3 {
  static constexpr int HY = TH + 2;
  static constexpr int ABYTES = kW3N * TH * 8 * 2;
  static constexpr int BBYTES = 3 * kW3K * HY * 8 * 2;
  static constexpr int STAGE = ABYTES + BBYTES;
  static constexpr int SMEM = kW3Stages * STAGE;  // 190 464 or 116 736 bytes
};

// EVEC: W' % 8 == 0, so a pixel row of dce's tile is one aligned 16-byte
// copy. One block an SM, with up to 255 registers a thread: the nine taps'
// sums are 144 of them.
template <int TH, bool EVEC, bool PRO>
__device__ __forceinline__ void wgrad3_body(const bf16_t* __restrict__ x,
                                            const bf16_t* __restrict__ scale,
                                            const bf16_t* __restrict__ shift,
                                            const bf16_t* __restrict__ dce,
                                            float* __restrict__ dw_part, const Geo& geo,
                                            bool relu, int splits) {
  using L = W3<TH>;
  constexpr int HY = L::HY;
  extern __shared__ __align__(128) char smem[];
  const int tid = threadIdx.x, lane = tid & 31, wgi = tid >> 7, warp = (tid >> 5) & 3;
  const int gq = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kW3N, k0 = blockIdx.y * kW3K;
  const int N = geo.N, K = geo.K, H = geo.H, W = geo.W;
  const size_t HW = static_cast<size_t>(H) * W;
  const int tiles_x = ceil_div(W, kTileW), per_img = ceil_div(H, TH) * tiles_x;
  const int chunks = geo.B * per_img, per = ceil_div(chunks, splits);
  const int c0 = blockIdx.z * per, nch = max(0, min(chunks, c0 + per) - c0);
  auto corner = [&](int ch, int* b, int* oy0, int* ox0) {
    *b = ch / per_img;
    const int tile = ch - *b * per_img;
    *oy0 = (tile / tiles_x) * TH;
    *ox0 = (tile % tiles_x) * kTileW;
  };
  constexpr int kAItems = kW3N * TH;  // (n, pixel row)
  constexpr int kBItems = kW3K * HY;  // (k, halo row)
  // dce's pixel rows: cp.async where aligned (EVEC), else gathered
  auto stage_a = [&](int s, int ch, bool async) {
    char* as = smem + s * L::STAGE;
    int b, oy0, ox0;
    corner(ch, &b, &oy0, &ox0);
    for (int it = tid; it < kAItems; it += kThreads) {
      const int n = it / TH, py = it - n * TH;
      char* to = as + ((n >> 3) * TH + py) * 128 + (n & 7) * 16;
      const int oy = oy0 + py;
      const bool row = n0 + n < N && oy < H;
      const bf16_t* from = dce + (static_cast<size_t>(b) * N + n0 + n) * HW +
                           static_cast<size_t>(oy) * W + ox0;
      if (EVEC) {
        if (async) cp_async16(to, row ? from : dce, row);
      } else if (!async) {
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = row && ox0 + j < W ? ldg1(from + j) : 0.f;
        store8(to, v);
      }
    }
  };
  // x's bordered tile, normalised (0 outside the image: the conv's padding
  // is of the normalised input), as its three column shifts (the loads of
  // a row a thread; holding a later stage's loads in registers across the
  // taps, or loading its 8 pixels as one piece, measured slower)
  auto stage_b = [&](int s, int ch) {
    char* bs = smem + s * L::STAGE + L::ABYTES;
    int b, oy0, ox0;
    corner(ch, &b, &oy0, &ox0);
    for (int it = tid; it < kBItems; it += kThreads) {
      const int k = it / HY, hy = it - k * HY;
      const int iy = oy0 - 1 + hy;
      const bool row = k0 + k < K && iy >= 0 && iy < H;
      const bf16_t* from = x + (static_cast<size_t>(b) * K + k0 + k) * HW +
                           static_cast<size_t>(row ? iy : 0) * W;
      const float sc = PRO && row ? ldg1(scale + k0 + k) : 1.f;
      const float sh = PRO && row ? ldg1(shift + k0 + k) : 0.f;
      float v[kHaloW];
#pragma unroll
      for (int j = 0; j < kHaloW; ++j) {
        const int ix = ox0 - 1 + j;
        v[j] = row && ix >= 0 && ix < W ? ldg1(from + ix) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kHaloW; ++j) {
        const int ix = ox0 - 1 + j;
        if (PRO) v[j] = row && ix >= 0 && ix < W ? bf16::prologue(v[j], sc, sh, relu) : 0.f;
      }
      char* to = bs + ((k >> 3) * HY + hy) * 128 + (k & 7) * 16;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        sts128(to + dx * (kW3K / 8) * HY * 128, bits2(v[dx], v[dx + 1]),
               bits2(v[dx + 2], v[dx + 3]), bits2(v[dx + 4], v[dx + 5]),
               bits2(v[dx + 6], v[dx + 7]));
    }
  };

  float acc[9][16] = {}, f[2][16] = {};
#pragma unroll
  for (int s = 0; s < kW3Stages - 1; ++s) {
    if (s < nch) stage_a(s, c0 + s, true), stage_a(s, c0 + s, false), stage_b(s, c0 + s);
    cp_async_commit();
  }
  for (int it = 0; it < nch; ++it) {
    cp_async_wait<kW3Stages - 2>();
    wg::fence_proxy_async();
    __syncthreads();
    const int nk = it + kW3Stages - 1;
    if (nk < nch) stage_a(nk % kW3Stages, c0 + nk, true);
    cp_async_commit();
    const char* as = smem + (it % kW3Stages) * L::STAGE;
    const char* bs = as + L::ABYTES;
    // A: K (pixel rows) steps 128 bytes, M (n groups) TH · 128; B: K steps
    // 128, N (k groups) HY · 128; tap (dy, dx) starts dy rows into shift dx
    const uint64_t da = wg::desc(as, 128, TH * 128);
    const uint64_t db = wg::desc(bs + wgi * 4 * HY * 128, 128, HY * 128);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const uint32_t tb = ((tap % 3) * (kW3K / 8) * HY + tap / 3) * 128;
      wg::fence_operand(f[tap & 1]);
      wg::fence();
#pragma unroll
      for (int s = 0; s < TH / 2; ++s)
        wg::Mma<32>::ss(f[tap & 1], wg::advance(da, 256 * s), wg::advance(db, tb + 256 * s), s);
      wg::commit();
      // the next stage's register-staged parts while the products run: a
      // half's loads after taps 0 and 3, their stores after taps 2 and 5
      if (tap == 0 && nk < nch) {
        stage_a(nk % kW3Stages, c0 + nk, false);
        stage_b(nk % kW3Stages, c0 + nk);
      }
      if (tap > 0) {
        wg::wait<1>();
        wg::fence_operand(f[(tap - 1) & 1]);
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[tap - 1][i] += f[(tap - 1) & 1][i];
      }
    }
    wg::wait<0>();
    wg::fence_operand(f[0]);
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[8][i] += f[0][i];
  }
  cp_async_wait<0>();
  float* out = dw_part + static_cast<size_t>(blockIdx.z) * N * K * 9;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + 16 * warp + gq + 8 * h;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = k0 + 32 * wgi + 8 * j + 2 * t + e;
        if (n >= N || k >= K) continue;
        float* o = out + (static_cast<size_t>(n) * K + k) * 9;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) o[tap] = acc[tap][4 * j + 2 * h + e];
      }
    }
  }
}

template <int TH, bool EVEC, bool PRO>
__global__ void __launch_bounds__(kThreads, 1)
conv_bn_bf16_bwd_wgrad3_kernel(const bf16_t* __restrict__ x, const bf16_t* __restrict__ scale,
                               const bf16_t* __restrict__ shift, const bf16_t* __restrict__ dce,
                               float* __restrict__ dw_part, Geo geo, bool relu, int splits) {
  wgrad3_body<TH, EVEC, PRO>(x, scale, shift, dce, dw_part, geo, relu, splits);
}

// The stash form's 3x3 wgrad: the bare-input path on xn (x's grid; the
// zero-filled border is the padding of the normalised input).
template <int TH, bool EVEC>
__global__ void __launch_bounds__(kThreads, 1)
conv_bn_stash_bf16_bwd_wgrad3_kernel(const bf16_t* __restrict__ xn,
                                     const bf16_t* __restrict__ dce, float* __restrict__ dw_part,
                                     Geo geo, int splits) {
  wgrad3_body<TH, EVEC, false>(xn, nullptr, nullptr, dce, dw_part, geo, false, splits);
}

// The second pass: dw rounded to bf16 (splits rows), dscale and dshift in
// f32 (parts rows).
template <typename OutT>
__global__ void conv_bn_bf16_bwd_partials_sum(const float* __restrict__ part,
                                              OutT* __restrict__ out, int P, int C) {
  mxt::sum_rows(part, out, P, C);
}

template <typename OutT>
__global__ void conv_bn_stash_bf16_bwd_partials_sum(const float* __restrict__ part,
                                                    OutT* __restrict__ out, int P, int C) {
  mxt::sum_rows(part, out, P, C);
}

template <typename Kernel>
cudaError_t raised(Kernel kernel, int smem, bool* done) {
  return mxt::raise_smem(kernel, smem, done);
}

// ---- launches
template <bool STASH, int TAPS, int TH, int WM, bool PRO, bool XVEC>
cudaError_t dgrad(cudaStream_t st, const Geo& g, int np, const bf16_t* x, const bf16_t* wt,
                  const bf16_t* scale, const bf16_t* shift, const bf16_t* dce, bf16_t* dx,
                  float* part, bool relu, const bf16_t* xn) {
  using F = Fwd<TAPS, TH, WM, bf16_t>;
  // the ring, then x's tile (PRO) and xn's (STASH)
  constexpr int kSmem = F::SMEM + (PRO || STASH ? F::RES : 0) + (STASH ? F::RES : 0);
  static bool done = false;
  const dim3 grid(parts(g, TAPS) * ceil_div(g.K, F::BM));
  cudaError_t err;
  if constexpr (STASH) {
    auto kernel = conv_bn_stash_bf16_bwd_dgrad_kernel<TAPS, TH, WM, XVEC>;
    if ((err = raised(kernel, kSmem, &done)) != cudaSuccess) return err;
    kernel<<<grid, kThreads, kSmem, st>>>(x, wt, scale, shift, dce, dx, part, g, np, relu, xn);
  } else {
    auto kernel = conv_bn_bf16_bwd_dgrad_kernel<TAPS, TH, WM, PRO, XVEC>;
    if ((err = raised(kernel, kSmem, &done)) != cudaSuccess) return err;
    kernel<<<grid, kThreads, kSmem, st>>>(x, wt, scale, shift, dce, dx, part, g, np, relu);
  }
  return cudaGetLastError();
}

template <bool STASH, bool PRO>
cudaError_t dgrad_tiles(cudaStream_t st, const Geo& g, int np, int taps, const bf16_t* x,
                        const bf16_t* wt, const bf16_t* scale, const bf16_t* shift,
                        const bf16_t* dce, bf16_t* dx, float* part, bool relu,
                        const bf16_t* xn) {
  const int th = tile_h(g.Ho), wm = tile_wm(g.K, taps, th);
#define MXT_DGRAD(TAPS, TH, WM, XV) \
  dgrad<STASH, TAPS, TH, WM, PRO, XV>(st, g, np, x, wt, scale, shift, dce, dx, part, relu, xn)
  if (taps == 1) {
    // dce's rows of 8 positions are copied where H'W' is even
    if ((g.Ho * g.Wo) % 2 == 0)
      return wm == 2 ? MXT_DGRAD(1, 1, 2, true) : MXT_DGRAD(1, 1, 1, true);
    return wm == 2 ? MXT_DGRAD(1, 1, 2, false) : MXT_DGRAD(1, 1, 1, false);
  }
  if (th == 14) return wm == 2 ? MXT_DGRAD(9, 14, 2, false) : MXT_DGRAD(9, 14, 1, false);
  if (th == 7) return MXT_DGRAD(9, 7, 2, false);
  return wm == 2 ? MXT_DGRAD(9, 8, 2, false) : MXT_DGRAD(9, 8, 1, false);
#undef MXT_DGRAD
}

// The wgrad on x (recompute: with the prologue) or, STASH, on xn (its own
// grid, no prologue).
template <bool STASH, bool PRO>
cudaError_t wgrad(cudaStream_t st, const Geo& g, int splits, int taps, const bf16_t* x,
                  const bf16_t* scale, const bf16_t* shift, const bf16_t* dce, float* dw_part,
                  bool relu) {
  const int HWo = g.Ho * g.Wo;
  cudaError_t err;
  if (taps == 1) {
    // the stash form reads xn on the output grid at stride 1
    const Geo gx = STASH ? make_geo(g.B, g.K, g.Ho, g.Wo, g.N, 1, 1) : g;
    const bool evec = HWo % 2 == 0, xvec = evec && gx.stride == 1;
    const int bnk = wgrad1_bnk(g.K);
    const dim3 grid(ceil_div(g.N, kW1N), ceil_div(g.K, bnk), splits);
    auto go = [&](auto kernel, int smem, bool* done) -> cudaError_t {
      cudaError_t e = raised(kernel, smem, done);
      if (e != cudaSuccess) return e;
      if constexpr (STASH)
        kernel<<<grid, kThreads, smem, st>>>(x, dce, dw_part, gx, splits);
      else
        kernel<<<grid, kThreads, smem, st>>>(x, scale, shift, dce, dw_part, gx, relu, splits);
      return cudaGetLastError();
    };
#define MXT_W1(BNK, EV, XV)                                                                 \
  do {                                                                                      \
    static bool done = false;                                                               \
    if constexpr (STASH)                                                                    \
      err = go(conv_bn_stash_bf16_bwd_wgrad1_kernel<BNK, EV>, W1<BNK>::SMEM, &done);        \
    else                                                                                    \
      err = go(conv_bn_bf16_bwd_wgrad1_kernel<BNK, EV, XV, PRO>, W1<BNK>::SMEM, &done);     \
  } while (0)
    if (bnk == 128) {
      if (xvec) MXT_W1(128, true, true);
      else if (evec) MXT_W1(128, true, false);
      else MXT_W1(128, false, false);
    } else {
      if (xvec) MXT_W1(64, true, true);
      else if (evec) MXT_W1(64, true, false);
      else MXT_W1(64, false, false);
    }
#undef MXT_W1
    return err;
  }
  const bool evec = g.Wo % 8 == 0;
  const dim3 grid(ceil_div(g.N, kW3N), ceil_div(g.K, kW3K), splits);
#define MXT_W3(TH, EV)                                                                          \
  do {                                                                                          \
    static bool done = false;                                                                   \
    if constexpr (STASH) {                                                                      \
      auto kernel = conv_bn_stash_bf16_bwd_wgrad3_kernel<TH, EV>;                               \
      if ((err = raised(kernel, W3<TH>::SMEM, &done)) != cudaSuccess) return err;               \
      kernel<<<grid, kThreads, W3<TH>::SMEM, st>>>(x, dce, dw_part, g, splits);                 \
    } else {                                                                                    \
      auto kernel = conv_bn_bf16_bwd_wgrad3_kernel<TH, EV, PRO>;                                \
      if ((err = raised(kernel, W3<TH>::SMEM, &done)) != cudaSuccess) return err;               \
      kernel<<<grid, kThreads, W3<TH>::SMEM, st>>>(x, scale, shift, dce, dw_part, g, relu,      \
                                                   splits);                                     \
    }                                                                                           \
  } while (0)
  if (wgrad3_tile_h(g.Ho) == 14) {
    if (evec) MXT_W3(14, true);
    else MXT_W3(14, false);
  } else {
    if (evec) MXT_W3(8, true);
    else MXT_W3(8, false);
  }
#undef MXT_W3
  return cudaGetLastError();
}

// The five passes. STASH: xn (B, K, H', W') read in place of the prologue's
// recompute, which must be there.
template <bool STASH>
int bwd_run(const bf16_t* x, const bf16_t* w, const bf16_t* scale, const bf16_t* shift,
            const bf16_t* c, const bf16_t* dc, const float* ds, const float* dq,
            const bf16_t* xn, bf16_t* dx, bf16_t* dw, float* dw_part, float* dss,
            float* dss_part, bf16_t* dce, bf16_t* wt, int B, int K, int H, int W, int N, int taps,
            int stride, int relu, int nparts, int splits, void* stream) {
  const bool pro = scale != nullptr;
  if (!valid_call(B, K, H, W, N, taps, stride) || (shift != nullptr) != pro ||
      (dss != nullptr) != pro || (dss_part != nullptr) != pro || splits < 1 || splits > 65535 ||
      (STASH && (!pro || xn == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  // x (the 1x1 wgrad at stride 1), dce, wt and xn are copied in 16-byte
  // pieces; the others are read and written in up to 8
  if (misaligned(x, 16) || misaligned(w, 8) || misaligned(c, 8) || misaligned(dc, 8) ||
      misaligned(dce, 16) || misaligned(dx, 8) || misaligned(wt, 16) ||
      (STASH && misaligned(xn, 16)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Geo g = make_geo(B, K, H, W, N, taps, stride);
  if (nparts != parts(g, taps)) return static_cast<int>(cudaErrorInvalidValue);
  // the 1x1 wgrad's gathers take 32-bit offsets into x and dce
  if (static_cast<long long>(B) * (K > N ? K : N) * H * W >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int HWo = g.Ho * g.Wo, np = ceil_div(N, 8) * 8;
  const size_t total = static_cast<size_t>(B) * N * HWo;
  const size_t fold_items = HWo % 4 == 0 ? total / 4 : total;
  const int fold_blocks = static_cast<int>(
      fold_items < 132 * 16 * kThreads ? (fold_items + kThreads - 1) / kThreads : 132 * 16);
  const dim3 fgrid(ceil_div(np, convbn::kFlipTile), ceil_div(K, convbn::kFlipTile));
  if (STASH) {
    const auto fold_k = HWo % 4 == 0 ? conv_bn_stash_bf16_bwd_fold_kernel<true>
                                     : conv_bn_stash_bf16_bwd_fold_kernel<false>;
    fold_k<<<fold_blocks, kThreads, 0, st>>>(dc, c, ds, dq, dce, N, HWo, total);
    const auto flip_k = taps == 1 ? conv_bn_stash_bf16_bwd_wflip_kernel<1>
                                  : conv_bn_stash_bf16_bwd_wflip_kernel<9>;
    flip_k<<<fgrid, kThreads, 0, st>>>(w, wt, N, K, np);
  } else {
    const auto fold_k = HWo % 4 == 0 ? conv_bn_bf16_bwd_fold_kernel<true>
                                     : conv_bn_bf16_bwd_fold_kernel<false>;
    fold_k<<<fold_blocks, kThreads, 0, st>>>(dc, c, ds, dq, dce, N, HWo, total);
    const auto flip_k =
        taps == 1 ? conv_bn_bf16_bwd_wflip_kernel<1> : conv_bn_bf16_bwd_wflip_kernel<9>;
    flip_k<<<fgrid, kThreads, 0, st>>>(w, wt, N, K, np);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (STASH || pro)
    err = dgrad_tiles<STASH, true>(st, g, np, taps, x, wt, scale, shift, dce, dx, dss_part,
                                   relu != 0, xn);
  else
    err = dgrad_tiles<STASH, false>(st, g, np, taps, x, wt, scale, shift, dce, dx, dss_part,
                                    relu != 0, xn);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (STASH)
    err = wgrad<true, false>(st, g, splits, taps, xn, nullptr, nullptr, dce, dw_part, false);
  else if (pro)
    err = wgrad<false, true>(st, g, splits, taps, x, scale, shift, dce, dw_part, relu != 0);
  else
    err = wgrad<false, false>(st, g, splits, taps, x, scale, shift, dce, dw_part, relu != 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid, block;
  const int C = N * K * taps;
  mxt::sum_rows_shape(splits, C, &grid, &block);
  if (STASH)
    conv_bn_stash_bf16_bwd_partials_sum<bf16_t><<<grid, block, 0, st>>>(dw_part, dw, splits, C);
  else
    conv_bn_bf16_bwd_partials_sum<bf16_t><<<grid, block, 0, st>>>(dw_part, dw, splits, C);
  if (pro) {
    mxt::sum_rows_shape(nparts, 2 * K, &grid, &block);
    if (STASH)
      conv_bn_stash_bf16_bwd_partials_sum<float><<<grid, block, 0, st>>>(dss_part, dss, nparts,
                                                                         2 * K);
    else
      conv_bn_bf16_bwd_partials_sum<float><<<grid, block, 0, st>>>(dss_part, dss, nparts, 2 * K);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16 form: x, w, scale, shift, c, dc, dx, dw, dce (dres) and wt are bf16
// (2 bytes an element; wt K · N' · taps of them, N' = N rounded up to 8);
// ds, dq, dw_part, dss and dss_part f32. parts: the dscale/dshift partial
// rows (ops/conv_bn.py _fwd_parts at bf16: the dgrad runs the forward's
// tiling), checked; splits: the wgrad blocks along the reduction (1 ..=
// 65535, ops/conv_bn.py _wgrad_splits at bf16), dw_part holding splits rows
// of N·K·taps. dss and dss_part are NULL without a prologue.
extern "C" int mxt_conv_bn_bwd_bf16(const bf16_t* x, const bf16_t* w, const bf16_t* scale,
                                    const bf16_t* shift, const bf16_t* c, const bf16_t* dc,
                                    const float* ds, const float* dq, bf16_t* dx, bf16_t* dw,
                                    float* dw_part, float* dss, float* dss_part, bf16_t* dce,
                                    bf16_t* wt, int B, int K, int H, int W, int N, int taps,
                                    int stride, int relu, int parts, int splits, void* stream) {
  return bwd_run<false>(x, w, scale, shift, c, dc, ds, dq, nullptr, dx, dw, dw_part, dss,
                        dss_part, dce, wt, B, K, H, W, N, taps, stride, relu, parts, splits,
                        stream);
}

// The stash form: mxt_conv_bn_bwd_bf16 with xn (B, K, H', W'), the forward's
// stashed prologue output in bf16, read in place of its recompute. The
// prologue (scale, shift, dss, dss_part) is required.
extern "C" int mxt_conv_bn_bwd_stash_bf16(const bf16_t* x, const bf16_t* w,
                                          const bf16_t* scale, const bf16_t* shift,
                                          const bf16_t* c, const bf16_t* dc, const float* ds,
                                          const float* dq, const bf16_t* xn, bf16_t* dx,
                                          bf16_t* dw, float* dw_part, float* dss,
                                          float* dss_part, bf16_t* dce, bf16_t* wt, int B, int K,
                                          int H, int W, int N, int taps, int stride, int relu,
                                          int parts, int splits, void* stream) {
  return bwd_run<true>(x, w, scale, shift, c, dc, ds, dq, xn, dx, dw, dw_part, dss, dss_part,
                       dce, wt, B, K, H, W, N, taps, stride, relu, parts, splits, stream);
}
