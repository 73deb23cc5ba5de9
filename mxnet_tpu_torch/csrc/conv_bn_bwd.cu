// Fused conv + BatchNorm backward: dx, dw, dscale, dshift and dres of
// conv_bn.cu's forward, from the raw input x, the saved output c, its
// cotangent dc and the statistics' cotangents ds, dq (N,).
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_conv_bn.py _bwd_kernel
// (:511), launched by _conv_block_bwd_impl (:619, pallas_call :692), in its
// recompute policy: xn = relu(x·scale + shift) is rederived from x.
//
// Bound on an H100: operations, twice the forward's 2·B·H'W'·N·K·taps FLOP,
// at f32 accuracy on the TF32 tensor cores (3xTF32, tf32x3.cuh: 3 · FLOP at
// 495 TFLOP/s), 0.0897 ms at stage 1's 3x3; at stage 1's 1x1 with the
// residual bytes (0.107 ms). The TPU runs one kernel over (K/bk, B) and
// carries dw across the batch sweep in VMEM. GPU blocks run in no order, so
// the work is split by who owns each output, as the flash backward is split
// into dq and dk/dv, and both products run on mma.sync fed by cp.async rings:
// - fold: dce = dc + ds + 2·c·dq, the statistics folded into the output's
//   cotangent, written once (into dres where the forward added a residual,
//   else into a scratch the caller allocates). Both products read it as one
//   plane: one write of B·N·H'W' floats, against a fold in every dgrad
//   channel block and every wgrad block from dc and c (two planes each).
// - wflip: w (N, K, taps) transposed and its taps flipped into wt (K, N'·taps),
//   N' = N rounded up to 8 with zero columns: at most 9.4 MB, stage 4's 3x3.
// - dgrad: da[k, p] = Σ_t Σ_n W[n, k, t] · dce[n, p − s_t], the forward's
//   implicit GEMM with the roles swapped: rows are the input channels (A =
//   wt, whose rows are contiguous along the contraction), columns the output
//   positions, the contraction N'·taps over dce. It runs conv_bn.cuh's
//   tc_mainloop, the forward's tiling (128 flattened positions for 1x1, an
//   8 x 8 pixel tile with its border for 3x3), then the prologue's backward
//   in the epilogue: da *= (xn > 0) with xn recomputed from x, dx =
//   da·scale, and one partial row of Σ da·x (dscale) and Σ da (dshift) per
//   position tile. A 1x1 stride-2 conv writes dx at the sampled positions
//   and the zeros at the three others of each 2 x 2 cell, so dx needs no
//   memset (pallas_conv_bn.py:707-709 zero-fills it).
// - wgrad: dw[n, k, t] = Σ_p dce[n, p] · xn[k, p + s_t] over P = B·H'W'.
//   Both operands run along p in NCHW, so both fragments are 8-byte split2
//   loads; the BatchNorm prologue is applied to x's fragments (1x1) or once
//   an element in shared memory (3x3). P is split over blocks to fill the
//   SMs, each split writing a partial dw. 1x1: a block owns 128 output by
//   64 input channels and streams its positions 32 at a time. 3x3: a block
//   owns 64 output by 32 input channels and all 9 taps (72 accumulators a
//   thread), and a stage is one 8 x 8 pixel tile of dce with the 10 x 10
//   bordered tile of x: the nine taps are shifted reads of one staging.
// - a fixed-order second pass adds the partial dw and dscale/dshift rows:
//   no atomics, so two runs give the same bits.
// Every product keeps mma3's fresh accumulator for each 8-deep step, added
// to the running sum with one rounding to nearest: a wgrad split adds up to
// thousands of steps (tests/test_torch_tf32x3.py emulates the sums).
#include "conv_bn.cuh"

namespace {

using namespace mxt::convbn;

// dce = dc + ds + 2·c·dq, rounded as the plain version rounds it
__device__ __forceinline__ float dce_of(float dc, float c, float ds, float dq) {
  return __fadd_rn(__fadd_rn(dc, ds), __fmul_rn(2.f * c, dq));
}

// VEC: H'W' % 4 == 0, so four consecutive elements share a channel.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
conv_bn_bwd_fold_kernel(const float* __restrict__ dc, const float* __restrict__ c,
                        const float* __restrict__ ds, const float* __restrict__ dq,
                        float* __restrict__ dce, int N, int HWo, size_t total) {
  const size_t step = static_cast<size_t>(gridDim.x) * blockDim.x;
  if (VEC) {
    for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total / 4;
         i += step) {
      const int n = static_cast<int>((4 * i / HWo) % N);
      const float4 a = __ldg(reinterpret_cast<const float4*>(dc) + i);
      const float4 b = __ldg(reinterpret_cast<const float4*>(c) + i);
      const float s = __ldg(ds + n), q = __ldg(dq + n);
      reinterpret_cast<float4*>(dce)[i] =
          make_float4(dce_of(a.x, b.x, s, q), dce_of(a.y, b.y, s, q), dce_of(a.z, b.z, s, q),
                      dce_of(a.w, b.w, s, q));
    }
  } else {
    for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
         i += step) {
      const int n = static_cast<int>((i / HWo) % N);
      dce[i] = dce_of(__ldg(dc + i), __ldg(c + i), __ldg(ds + n), __ldg(dq + n));
    }
  }
}

// wt[k][n·TAPS + t] = w[n][k][TAPS − 1 − t] (0 for n ≥ N), through a 32 x 32
// tile of (n, k) in shared memory so that both sides are read and written
// along rows. The flip: da[p] takes dce[p − s_t] where c[o] took xn[o + s_t].
constexpr int kFlipTile = 32;

template <int TAPS>
__global__ void __launch_bounds__(kThreads)
conv_bn_bwd_wflip_kernel(const float* __restrict__ w, float* __restrict__ wt, int N, int K,
                         int np) {
  constexpr int RW = kFlipTile * TAPS;
  __shared__ float s[kFlipTile][RW + 1];
  const int n0 = blockIdx.x * kFlipTile, k0 = blockIdx.y * kFlipTile;
  for (int e = threadIdx.x; e < kFlipTile * RW; e += kThreads) {
    const int r = e / RW, col = e - r * RW;  // row n0 + r, columns (k, t)
    const int n = n0 + r, k = k0 + col / TAPS;
    s[r][col] = n < N && k < K ? w[(static_cast<size_t>(n) * K + k0) * TAPS + col] : 0.f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kFlipTile * RW; e += kThreads) {
    const int r = e / RW, col = e - r * RW;  // row k0 + r, columns (n, t)
    const int nn = col / TAPS, tp = col - nn * TAPS, k = k0 + r;
    if (k < K && n0 + nn < np)
      wt[(static_cast<size_t>(k) * np + n0) * TAPS + col] = s[nn][r * TAPS + TAPS - 1 - tp];
  }
}

// ---- dgrad: the forward's implicit GEMM over (wt, dce), then the prologue's
// backward. The input-channel blocks of one position tile run one after
// another, so the tile's dce is read from device memory once.
template <int TAPS, bool VEC, bool PRO>
__global__ void __launch_bounds__(kThreads, 2)
conv_bn_bwd_dgrad_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                         const float* __restrict__ scale, const float* __restrict__ shift,
                         const float* __restrict__ dce, float* __restrict__ dx,
                         float* __restrict__ part, Geo geo, int np, bool relu) {
  using C = Cfg<TAPS>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % C::WARPS_M, wn = warp / C::WARPS_M;
  const int kblocks = ceil_div(geo.K, C::BM);
  const int pt = blockIdx.x / kblocks, k0 = (blockIdx.x - pt * kblocks) * C::BM;
  const int K = geo.K;
  const TcArgs args{wt, dce, nullptr, nullptr, K, np, geo.N, geo.B,
                    geo.Ho, geo.Wo, geo.Ho, geo.Wo, 1, false};
  float acc[C::MT][C::NT][4] = {};
  tc_mainloop<TAPS, VEC, false>(args, pt, k0, smem, acc);

  // ---- epilogue: each of the thread's columns at its x offset (channel 0)
  const size_t HW = static_cast<size_t>(geo.H) * geo.W;
  const bool s2 = geo.stride == 2;
  size_t xb[C::NT][2];
  bool in[C::NT][2], right[C::NT][2], down[C::NT][2], vec[C::NT];
#pragma unroll
  for (int ni = 0; ni < C::NT; ++ni) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      int b, oy, ox;
      in[ni][j] = tile_col<TAPS>(geo, pt, wn * C::WN + ni * 8 + 2 * t + j, &b, &oy, &ox);
      const int iy = oy * geo.stride, ix = ox * geo.stride;
      xb[ni][j] = static_cast<size_t>(b) * K * HW + static_cast<size_t>(iy) * geo.W + ix;
      // stride 2: the unsampled neighbours of (iy, ix) inside the grid
      right[ni][j] = s2 && ix + 1 < geo.W;
      down[ni][j] = s2 && iy + 1 < geo.H;
    }
    // the pair as one access: stride 1, two adjacent positions (8 bytes);
    // stride 2, the 2 x 4 cell of two sampled positions and their unsampled
    // neighbours (a 16-byte row of x and dx, and one of zeros below it)
    vec[ni] = in[ni][0] && in[ni][1] &&
              (s2 ? xb[ni][1] == xb[ni][0] + 2 && xb[ni][0] % 4 == 0 && geo.W % 4 == 0
                  : xb[ni][1] == xb[ni][0] + 1 && xb[ni][0] % 2 == 0 && HW % 2 == 0);
  }
  float sx[C::MT][2], sh[C::MT][2];
#pragma unroll
  for (int mi = 0; mi < C::MT; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sx[mi][h] = 0.f, sh[mi][h] = 0.f;
      const int k = k0 + wm * C::WM + mi * 16 + g + 8 * h;
      if (k >= K) continue;
      const float sc = PRO ? __ldg(scale + k) : 1.f, sf = PRO ? __ldg(shift + k) : 0.f;
      const size_t koff = static_cast<size_t>(k) * HW;
      // dx of one position from da and x: the prologue's backward
      auto grad = [&](float da, float xv) {
        if (!PRO) return da;
        if (relu && !(prologue(xv, sc, sf, false) > 0.f)) da = 0.f;
        sx[mi][h] = fmaf(da, xv, sx[mi][h]);
        sh[mi][h] += da;
        return da * sc;
      };
#pragma unroll
      for (int ni = 0; ni < C::NT; ++ni) {
        const float da0 = acc[mi][ni][2 * h], da1 = acc[mi][ni][2 * h + 1];
        if (vec[ni]) {
          const size_t o = xb[ni][0] + koff;
          if (s2) {
            const float4 xv = PRO ? __ldg(reinterpret_cast<const float4*>(x + o))
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
            const float d0 = grad(da0, xv.x), d1 = grad(da1, xv.z);
            *reinterpret_cast<float4*>(dx + o) = make_float4(d0, 0.f, d1, 0.f);
            if (down[ni][0])
              *reinterpret_cast<float4*>(dx + o + geo.W) = make_float4(0.f, 0.f, 0.f, 0.f);
          } else {
            const float2 xv = PRO ? __ldg(reinterpret_cast<const float2*>(x + o))
                                  : make_float2(0.f, 0.f);
            const float d0 = grad(da0, xv.x), d1 = grad(da1, xv.y);
            *reinterpret_cast<float2*>(dx + o) = make_float2(d0, d1);
          }
          continue;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (!in[ni][j]) continue;
          const size_t o = xb[ni][j] + koff;
          dx[o] = grad(j ? da1 : da0, PRO ? __ldg(x + o) : 0.f);
          if (right[ni][j]) dx[o + 1] = 0.f;
          if (down[ni][j]) dx[o + geo.W] = 0.f;
          if (right[ni][j] && down[ni][j]) dx[o + geo.W + 1] = 0.f;
        }
      }
    }
  }
  if (PRO) {
    float a, d;
    tile_row_sums<TAPS>(sx, sh, smem, &a, &d);
    if (tid < C::BM && k0 + tid < K) {
      part[(static_cast<size_t>(pt) * 2) * K + k0 + tid] = a;
      part[(static_cast<size_t>(pt) * 2 + 1) * K + k0 + tid] = d;
    }
  }
}

// ---- wgrad, 1x1: a block owns 128 output (n) by 64 input (k) channels and
// the positions of its split, 32 a stage. 8 warps, 4 along n x 2 along k,
// each 32 x 32. A stage holds 128 dce rows then 64 x rows, each of the 32
// positions (rows 40 floats, 8 mod 32: a half-warp's 8-byte loads fall on
// distinct banks).
constexpr int kW1N = 128, kW1K = 64, kW1P = 32;
constexpr int kW1Row = kW1P + 8;
constexpr int kW1Rows = kW1N + kW1K;
constexpr int kW1Stages = 3;
constexpr int kW1Stage = kW1Rows * kW1Row;
constexpr int kW1Smem = kW1Stages * kW1Stage * 4;  // 92 160 bytes: two blocks an SM

// Copies ROWS rows of one operand into a stage: row r is channel c0 + r of
// the NCHW tensor src (C channels on an (H, W) grid), at the stage's 32
// positions q0 .. q0 + 31 of the flattened B·H'W' axis, sampled with stride
// from the grid; 0 past the channels or the positions. VEC: stride 1 and
// H'W' % 4 == 0, so 4 consecutive positions are one 16-byte copy of one
// image; otherwise (7 x 7, x at stride 2) 4-byte copies.
template <int ROWS, bool VEC>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int c0,
                                           int C, int H, int W, int stride, int q0,
                                           const Geo& g) {
  constexpr int kPerRow = VEC ? kW1P / 4 : kW1P;
  constexpr int kStep = kThreads / kPerRow;
  const int col = (threadIdx.x % kPerRow) * (VEC ? 4 : 1), r0 = threadIdx.x / kPerRow;
  const int HWo = g.Ho * g.Wo, q = q0 + col;
  const size_t HW = static_cast<size_t>(H) * W;
  const bool valid = q < g.B * HWo;
  const int b = valid ? q / HWo : 0, p = q - b * HWo;
  size_t o = static_cast<size_t>(b) * C * HW + p;
  if (stride != 1) {
    const int oy = p / g.Wo, ox = p - oy * g.Wo;
    o = static_cast<size_t>(b) * C * HW + static_cast<size_t>(oy * stride) * W + ox * stride;
  }
#pragma unroll
  for (int i = 0; i < ROWS / kStep; ++i) {
    const int r = r0 + i * kStep;
    const bool pr = valid && c0 + r < C;
    const float* from = pr ? src + o + static_cast<size_t>(c0 + r) * HW : src;
    if (VEC) cp_async16(dst + r * kW1Row + col, from, pr);
    else cp_async4(dst + r * kW1Row + col, from, pr);
  }
}

// EVEC: dce (on the output grid) in 16-byte copies, H'W' % 4 == 0; XVEC: x
// too (stride 1).
template <bool EVEC, bool XVEC, bool PRO>
__global__ void __launch_bounds__(kThreads, 2)
conv_bn_bwd_wgrad1_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                          const float* __restrict__ shift, const float* __restrict__ dce,
                          float* __restrict__ dw_part, Geo geo, bool relu, int splits) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int n0 = blockIdx.x * kW1N, k0 = blockIdx.y * kW1K;
  const int N = geo.N, K = geo.K;
  const int chunks = ceil_div(geo.B * geo.Ho * geo.Wo, kW1P), per = ceil_div(chunks, splits);
  const int c0 = blockIdx.z * per, nch = max(0, min(chunks, c0 + per) - c0);
  auto load = [&](int s, int ch) {
    float* st = smem + s * kW1Stage;
    stage_rows<kW1N, EVEC>(st, dce, n0, N, geo.Ho, geo.Wo, 1, ch * kW1P, geo);
    stage_rows<kW1K, XVEC>(st + kW1N * kW1Row, x, k0, K, geo.H, geo.W, geo.stride, ch * kW1P,
                           geo);
  };

  // the prologue's constants of the thread's B rows (k = row g of each n8 tile)
  float sc[4], sf[4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int k = k0 + wn * 32 + ni * 8 + g;
    sc[ni] = PRO && k < K ? __ldg(scale + k) : 1.f;
    sf[ni] = PRO && k < K ? __ldg(shift + k) : 0.f;
  }
  float acc[2][4][4] = {};
#pragma unroll
  for (int s = 0; s < kW1Stages - 1; ++s) {
    if (s < nch) load(s, c0 + s);
    cp_async_commit();
  }
  for (int it = 0; it < nch; ++it) {
    cp_async_wait<kW1Stages - 2>();
    __syncthreads();
    const int nk = it + kW1Stages - 1;
    if (nk < nch) load(nk % kW1Stages, c0 + nk);
    cp_async_commit();
    const float* es = smem + (it % kW1Stages) * kW1Stage;
    const float* xs = es + kW1N * kW1Row;
#pragma unroll
    for (int kk = 0; kk < kW1P; kk += 8) {
      // positions kk + 2t, kk + 2t + 1 are the step's k = t, t + 4 (tf32x3.cuh)
      uint32_t b_hi[4][2], b_lo[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float2 v =
            *reinterpret_cast<const float2*>(xs + (wn * 32 + ni * 8 + g) * kW1Row + kk + 2 * t);
        const float v0 = PRO ? prologue(v.x, sc[ni], sf[ni], relu) : v.x;
        const float v1 = PRO ? prologue(v.y, sc[ni], sf[ni], relu) : v.y;
        split(v0, b_hi[ni][0], b_lo[ni][0]);
        split(v1, b_hi[ni][1], b_lo[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* ar = es + (wm * 32 + mi * 16 + g) * kW1Row + kk + 2 * t;
        uint32_t a_hi[4], a_lo[4];
        split2(ar, a_hi[0], a_lo[0], a_hi[2], a_lo[2]);
        split2(ar + 8 * kW1Row, a_hi[1], a_lo[1], a_hi[3], a_lo[3]);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma3(acc[mi][ni], a_hi, a_lo, b_hi[ni], b_lo[ni]);
      }
    }
  }
  cp_async_wait<0>();
  // an empty split writes its zeros too: the second pass reads every row
  float* out = dw_part + static_cast<size_t>(blockIdx.z) * N * K;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + wm * 32 + mi * 16 + g + 8 * h;
      if (n >= N) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int k = k0 + wn * 32 + ni * 8 + 2 * t;  // even, and K % 8 == 0
        if (k < K)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(n) * K + k) =
              make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
}

// ---- wgrad, 3x3: a block owns 64 output (n) by 32 input (k) channels and
// all 9 taps; a stage is one TH x 8 pixel tile (TH = 8, or 7 where the grid's
// height is a multiple of 7 and not of 8: 28, 14 and 7 rows fill whole
// tiles): dce (64 rows of the tile's positions, rows 72 floats) and the
// bordered (TH + 2) x 10 tile of x (32 rows, 104 floats). 8 warps, 2 along n
// x 4 along k, each 32 n x 8 k x 9 taps. A step is one pixel row of the
// tile: its A fragments (dce) serve all nine taps, whose B fragments are the
// row shifted by (dy, dx) in the bordered tile, an 8-byte load for even dx
// and two 4-byte loads for odd.
constexpr int kW3N = 64, kW3K = 32;
constexpr int kW3ERow = kTileHW * kTileHW + 8;  // 72
constexpr int kW3XRow = 104;
constexpr int kW3Stages = 4;
constexpr int kW3Stage = kW3N * kW3ERow + kW3K * kW3XRow;
constexpr int kW3Smem = kW3Stages * kW3Stage * 4;  // 126 976 bytes

// The wgrad's tile height for an output grid of Ho rows (ops/conv_bn.py
// _wgrad_tile_h).
inline int wgrad3_tile_h(int Ho) { return Ho % kTileHW != 0 && Ho % 7 == 0 ? 7 : kTileHW; }

// One block an SM, with up to 255 registers a thread: under two blocks'
// 128 the 72 accumulators spill, and the kernel ran 13-14 % slower at
// ResNet-50's 3x3 sites on an H100 (PERF.md §6). VEC: W' % 4 == 0, so a
// pixel row of the tile is two 16-byte copies.
template <int TH, bool VEC, bool PRO>
__global__ void __launch_bounds__(kThreads, 1)
conv_bn_bwd_wgrad3_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                          const float* __restrict__ shift, const float* __restrict__ dce,
                          float* __restrict__ dw_part, Geo geo, bool relu, int splits) {
  constexpr int kHaloN = (TH + 2) * kHaloW;                     // bordered pixels
  constexpr int kCopies = (kW3K * kHaloN + kThreads - 1) / kThreads;  // x copies a thread
  constexpr int kSegs = VEC ? 2 : kTileHW;                      // dce copies a pixel row
  constexpr int kECopies = kW3N * TH * kSegs;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int n0 = blockIdx.x * kW3N, k0 = blockIdx.y * kW3K;
  const int N = geo.N, K = geo.K, H = geo.H, W = geo.W, HW = H * W;
  const int tiles_x = ceil_div(W, kTileHW), per_img = ceil_div(H, TH) * tiles_x;
  const int chunks = geo.B * per_img, per = ceil_div(chunks, splits);
  const int c0 = blockIdx.z * per, nch = max(0, min(chunks, c0 + per) - c0);

  // the tile's image and corner
  auto corner = [&](int ch, int* b, int* oy0, int* ox0) {
    *b = ch / per_img;
    const int tile = ch - *b * per_img;
    *oy0 = (tile / tiles_x) * TH;
    *ox0 = (tile % tiles_x) * kTileHW;
  };
  auto load = [&](int s, int ch) {
    float* es = smem + s * kW3Stage;
    float* xs = es + kW3N * kW3ERow;
    int b, oy0, ox0;
    corner(ch, &b, &oy0, &ox0);
#pragma unroll
    for (int i = 0; i < (kECopies + kThreads - 1) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      if (e >= kECopies) break;
      const int r = e / (TH * kSegs), seg = e - r * (TH * kSegs), n = n0 + r;
      const int py = seg / kSegs, px = (seg - py * kSegs) * (VEC ? 4 : 1);
      const bool pr = n < N && oy0 + py < H && ox0 + px < W;
      const float* from =
          pr ? dce + (static_cast<size_t>(b) * N + n) * HW + (oy0 + py) * W + ox0 + px : dce;
      float* to = es + r * kW3ERow + py * kTileHW + px;
      if (VEC) cp_async16(to, from, pr);
      else cp_async4(to, from, pr);
    }
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int e = tid + i * kThreads;
      if (e >= kW3K * kHaloN) break;
      const int kl = e / kHaloN, hp = e - kl * kHaloN;
      const int iy = oy0 - 1 + hp / kHaloW, ix = ox0 - 1 + hp % kHaloW;
      const bool pr = k0 + kl < K && iy >= 0 && iy < H && ix >= 0 && ix < W;
      const float* from =
          pr ? x + (static_cast<size_t>(b) * K + k0 + kl) * HW + iy * W + ix : x;
      cp_async4(xs + kl * kW3XRow + hp, from, pr);
    }
  };
  // the prologue once an element, by the thread that copied it; 0 outside
  // the image (the conv's padding is of the normalised input)
  auto normalise = [&](int s, int ch) {
    float* xs = smem + s * kW3Stage + kW3N * kW3ERow;
    int b, oy0, ox0;
    corner(ch, &b, &oy0, &ox0);
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int e = tid + i * kThreads;
      if (e >= kW3K * kHaloN) break;
      const int kl = e / kHaloN, hp = e - kl * kHaloN, k = k0 + kl;
      const int iy = oy0 - 1 + hp / kHaloW, ix = ox0 - 1 + hp % kHaloW;
      float* v = xs + kl * kW3XRow + hp;
      *v = k < K && iy >= 0 && iy < H && ix >= 0 && ix < W
               ? prologue(*v, __ldg(scale + k), __ldg(shift + k), relu)
               : 0.f;
    }
  };

  float acc[9][2][4] = {};
#pragma unroll
  for (int s = 0; s < kW3Stages - 1; ++s) {
    if (s < nch) load(s, c0 + s);
    cp_async_commit();
  }
  for (int it = 0; it < nch; ++it) {
    cp_async_wait<kW3Stages - 2>();
    if (PRO) normalise(it % kW3Stages, c0 + it);
    __syncthreads();
    const int nk = it + kW3Stages - 1;
    if (nk < nch) load(nk % kW3Stages, c0 + nk);
    cp_async_commit();
    const float* es = smem + (it % kW3Stages) * kW3Stage;
    const float* xs = es + kW3N * kW3ERow + (wn * 8 + g) * kW3XRow + 2 * t;
    // a step: pixel columns 2t, 2t + 1 of row r are its k = t, t + 4
    auto step = [&](int r) {
      uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* ar = es + (wm * 32 + mi * 16 + g) * kW3ERow + r * kTileHW + 2 * t;
        split2(ar, a_hi[mi][0], a_lo[mi][0], a_hi[mi][2], a_lo[mi][2]);
        split2(ar + 8 * kW3ERow, a_hi[mi][1], a_lo[mi][1], a_hi[mi][3], a_lo[mi][3]);
      }
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* br = xs + (r + dy) * kHaloW + dx;
          uint32_t b_hi[2], b_lo[2];
          if (dx % 2 == 0) {
            split2(br, b_hi[0], b_lo[0], b_hi[1], b_lo[1]);
          } else {
            split(br[0], b_hi[0], b_lo[0]);
            split(br[1], b_hi[1], b_lo[1]);
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            mma3(acc[dy * 3 + dx][mi], a_hi[mi], a_lo[mi], b_hi, b_lo);
        }
      }
    };
#pragma unroll 1
    for (int r = 0; r < TH; ++r) step(r);
  }
  cp_async_wait<0>();
  float* out = dw_part + static_cast<size_t>(blockIdx.z) * N * K * 9;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + wm * 32 + mi * 16 + g + 8 * h;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = k0 + wn * 8 + 2 * t + j;
        if (n >= N || k >= K) continue;
        float* o = out + (static_cast<size_t>(n) * K + k) * 9;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) o[tap] = acc[tap][mi][2 * h + j];
      }
    }
}

// The second pass: dw (splits rows) and (dscale, dshift) (parts rows).
__global__ void conv_bn_bwd_partials_sum(const float* __restrict__ part,
                                         float* __restrict__ out, int P, int C) {
  mxt::sum_rows(part, out, P, C);
}

template <int TAPS, bool VEC, bool PRO>
cudaError_t dgrad(cudaStream_t st, const Geo& g, int np, const float* x, const float* wt,
                  const float* scale, const float* shift, const float* dce, float* dx,
                  float* part, bool relu) {
  auto kernel = conv_bn_bwd_dgrad_kernel<TAPS, VEC, PRO>;
  static bool raised = false;
  cudaError_t err = mxt::raise_smem(kernel, Cfg<TAPS>::SMEM, &raised);
  if (err != cudaSuccess) return err;
  const dim3 grid(tc_parts(g, TAPS) * ceil_div(g.K, kTileM));
  kernel<<<grid, kThreads, Cfg<TAPS>::SMEM, st>>>(x, wt, scale, shift, dce, dx, part, g, np,
                                                  relu);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t wgrad(Kernel kernel, bool* raised, int smem, dim3 grid, cudaStream_t st,
                  const Geo& g, int splits, const float* x, const float* scale,
                  const float* shift, const float* dce, float* dw_part, bool relu) {
  cudaError_t err = mxt::raise_smem(kernel, smem, raised);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(x, scale, shift, dce, dw_part, g, relu, splits);
  return cudaGetLastError();
}

template <bool EVEC, bool XVEC, bool PRO>
cudaError_t wgrad1(cudaStream_t st, const Geo& g, int splits, const float* x, const float* scale,
                   const float* shift, const float* dce, float* dw_part, bool relu) {
  static bool raised = false;
  const dim3 grid(ceil_div(g.N, kW1N), ceil_div(g.K, kW1K), splits);
  return wgrad(conv_bn_bwd_wgrad1_kernel<EVEC, XVEC, PRO>, &raised, kW1Smem, grid, st, g,
               splits, x, scale, shift, dce, dw_part, relu);
}

template <int TH, bool VEC, bool PRO>
cudaError_t wgrad3(cudaStream_t st, const Geo& g, int splits, const float* x, const float* scale,
                   const float* shift, const float* dce, float* dw_part, bool relu) {
  static bool raised = false;
  const dim3 grid(ceil_div(g.N, kW3N), ceil_div(g.K, kW3K), splits);
  return wgrad(conv_bn_bwd_wgrad3_kernel<TH, VEC, PRO>, &raised, kW3Smem, grid, st, g, splits,
               x, scale, shift, dce, dw_part, relu);
}

template <int TAPS, bool PRO>
cudaError_t products(cudaStream_t st, const Geo& g, int np, int splits, const float* x,
                     const float* wt, const float* scale, const float* shift, const float* dce,
                     float* dx, float* dw_part, float* dss_part, bool relu) {
  const int HWo = g.Ho * g.Wo;
  // 16-byte copies of dce where the output grid allows them (the dgrad),
  // and of x too (the 1x1 wgrad)
  cudaError_t err;
  if constexpr (TAPS == 1) {
    err = HWo % 4 == 0
              ? dgrad<1, true, PRO>(st, g, np, x, wt, scale, shift, dce, dx, dss_part, relu)
              : dgrad<1, false, PRO>(st, g, np, x, wt, scale, shift, dce, dx, dss_part, relu);
  } else {
    err = dgrad<9, false, PRO>(st, g, np, x, wt, scale, shift, dce, dx, dss_part, relu);
  }
  if (err != cudaSuccess) return err;
  if constexpr (TAPS == 1) {
    if (HWo % 4 != 0)
      return wgrad1<false, false, PRO>(st, g, splits, x, scale, shift, dce, dw_part, relu);
    return g.stride == 1
               ? wgrad1<true, true, PRO>(st, g, splits, x, scale, shift, dce, dw_part, relu)
               : wgrad1<true, false, PRO>(st, g, splits, x, scale, shift, dce, dw_part, relu);
  } else {
    const bool vec = g.Wo % 4 == 0;
    if (wgrad3_tile_h(g.Ho) == 7)
      return vec ? wgrad3<7, true, PRO>(st, g, splits, x, scale, shift, dce, dw_part, relu)
                 : wgrad3<7, false, PRO>(st, g, splits, x, scale, shift, dce, dw_part, relu);
    return vec ? wgrad3<8, true, PRO>(st, g, splits, x, scale, shift, dce, dw_part, relu)
               : wgrad3<8, false, PRO>(st, g, splits, x, scale, shift, dce, dw_part, relu);
  }
}

}  // namespace

// dce: (B, N, H', W'), the folded cotangent the kernels write and read (the
// residual's gradient dres where the forward added one); wt: K · N' · taps
// floats of scratch, N' = N rounded up to 8; parts: the dscale/dshift
// partial rows the caller allocated (ops/conv_bn.py _fwd_parts: the dgrad
// runs the forward's tiling); splits: the wgrad blocks along the reduction
// (1 ..= 65535, ops/conv_bn.py _wgrad_splits), dw_part holding splits rows of
// N·K·taps. dss (2, K) and dss_part are NULL without a prologue (scale ==
// NULL). x, w, c, dc, dce, dx and wt must be 16-byte aligned; a view at
// another offset is refused with cudaErrorMisalignedAddress, as in the
// forward.
extern "C" int mxt_conv_bn_bwd(const float* x, const float* w, const float* scale,
                               const float* shift, const float* c, const float* dc,
                               const float* ds, const float* dq, float* dx, float* dw,
                               float* dw_part, float* dss, float* dss_part, float* dce, float* wt,
                               int B, int K, int H, int W, int N, int taps, int stride, int relu,
                               int parts, int splits, void* stream) {
  const bool pro = scale != nullptr;
  if (!valid_call(B, K, H, W, N, taps, stride) || (shift != nullptr) != pro ||
      (dss != nullptr) != pro || (dss_part != nullptr) != pro || splits < 1 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned(x, 16) || misaligned(w, 16) || misaligned(c, 16) || misaligned(dc, 16) ||
      misaligned(dce, 16) || misaligned(dx, 16) || misaligned(wt, 16))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Geo g = make_geo(B, K, H, W, N, taps, stride);
  if (parts != tc_parts(g, taps)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int HWo = g.Ho * g.Wo, np = ceil_div(N, 8) * 8;
  const size_t total = static_cast<size_t>(B) * N * HWo;
  const size_t fold_items = HWo % 4 == 0 ? total / 4 : total;
  const int fold_blocks = static_cast<int>(
      fold_items < 132 * 16 * kThreads ? (fold_items + kThreads - 1) / kThreads : 132 * 16);
  if (HWo % 4 == 0)
    conv_bn_bwd_fold_kernel<true><<<fold_blocks, kThreads, 0, st>>>(dc, c, ds, dq, dce, N, HWo,
                                                                     total);
  else
    conv_bn_bwd_fold_kernel<false><<<fold_blocks, kThreads, 0, st>>>(dc, c, ds, dq, dce, N, HWo,
                                                                      total);
  const dim3 fgrid(ceil_div(np, kFlipTile), ceil_div(K, kFlipTile));
  if (taps == 1) conv_bn_bwd_wflip_kernel<1><<<fgrid, kThreads, 0, st>>>(w, wt, N, K, np);
  else conv_bn_bwd_wflip_kernel<9><<<fgrid, kThreads, 0, st>>>(w, wt, N, K, np);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (taps == 1) {
    err = pro ? products<1, true>(st, g, np, splits, x, wt, scale, shift, dce, dx, dw_part,
                                  dss_part, relu)
              : products<1, false>(st, g, np, splits, x, wt, scale, shift, dce, dx, dw_part,
                                   dss_part, relu);
  } else {
    err = pro ? products<9, true>(st, g, np, splits, x, wt, scale, shift, dce, dx, dw_part,
                                  dss_part, relu)
              : products<9, false>(st, g, np, splits, x, wt, scale, shift, dce, dx, dw_part,
                                   dss_part, relu);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid, block;
  const int C = N * K * taps;
  mxt::sum_rows_shape(splits, C, &grid, &block);
  conv_bn_bwd_partials_sum<<<grid, block, 0, st>>>(dw_part, dw, splits, C);
  if (pro) {
    mxt::sum_rows_shape(parts, 2 * K, &grid, &block);
    conv_bn_bwd_partials_sum<<<grid, block, 0, st>>>(dss_part, dss, parts, 2 * K);
  }
  return static_cast<int>(cudaGetLastError());
}
