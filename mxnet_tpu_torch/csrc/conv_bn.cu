// Fused conv + BatchNorm forward: c = conv(relu(x·scale + shift), w) [+ res],
// with the per-channel f32 Σc and Σc² of the result.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_conv_bn.py _kernel (:240),
// launched by _conv_block_fwd_impl (:301, pallas_call :373). x is NCHW
// (B, K, H, W), w OIHW (N, K, 1|3, 1|3): a 1x1 kernel of stride 1 or 2, or a
// 3x3 kernel of stride 1 and pad 1. scale, shift (K,) and res (B, N, H', W')
// are optional (NULL).
//
// Bound on an H100: at ResNet-50's 3x3 sites operations, 3 · 2·B·H'W'·N·K·9
// FLOP on the TF32 tensor cores (3xTF32, f32-accurate: tf32x3.cuh), 0.0448
// ms at stage 1; at its 1x1 sites with 64 input channels bytes, one read of
// x, w, res and one write of c (0.0690 ms for stage 1's 1x1 with the
// residual), from 256 input channels operations (0.0399 ms at the stride-2
// shortcut, which reads only the sampled quarter of x). The design
// is an implicit GEMM on the tensor cores: GEMM-M is the output channels (A
// = w, whose OIHW rows are contiguous along K·taps), GEMM-N the output
// positions, the contraction the input channels times the taps. A block of
// 8 warps (2 along channels x 4 along positions) owns 64 channels by 128
// positions (1x1) or an 8 x 8 pixel tile (3x3), two blocks an SM, the
// channel blocks of a position tile one after another, and streams the
// contraction through a 4-stage cp.async ring in dynamic shared memory, in
// chunks of 32 input channels (1x1) or 8 channels x 9 taps (3x3): the 1x1
// stages hold only 4 steps of products, so the ring runs deeper than
// matmul_bias_act's 3 stages.
// What the TPU kernel keeps out of device memory stays out:
// - x is staged raw. The prologue relu(x·scale + shift) is applied before
//   the hi/lo split, with the product and the sum each rounded (__fmul_rn,
//   __fadd_rn) as the plain version rounds them, so the card and the CPU put
//   each value on the same side of the ReLU; the normalised activation is
//   never written (pallas_conv_bn.py:18-21). 1x1: as a warp loads its B
//   fragments (two warps read each element). 3x3: once an element, in
//   shared memory, by the thread that copied it, as its chunk lands (nine
//   taps and two warps read each element); a border pixel outside the image
//   becomes a 0 of the normalised input there.
// - 1x1: the positions run along the flattened B·H'W' axis, so the 14 x 14
//   and 7 x 7 grids of stages 3 and 4 fill whole tiles; a tile may span two
//   or more images, and each of its columns keeps its own (b, p) address,
//   computed once a block. With stride 1 and H·W % 4 == 0 x is copied in
//   16-byte segments; otherwise (a 7 x 7 or 9 x 9 channel row is 196 or 324
//   bytes, so 16-byte copies along positions would be misaligned; stride 2
//   samples every second column) in 4-byte copies. Stride 2 reads only the
//   even rows. Staging whole 16-byte segments of them would not make it
//   faster: on an H100 the stride-2 shortcut of ResNet-50 takes the same
//   time as the stride-1 kernel, with its 16-byte copies, on the sampled
//   input made contiguous (chip_smoke.py's "presampled_ms"), so the copies
//   of x are not what holds it.
// - 3x3: the bordered 10 x 10 pixel tile is staged once a chunk of 8
//   channels, and the 9 taps are shifted reads of it (pallas_conv_bn.py
//   :216's pad-1 semantics).
// - The epilogue adds the residual before the statistics
//   (pallas_conv_bn.py:285-290) and each block writes its per-channel Σc,
//   Σc² from the f32 accumulators into one row of a (parts, 2, N) buffer
//   (parts = the position tiles, one per block column of the grid); GPU
//   blocks run in no order, so a second pass adds the rows in a fixed order,
//   with no atomics, and two runs give the same bits.
// The inference variant (part == NULL) drops the statistics entirely.
#include "conv_bn.cuh"
#include "tf32x3.cuh"

namespace {

using namespace mxt::convbn;
using namespace mxt::tf32x3;

constexpr int kFwdThreads = 256;   // 8 warps
constexpr int kFwdTileC = 64;      // output channels a block
constexpr int kFwdStages = 4;
constexpr int kFwdTileP = 128;     // 1x1: flattened positions a block
constexpr int kFwdTileHW = 8;      // 3x3: an 8 x 8 pixel tile ...
constexpr int kFwdHaloW = 10;      // ... staged with its border
constexpr int kFwdHalo = kFwdHaloW * kFwdHaloW;

template <int TAPS>
struct Cfg {
  static constexpr int BM = kFwdTileC;
  static constexpr int BN = TAPS == 1 ? kFwdTileP : kFwdTileHW * kFwdTileHW;
  static constexpr int BK = TAPS == 1 ? 32 : 8;   // contraction channels a stage
  static constexpr int KW = BK * TAPS;                   // A columns a stage
  static constexpr int AS = TAPS == 1 ? KW + 8 : KW + 4;  // A row: 40 or 76 floats
  static constexpr int BS = TAPS == 1 ? BN + 4 : 104;     // B row: 132 or 104 floats
  static constexpr int STAGE = BM * AS + BK * BS;
  static constexpr int SMEM = kFwdStages * STAGE * 4;     // 108 544 or 91 136 bytes
  static constexpr int WARPS_M = 2, WARPS_N = 4;          // a warp: 32 channels x 32 or 16
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

// The number of forward position tiles, one partial-statistics row each
// (ops/conv_bn.py _fwd_parts).
inline int fwd_parts(const Geo& g, int taps) {
  if (taps == 1) return ceil_div(g.B * g.Ho * g.Wo, kFwdTileP);
  return g.B * ceil_div(g.Ho, kFwdTileHW) * ceil_div(g.Wo, kFwdTileHW);
}

__device__ __forceinline__ float prologue(float v, float sc, float sh, bool relu) {
  v = __fadd_rn(__fmul_rn(v, sc), sh);
  return relu ? fmaxf(v, 0.f) : v;
}

// Two blocks an SM (at most 128 registers a thread): at the 1x1 sites with
// few input channels the kernel is bound by bytes, and one block an SM
// leaves too few loads and stores in flight.
template <int TAPS, bool VEC, bool PRO, bool STATS>
__global__ void __launch_bounds__(kFwdThreads, 2)
conv_bn_fwd_tc_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ scale, const float* __restrict__ shift,
                      const float* __restrict__ res, float* __restrict__ c,
                      float* __restrict__ part, Geo geo, bool relu) {
  using C = Cfg<TAPS>;
  constexpr int BM = C::BM;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % C::WARPS_M, wn = warp / C::WARPS_M;
  // the channel blocks of one position tile run one after another, so the
  // tile's x is read from device memory once and from L2 by the others
  const int cblocks = ceil_div(geo.N, BM);
  const int pt = blockIdx.x / cblocks, n0 = (blockIdx.x - pt * cblocks) * BM;
  const int K = geo.K, N = geo.N, HWo = geo.Ho * geo.Wo;
  const size_t HW = static_cast<size_t>(geo.H) * geo.W;

  // ---- where this thread's staged x comes from, computed once a block
  // 1x1: one position (VEC: 4) and the channels kl0 + i · kStepK of a chunk
  constexpr int kPerRow = VEC ? C::BN / 4 : C::BN;   // copies along a B row
  constexpr int kStepK = kFwdThreads / kPerRow;      // B rows apart
  constexpr int k1x1 = TAPS == 1 ? C::BK / kStepK : 1;
  // 3x3: elements e = tid + i · 256 of the BK x 10 x 10 halo chunk
  constexpr int k3x3 = TAPS == 1 ? 1 : (C::BK * kFwdHalo + kFwdThreads - 1) / kFwdThreads;
  size_t off = 0;         // 1x1: x offset of the position at channel 0
  int pos = 0, kl0 = 0;   // 1x1: B column and first row
  bool valid = false;     // 1x1: the position exists
  size_t src[k3x3];       // 3x3: x offset at the chunk's channel 0
  int dst[k3x3];          // 3x3: shared offset in the B block; -1 past the chunk
  int kls[k3x3];          // 3x3: its channel in the chunk
  bool ok[k3x3];          // 3x3: inside the image (else zero-filled)
  int b3 = 0, oy0 = 0, ox0 = 0;       // 3x3: the tile's image and corner
  unsigned rows_in = 0, cols_in = 0;  // 3x3: halo rows, columns inside the image
  if (TAPS == 1) {
    pos = (tid % kPerRow) * (VEC ? 4 : 1);
    kl0 = tid / kPerRow;
    const int q = pt * C::BN + pos;
    valid = q < geo.B * HWo;  // VEC: H'W' % 4 == 0, so the 4 are all in or all out
    const int b = valid ? q / HWo : 0, p = q - b * HWo;
    const int oy = p / geo.Wo, ox = p - oy * geo.Wo;
    off = static_cast<size_t>(b) * K * HW + static_cast<size_t>(oy * geo.stride) * geo.W +
          ox * geo.stride;
  } else {
    const int tiles_x = ceil_div(geo.Wo, kFwdTileHW);
    const int per_img = ceil_div(geo.Ho, kFwdTileHW) * tiles_x;
    b3 = pt / per_img;
    const int tile = pt - b3 * per_img;
    oy0 = (tile / tiles_x) * kFwdTileHW;
    ox0 = (tile % tiles_x) * kFwdTileHW;
#pragma unroll
    for (int h = 0; h < kFwdHaloW; ++h) {
      if (oy0 - 1 + h >= 0 && oy0 - 1 + h < geo.H) rows_in |= 1u << h;
      if (ox0 - 1 + h >= 0 && ox0 - 1 + h < geo.W) cols_in |= 1u << h;
    }
#pragma unroll
    for (int i = 0; i < k3x3; ++i) {
      const int e = tid + i * kFwdThreads;
      const int kl = e / kFwdHalo, hp = e - kl * kFwdHalo;
      const int hy = hp / kFwdHaloW, hx = hp - hy * kFwdHaloW;
      ok[i] = ((rows_in >> hy) & (cols_in >> hx) & 1u) != 0;
      src[i] = (static_cast<size_t>(b3) * K + kl) * HW +
               (ok[i] ? static_cast<size_t>(oy0 - 1 + hy) * geo.W + (ox0 - 1 + hx) : 0);
      dst[i] = e < C::BK * kFwdHalo ? kl * C::BS + hp : -1;
      kls[i] = kl;
    }
  }

  // ---- one contraction chunk (channels k0 .. k0 + BK - 1) into stage s
  auto load = [&](int s, int k0) {
    float* as = smem + s * C::STAGE;
    float* bs = as + BM * C::AS;
    constexpr int kRowChunks = C::KW / 4;
    for (int ch = tid; ch < BM * kRowChunks; ch += kFwdThreads) {
      const int r = ch / kRowChunks, col = (ch - r * kRowChunks) * 4;
      const bool p = n0 + r < N && (TAPS != 1 || k0 + col < K);
      cp_async16(as + r * C::AS + col,
                 p ? w + (static_cast<size_t>(n0 + r) * K + k0) * TAPS + col : w, p);
    }
    if (TAPS == 1) {
#pragma unroll
      for (int i = 0; i < k1x1; ++i) {
        const int kl = kl0 + i * kStepK;
        const bool p = valid && k0 + kl < K;
        const float* from = p ? x + off + static_cast<size_t>(k0 + kl) * HW : x;
        if (VEC) cp_async16(bs + kl * C::BS + pos, from, p);
        else cp_async4(bs + kl * C::BS + pos, from, p);
      }
    } else {
      const size_t koff = static_cast<size_t>(k0) * HW;
#pragma unroll
      for (int i = 0; i < k3x3; ++i)
        if (dst[i] >= 0) cp_async4(bs + dst[i], ok[i] ? x + src[i] + koff : x, ok[i]);
    }
  };

  float acc[C::MT][C::NT][4] = {};
  const int KT = ceil_div(K, C::BK);
#pragma unroll
  for (int s = 0; s < kFwdStages - 1; ++s) {
    if (s < KT) load(s, s * C::BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    const int k0 = kt * C::BK;
    cp_async_wait<kFwdStages - 2>();  // this thread's copies of chunk kt landed
    if (TAPS != 1 && PRO) {
      // 3x3: the prologue once an element, on the elements this thread
      // copied (its 9 taps x 2 warps read each many times); 0 outside the image
      float* bs = smem + (kt % kFwdStages) * C::STAGE + BM * C::AS;
#pragma unroll
      for (int i = 0; i < k3x3; ++i) {
        if (dst[i] < 0) continue;
        const int k = k0 + kls[i];
        bs[dst[i]] = ok[i] ? prologue(bs[dst[i]], __ldg(scale + k), __ldg(shift + k), relu) : 0.f;
      }
    }
    __syncthreads();  // chunk kt ready for all; every warp is done with chunk kt - 1's stage
    const int nk = kt + kFwdStages - 1;
    if (nk < KT) load(nk % kFwdStages, nk * C::BK);
    cp_async_commit();
    const float* as = smem + (kt % kFwdStages) * C::STAGE + (wm * C::WM + g) * C::AS;
    const float* bs = smem + (kt % kFwdStages) * C::STAGE + BM * C::AS;
    if (TAPS == 1) {
#pragma unroll
      for (int kk = 0; kk < C::BK; kk += 8) {
        if (k0 + kk >= K) break;  // K % 8 == 0: an 8-deep step is all in or all out
        // k = t and t + 4 of the step are channels kk + 2t and kk + 2t + 1
        // (tf32x3.cuh): A's from one 8-byte load, B's from two rows
        float2 sc = make_float2(1.f, 1.f), sh = make_float2(0.f, 0.f);
        if (PRO) {
          sc = __ldg(reinterpret_cast<const float2*>(scale + k0 + kk + 2 * t));
          sh = __ldg(reinterpret_cast<const float2*>(shift + k0 + kk + 2 * t));
        }
        uint32_t b_hi[C::NT][2], b_lo[C::NT][2];
#pragma unroll
        for (int ni = 0; ni < C::NT; ++ni) {
          const float* br = bs + (kk + 2 * t) * C::BS + wn * C::WN + ni * 8 + g;
          float v0 = br[0], v1 = br[C::BS];
          if (PRO) v0 = prologue(v0, sc.x, sh.x, relu), v1 = prologue(v1, sc.y, sh.y, relu);
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
          const float* br = bs + t * C::BS + (wn * C::NT + ni + dy) * kFwdHaloW + g + dx;
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

  // ---- epilogue: the thread's columns 2t, 2t + 1 of each n8 tile, each
  // with its own output offset at channel 0 (a 1x1 tile may start the next
  // image between the two)
  size_t ob[C::NT][2];
  bool in[C::NT][2];
#pragma unroll
  for (int ni = 0; ni < C::NT; ++ni) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = wn * C::WN + ni * 8 + 2 * t + j;
      if (TAPS == 1) {
        const int q = pt * C::BN + col;
        in[ni][j] = q < geo.B * HWo;
        const int b = in[ni][j] ? q / HWo : 0;
        ob[ni][j] = static_cast<size_t>(b) * N * HWo + (q - b * HWo);
      } else {
        const int oy = oy0 + col / kFwdTileHW, ox = ox0 + col % kFwdTileHW;
        in[ni][j] = oy < geo.Ho && ox < geo.Wo;
        ob[ni][j] = static_cast<size_t>(b3) * N * HWo + static_cast<size_t>(oy) * geo.Wo + ox;
      }
    }
  }
  // with an even H'W' (1x1) or W' (3x3) a pair inside the grid is adjacent
  // and 8-byte aligned
  const bool pairs = TAPS == 1 ? HWo % 2 == 0 : geo.Wo % 2 == 0;
  float s[C::MT][2], q2[C::MT][2];
#pragma unroll
  for (int mi = 0; mi < C::MT; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[mi][h] = 0.f, q2[mi][h] = 0.f;
      const int n = n0 + wm * C::WM + mi * 16 + g + 8 * h;
      if (n >= N) continue;
      const size_t nof = static_cast<size_t>(n) * HWo;
#pragma unroll
      for (int ni = 0; ni < C::NT; ++ni) {
        float v[2] = {acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]};
        if (pairs && in[ni][1]) {
          const size_t o = ob[ni][0] + nof;
          if (res != nullptr) {
            const float2 r = __ldg(reinterpret_cast<const float2*>(res + o));
            v[0] += r.x, v[1] += r.y;
          }
          *reinterpret_cast<float2*>(c + o) = make_float2(v[0], v[1]);
        } else {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (!in[ni][j]) continue;
            const size_t o = ob[ni][j] + nof;
            if (res != nullptr) v[j] += __ldg(res + o);
            c[o] = v[j];
          }
        }
        if (STATS) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (in[ni][j]) s[mi][h] += v[j], q2[mi][h] = fmaf(v[j], v[j], q2[mi][h]);
        }
      }
    }
  }
  if (STATS) {
    // lanes t = 0..3 of a row share its channels; then the 4 warps along
    // positions, in order, through shared memory
#pragma unroll
    for (int mi = 0; mi < C::MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          s[mi][h] += __shfl_xor_sync(mxt::kFullMask, s[mi][h], o);
          q2[mi][h] += __shfl_xor_sync(mxt::kFullMask, q2[mi][h], o);
        }
    __syncthreads();  // the ring's stages are free
    constexpr int WN_ = C::WARPS_N;
    float* red = smem;  // red[(stat · WARPS_N + wn) · BM + channel]
    if (t == 0) {
#pragma unroll
      for (int mi = 0; mi < C::MT; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int lc = wm * C::WM + mi * 16 + g + 8 * h;
          red[wn * BM + lc] = s[mi][h];
          red[(WN_ + wn) * BM + lc] = q2[mi][h];
        }
    }
    __syncthreads();
    if (tid < BM && n0 + tid < N) {
      float sum = 0.f, sq = 0.f;
#pragma unroll
      for (int j = 0; j < WN_; ++j) sum += red[j * BM + tid], sq += red[(WN_ + j) * BM + tid];
      part[(static_cast<size_t>(pt) * 2) * N + n0 + tid] = sum;
      part[(static_cast<size_t>(pt) * 2 + 1) * N + n0 + tid] = sq;
    }
  }
}

// The statistics' second pass: (ssum, ssq) = Σ over the partial rows.
__global__ void conv_bn_fwd_stats_sum(const float* __restrict__ part, float* __restrict__ out,
                                      int P, int C) {
  sum_rows(part, out, P, C);
}

template <int TAPS, bool VEC, bool PRO, bool STATS>
cudaError_t launch(dim3 grid, cudaStream_t st, const float* x, const float* w,
                   const float* scale, const float* shift, const float* res, float* c,
                   float* part, const Geo& g, bool relu) {
  auto kernel = conv_bn_fwd_tc_kernel<TAPS, VEC, PRO, STATS>;
  constexpr int smem = Cfg<TAPS>::SMEM;
  static bool raised = false;  // the shared-memory limit, once a process
  if (!raised) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  kernel<<<grid, kFwdThreads, smem, st>>>(x, w, scale, shift, res, c, part, g, relu);
  return cudaGetLastError();
}

template <int TAPS, bool VEC>
cudaError_t launch_pro_stats(bool pro, bool stats, dim3 grid, cudaStream_t st, const float* x,
                             const float* w, const float* scale, const float* shift,
                             const float* res, float* c, float* part, const Geo& g,
                             bool relu) {
  if (pro) {
    return stats ? launch<TAPS, VEC, true, true>(grid, st, x, w, scale, shift, res, c,
                                                     part, g, relu)
                 : launch<TAPS, VEC, true, false>(grid, st, x, w, scale, shift, res, c,
                                                      part, g, relu);
  }
  return stats ? launch<TAPS, VEC, false, true>(grid, st, x, w, scale, shift, res, c, part,
                                                    g, relu)
               : launch<TAPS, VEC, false, false>(grid, st, x, w, scale, shift, res, c,
                                                     part, g, relu);
}

}  // namespace

// parts: the partial rows the caller allocated (ops/conv_bn.py _fwd_parts),
// checked here. x, w, c, res must be 16-byte and scale, shift 8-byte aligned,
// as every tensor PyTorch's allocator makes is; a view at another offset is
// refused with cudaErrorMisalignedAddress, which the caller raises.
extern "C" int mxt_conv_bn_fwd(const float* x, const float* w, const float* scale,
                               const float* shift, const float* res, float* c, float* part,
                               float* sums, int B, int K, int H, int W, int N, int taps,
                               int stride, int relu, int parts, void* stream) {
  if (!valid_call(B, K, H, W, N, taps, stride) || (scale == nullptr) != (shift == nullptr) ||
      (part == nullptr) != (sums == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto misaligned = [](const void* p, int a) { return reinterpret_cast<uintptr_t>(p) % a; };
  if (misaligned(x, 16) || misaligned(w, 16) || misaligned(c, 16) ||
      (res != nullptr && misaligned(res, 16)) ||
      (scale != nullptr && (misaligned(scale, 8) || misaligned(shift, 8))))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Geo g = make_geo(B, K, H, W, N, taps, stride);
  const bool stats = part != nullptr, pro = scale != nullptr;
  const int ptiles = fwd_parts(g, taps);
  if (stats && parts != ptiles) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(ptiles * ceil_div(N, kFwdTileC));
  cudaError_t err;
  if (taps == 1) {
    const bool vec = stride == 1 && (H * W) % 4 == 0;
    err = vec ? launch_pro_stats<1, true>(pro, stats, grid, st, x, w, scale, shift, res, c, part,
                                          g, relu)
              : launch_pro_stats<1, false>(pro, stats, grid, st, x, w, scale, shift, res, c,
                                           part, g, relu);
  } else {
    err = launch_pro_stats<9, false>(pro, stats, grid, st, x, w, scale, shift, res, c, part, g,
                                     relu);
  }
  if (err != cudaSuccess || !stats) return static_cast<int>(err);
  dim3 sgrid, sblock;
  sum_rows_shape(parts, 2 * N, &sgrid, &sblock);
  conv_bn_fwd_stats_sum<<<sgrid, sblock, 0, st>>>(part, sums, parts, 2 * N);
  return static_cast<int>(cudaGetLastError());
}
