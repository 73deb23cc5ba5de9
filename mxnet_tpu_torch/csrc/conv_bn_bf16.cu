// The bf16 forms of the fused conv + BatchNorm forward: c = conv(relu(x·scale
// + shift), w) [+ res] on bf16 operands, on Hopper's warpgroup products.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_conv_bn.py _kernel (:240),
// launched by _conv_block_fwd_impl (:301, pallas_call :373), in the forms
// the JAX package runs it on bf16 operands (the TPU kernel computes in its
// input's dtype, :321 and :349-350):
// - mxt_conv_bn_infer_bf16, the stats-free serving form (conv_block_infer
//   :460 as fusion.py:1313-1336 calls it under MXNET_SERVE_QUANT=bf16): it
//   reads f32 x and w, rounds them to bf16 as it stages them (JAX's two
//   casts, fused here: no cast pass), and writes c as the f32 of its bf16
//   value;
// - mxt_conv_bn_fwd_bf16, the training form with the statistics
//   (SPMDTrainer(compute_dtype='bfloat16')), on bf16 storage: x, w, scale,
//   shift, res and c 2 bytes an element, Σc and Σc² f32;
// - mxt_conv_bn_fwd_stash_bf16, the training form that also writes xn =
//   relu(x·scale + shift) on the output grid (the TPU kernel's emit_xn,
//   :270-275, :370-389; MXNET_FUSED_CONV_BN_BWD=stash), from the staged
//   values the products take, so the stash backward sees what a recompute
//   derives and the two policies give the same bits.
// The rounding points are the TPU kernel's: the prologue in bf16 with two
// roundings (bf16_mma.cuh), exact bf16 products summed in f32, the residual
// added to the f32 c, Σc and Σc² from that f32 c, then c rounded to bf16
// (:284-291).
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s, 2 bytes an element): by
// operations at ResNet-50's 3x3 sites past stage 1 (2·B·H'W'·N·K·9 FLOP),
// by bytes and operations about equally at stage 1's 3x3, by bytes at its
// 1x1 sites (one read of x, w, res and one write of c; PERF.md §6). The
// design is conv_bn_bf16.cuh's: the implicit GEMM with GEMM-M the output
// channels (A = w, rows contiguous along K·taps), GEMM-N the positions, the
// contraction the input channels times the taps, bf16 staged as bf16 in a
// 3-stage ring (w by cp.async, x register-staged as K-major core matrices
// with the prologue applied once an element), the products on wgmma with a
// fresh accumulator a stage. The channel blocks of one position tile run
// one after another, so the tile's x is read from device memory once and
// from L2 by the others. The epilogue adds the residual, writes c, and each
// block writes its per-channel Σc, Σc² into one row of a (parts, 2, N)
// buffer; a second pass adds the rows in a fixed order, with no atomics, so
// two runs give the same bits.
#include "conv_bn_bf16.cuh"

namespace {

using namespace mxt;  // the storage loads and stores, bf16::
using namespace mxt::convbn16;
using convbn::make_geo;
using convbn::misaligned;
using convbn::valid_call;

// The kernels' body. T: the storage (float: the serving form, c the f32 of
// its bf16 value; bf16: the training forms, c rounded to bf16 after the
// statistics took the f32 c). EMIT: the stash form.
template <int TAPS, int TH, int WM, typename T, bool PRO, bool STATS, bool EMIT, bool XVEC>
__device__ __forceinline__ void fwd_body(const T* __restrict__ x, const T* __restrict__ w,
                                         const T* __restrict__ scale,
                                         const T* __restrict__ shift, const T* __restrict__ res,
                                         T* __restrict__ c, float* __restrict__ part,
                                         const Geo& geo, bool relu, T* __restrict__ xn) {
  using F = Fwd<TAPS, TH, WM, T>;
  extern __shared__ __align__(128) char smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int cblocks = ceil_div(geo.N, F::BM);
  const int pt = blockIdx.x / cblocks, n0 = (blockIdx.x - pt * cblocks) * F::BM;
  const int N = geo.N, HWo = geo.Ho * geo.Wo;
  const Args<T> args{w, x, scale, shift, N, geo.K, geo.K, geo.B,
                     geo.H, geo.W, geo.Ho, geo.Wo, geo.stride, relu, xn};
  // the residual's tile, copied into shared memory past the ring while the
  // products run (the copies join the main loop's first group), where its
  // position pairs are aligned (copy_tile)
  const bool rvec = IsBf16<T>::value && res != nullptr && tile_pairs<TAPS>(geo, 2);
  const char* rs = smem + F::SMEM;
  if constexpr (IsBf16<T>::value) {
    // (res need only be 8-byte aligned: 16-byte copies where it is 16)
    const bool wide = tile_pairs<TAPS>(geo, 8) && reinterpret_cast<uintptr_t>(res) % 16 == 0;
    if (rvec) copy_tile<F, TAPS, TH>(geo, pt, res, N, n0, smem + F::SMEM, wide);
  }
  float acc[F::R] = {};
  mainloop<TAPS, TH, WM, T, PRO, EMIT, XVEC>(args, pt, n0, smem, acc);

  // ---- epilogue, through the ring (stage_tile): a warp a row n at a time,
  // lane l the columns 2l, 2l + 1 (+ 64), so a warp's stores of c (and its
  // loads of res) run along consecutive positions. Where the two are
  // adjacent and aligned they move as one pair. STATS: the f32 c (0 past
  // the grid) goes back into the tile, whose rows are then summed one a
  // thread.
  float* tile = stage_tile<F>(acc, smem);
  constexpr int CI = (F::BN + 63) / 64;
  size_t ob[CI][2];
  bool in[CI][2], pair[CI];
#pragma unroll
  for (int i = 0; i < CI; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 64 * i + 2 * lane + e;
      int b = 0, oy = 0, ox = 0;
      in[i][e] = col < F::BN && tile_col<TAPS, TH>(geo, pt, col, &b, &oy, &ox);
      ob[i][e] = static_cast<size_t>(b) * N * HWo + static_cast<size_t>(oy) * geo.Wo + ox;
    }
    pair[i] = in[i][0] && in[i][1] && ob[i][1] == ob[i][0] + 1 && ob[i][0] % 2 == 0 &&
              HWo % 2 == 0;
  }
  for (int r = tid >> 5; r < F::BM && n0 + r < N; r += kThreads / 32) {
    const size_t nof = static_cast<size_t>(n0 + r) * HWo;
#pragma unroll
    for (int i = 0; i < CI; ++i) {
      const int col = 64 * i + 2 * lane;
      if (col >= F::BN) continue;
      float2* tp = reinterpret_cast<float2*>(tile + r * F::LD + col);
      float v[2] = {tp->x, tp->y};
      if (!IsBf16<T>::value) v[0] = bf16::round_bf16(v[0]), v[1] = bf16::round_bf16(v[1]);
      if (rvec) {
        const float2 rr = tile_pair<F>(rs, r, col);
        v[0] += rr.x, v[1] += rr.y;
      } else if (res != nullptr) {
        if (pair[i]) {
          const float2 rr = ldg2(res + ob[i][0] + nof);
          v[0] += rr.x, v[1] += rr.y;
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (in[i][e]) v[e] += ldg1(res + ob[i][e] + nof);
        }
      }
      if (pair[i]) {
        st2(c + ob[i][0] + nof, v[0], v[1]);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (in[i][e]) st1(c + ob[i][e] + nof, v[e]);
      }
      if (STATS) *tp = make_float2(in[i][0] ? v[0] : 0.f, in[i][1] ? v[1] : 0.f);
    }
  }
  if (STATS) {
    __syncthreads();
    if (tid < F::BM && n0 + tid < N) {
      float sum, sq;
      row_sums2<F, false>(tile, tile, &sum, &sq);
      part[(static_cast<size_t>(pt) * 2) * N + n0 + tid] = sum;
      part[(static_cast<size_t>(pt) * 2 + 1) * N + n0 + tid] = sq;
    }
  }
}

// Each form under a name of its own in a profile.
template <int TAPS, int TH, int WM, bool PRO>
__global__ void __launch_bounds__(kThreads, (Fwd<TAPS, TH, WM, float>::MINB))
conv_bn_infer_bf16_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ scale, const float* __restrict__ shift,
                          float* __restrict__ c, Geo geo, bool relu) {
  fwd_body<TAPS, TH, WM, float, PRO, false, false, false>(x, w, scale, shift, nullptr, c, nullptr,
                                                          geo, relu, nullptr);
}

template <int TAPS, int TH, int WM, bool PRO, bool XVEC>
__global__ void __launch_bounds__(kThreads, (Fwd<TAPS, TH, WM, __nv_bfloat16>::MINB))
conv_bn_train_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ w,
                          const __nv_bfloat16* __restrict__ scale,
                          const __nv_bfloat16* __restrict__ shift,
                          const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ c,
                          float* __restrict__ part, Geo geo, bool relu) {
  fwd_body<TAPS, TH, WM, __nv_bfloat16, PRO, true, false, XVEC>(x, w, scale, shift, res, c, part,
                                                                 geo, relu, nullptr);
}

template <int TAPS, int TH, int WM, bool XVEC>
__global__ void __launch_bounds__(kThreads, (Fwd<TAPS, TH, WM, __nv_bfloat16>::MINB))
conv_bn_stash_bf16_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                              const __nv_bfloat16* __restrict__ w,
                              const __nv_bfloat16* __restrict__ scale,
                              const __nv_bfloat16* __restrict__ shift,
                              const __nv_bfloat16* __restrict__ res,
                              __nv_bfloat16* __restrict__ c, float* __restrict__ part,
                              __nv_bfloat16* __restrict__ xn, Geo geo, bool relu) {
  fwd_body<TAPS, TH, WM, __nv_bfloat16, true, true, true, XVEC>(x, w, scale, shift, res, c, part,
                                                                 geo, relu, xn);
}

// The statistics' second pass of each training form, named after it.
__global__ void conv_bn_train_bf16_stats_sum(const float* __restrict__ part,
                                             float* __restrict__ out, int P, int C) {
  mxt::sum_rows(part, out, P, C);
}

__global__ void conv_bn_stash_bf16_fwd_stats_sum(const float* __restrict__ part,
                                                 float* __restrict__ out, int P, int C) {
  mxt::sum_rows(part, out, P, C);
}

// The three forms: 0 serving, 1 training, 2 stash.
constexpr int kInfer = 0, kTrain = 1, kStash = 2;

template <int FORM, int TAPS, int TH, int WM, bool PRO, bool XVEC, typename T>
cudaError_t launch(cudaStream_t st, const T* x, const T* w, const T* scale, const T* shift,
                   const T* res, T* c, float* part, T* xn, const Geo& g, bool relu) {
  using F = Fwd<TAPS, TH, WM, T>;
  // the training forms hold the residual's tile past the ring
  constexpr int kSmem = FORM == kInfer ? F::SMEM : F::SMEM + F::RES;
  const dim3 grid(parts(g, TAPS) * ceil_div(g.N, F::BM));
  static bool raised = false;
  cudaError_t err;
  if constexpr (FORM == kInfer) {
    auto kernel = conv_bn_infer_bf16_kernel<TAPS, TH, WM, PRO>;
    if ((err = mxt::raise_smem(kernel, kSmem, &raised)) != cudaSuccess) return err;
    kernel<<<grid, kThreads, kSmem, st>>>(x, w, scale, shift, c, g, relu);
  } else if constexpr (FORM == kTrain) {
    auto kernel = conv_bn_train_bf16_kernel<TAPS, TH, WM, PRO, XVEC>;
    if ((err = mxt::raise_smem(kernel, kSmem, &raised)) != cudaSuccess) return err;
    kernel<<<grid, kThreads, kSmem, st>>>(x, w, scale, shift, res, c, part, g, relu);
  } else {
    auto kernel = conv_bn_stash_bf16_fwd_kernel<TAPS, TH, WM, XVEC>;
    if ((err = mxt::raise_smem(kernel, kSmem, &raised)) != cudaSuccess) return err;
    kernel<<<grid, kThreads, kSmem, st>>>(x, w, scale, shift, res, c, part, xn, g, relu);
  }
  return cudaGetLastError();
}

// The tiling of the call (conv_bn_bf16.cuh tile_h, tile_wm; XVEC: bf16 x
// at stride 1 with H·W even, copied by cp.async), then the prologue's
// switch (the stash form always has one).
template <int FORM, bool PRO, typename T>
cudaError_t dispatch_pro(cudaStream_t st, const T* x, const T* w, const T* scale,
                         const T* shift, const T* res, T* c, float* part, T* xn, const Geo& g,
                         int taps, bool relu) {
  const int th = tile_h(g.Ho), wm = tile_wm(g.N, taps, th);
#define MXT_FWD(TAPS, TH, WM, XV) \
  launch<FORM, TAPS, TH, WM, PRO, XV>(st, x, w, scale, shift, res, c, part, xn, g, relu)
  if (taps == 1) {
    if (IsBf16<T>::value && g.stride == 1 && (g.H * g.W) % 2 == 0)
      return wm == 2 ? MXT_FWD(1, 1, 2, IsBf16<T>::value) : MXT_FWD(1, 1, 1, IsBf16<T>::value);
    return wm == 2 ? MXT_FWD(1, 1, 2, false) : MXT_FWD(1, 1, 1, false);
  }
  if (th == 14) return wm == 2 ? MXT_FWD(9, 14, 2, false) : MXT_FWD(9, 14, 1, false);
  if (th == 7) return MXT_FWD(9, 7, 2, false);
  return wm == 2 ? MXT_FWD(9, 8, 2, false) : MXT_FWD(9, 8, 1, false);
#undef MXT_FWD
}

template <int FORM, typename T>
cudaError_t dispatch(cudaStream_t st, const T* x, const T* w, const T* scale, const T* shift,
                     const T* res, T* c, float* part, T* xn, const Geo& g, int taps, bool relu) {
  if constexpr (FORM == kStash) {
    return dispatch_pro<FORM, true>(st, x, w, scale, shift, res, c, part, xn, g, taps, relu);
  } else {
    if (scale != nullptr)
      return dispatch_pro<FORM, true>(st, x, w, scale, shift, res, c, part, xn, g, taps, relu);
    return dispatch_pro<FORM, false>(st, x, w, scale, shift, res, c, part, xn, g, taps, relu);
  }
}

// The training forms: the checks, the launch and the statistics' pass. x, w
// and xn must be 16-byte, c and res 8-byte and scale, shift 4-byte aligned,
// as every tensor PyTorch's allocator makes is.
template <int FORM>
int train_run(const __nv_bfloat16* x, const __nv_bfloat16* w, const __nv_bfloat16* scale,
              const __nv_bfloat16* shift, const __nv_bfloat16* res, __nv_bfloat16* c,
              float* part, float* sums, __nv_bfloat16* xn, int B, int K, int H, int W, int N,
              int taps, int stride, int relu, int nparts, void* stream) {
  if (!valid_call(B, K, H, W, N, taps, stride) || (scale == nullptr) != (shift == nullptr) ||
      part == nullptr || sums == nullptr ||
      (FORM == kStash && (scale == nullptr || xn == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  // w (and x, xn and res where their rows are copied) in 16-byte pieces
  if (misaligned(x, 16) || misaligned(w, 16) || misaligned(c, 8) ||
      (res != nullptr && misaligned(res, 8)) || (xn != nullptr && misaligned(xn, 16)) ||
      (scale != nullptr && (misaligned(scale, 4) || misaligned(shift, 4))))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Geo g = make_geo(B, K, H, W, N, taps, stride);
  if (nparts != parts(g, taps)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dispatch<FORM>(st, x, w, scale, shift, res, c, part, xn, g, taps, relu != 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 sgrid, sblock;
  mxt::sum_rows_shape(nparts, 2 * N, &sgrid, &sblock);
  if (FORM == kStash)
    conv_bn_stash_bf16_fwd_stats_sum<<<sgrid, sblock, 0, st>>>(part, sums, nparts, 2 * N);
  else
    conv_bn_train_bf16_stats_sum<<<sgrid, sblock, 0, st>>>(part, sums, nparts, 2 * N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The stats-free forward on bf16 operands: x, w, scale, shift are f32 (or the
// f32 of bf16 values) and are rounded to bf16 as the kernel stages them; c
// is the f32 of the bf16 result. The geometry rules are mxt_conv_bn_fwd's;
// x, w, c must be 16-byte and scale, shift 8-byte aligned.
extern "C" int mxt_conv_bn_infer_bf16(const float* x, const float* w, const float* scale,
                                      const float* shift, float* c, int B, int K, int H, int W,
                                      int N, int taps, int stride, int relu, void* stream) {
  if (!valid_call(B, K, H, W, N, taps, stride) || (scale == nullptr) != (shift == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned(x, 16) || misaligned(w, 16) || misaligned(c, 16) ||
      (scale != nullptr && (misaligned(scale, 8) || misaligned(shift, 8))))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Geo g = make_geo(B, K, H, W, N, taps, stride);
  return static_cast<int>(dispatch<kInfer>(static_cast<cudaStream_t>(stream), x, w, scale, shift,
                                           static_cast<const float*>(nullptr), c,
                                           static_cast<float*>(nullptr),
                                           static_cast<float*>(nullptr), g, taps, relu != 0));
}

// The bf16 training forward with its statistics: x, w, scale, shift, res and
// c are bf16 (2 bytes an element); part (parts, 2, N) and sums (2, N) f32,
// parts the position tiles (ops/conv_bn.py _fwd_parts at bf16), checked.
extern "C" int mxt_conv_bn_fwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                    const __nv_bfloat16* scale, const __nv_bfloat16* shift,
                                    const __nv_bfloat16* res, __nv_bfloat16* c, float* part,
                                    float* sums, int B, int K, int H, int W, int N, int taps,
                                    int stride, int relu, int parts, void* stream) {
  return train_run<kTrain>(x, w, scale, shift, res, c, part, sums, nullptr, B, K, H, W, N, taps,
                           stride, relu, parts, stream);
}

// The stash form: mxt_conv_bn_fwd_bf16 with the prologue (scale, shift) and
// the xn output (B, K, H', W') in bf16, all required.
extern "C" int mxt_conv_bn_fwd_stash_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                          const __nv_bfloat16* scale,
                                          const __nv_bfloat16* shift,
                                          const __nv_bfloat16* res, __nv_bfloat16* c,
                                          float* part, float* sums, __nv_bfloat16* xn, int B,
                                          int K, int H, int W, int N, int taps, int stride,
                                          int relu, int parts, void* stream) {
  return train_run<kStash>(x, w, scale, shift, res, c, part, sums, xn, B, K, H, W, N, taps,
                           stride, relu, parts, stream);
}
