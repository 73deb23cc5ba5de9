// C = act(A · Wᵀ + b), f32, with the bias and activation on the accumulator.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_matmul_bias_act.py _kernel
// (launched by _fwd_call). A is (M, K) and W is (N, K), the FullyConnected
// layout: both operands are contiguous along K, and the kernel contracts them
// along that axis, so no transpose is ever made.
//
// Two schedules, picked by the caller (ops/matmul_bias_act.py _schedule):
//
// - Small M (decode: A (8, 512), W (2048, 512)). Bound by bytes: W's 4 MB,
//   0.00128 ms at 3.35 TB/s; at 8 rows the tensor cores do not matter. A
//   block stages its rows of A, up to 32, in shared memory with cp.async (8
//   x 512 f32 is 16 KB) while each of its 8 warps starts streaming one row
//   of W (one output column) with 16-byte loads, four in flight a lane;
//   each lane keeps one f32 FMA partial sum per row of A, the warp adds them
//   by shuffles, and lane m applies the bias and the activation and stores
//   C[m, n]. N = 2048 gives 256 blocks of 8 columns for each group of 32
//   rows; the groups after the first read W again, from L2.
// - Tiles (prefill A (1024, 512), training A (2048, 512)). Bound by
//   operations: 3 · 2MNK FLOP on the TF32 tensor cores (tf32x3.cuh's
//   3xTF32, f32-accurate), 0.0130 ms at the prefill's shape. A block owns a
//   128 x 128 tile of C (128 tiles at the prefill on 132 SMs), 8 warps of
//   64 x 32 each; K runs in slices of 32 through a 3-stage cp.async.cg ring
//   in dynamic shared memory, rows padded to 40 floats so that a thread's
//   two values of a step are one 8-byte load and a half-warp's loads hit
//   distinct banks. Each warp splits its A and W fragments into hi/lo as it
//   loads them and issues three mma.sync m16n8k8 a tile (tf32x3.cuh's
//   mma3).
//
// The caller picks small M up to the crossover measured on an H100 at the
// decode's K and N (chip_smoke.py's "matmul_bias_act_crossover" line):
// small M is faster at every M up to 192 (0.0428 against 0.0434 ms there,
// 0.0090 against 0.0420 at M = 32), the tiles at 256. Ragged M, N and K
// are predicated in both: K % 4 != 0 or an operand that is not 16-byte
// aligned takes 4-byte copies and loads in the same kernels, rows and
// columns past the edge are zero-filled on load and skipped on store.
//
// The bf16 form (mxt_matmul_bias_act_fwd_bf16: the TPU kernel on bf16 a, w
// and b, pallas_matmul_bias_act.py:57-62) runs both schedules on bf16
// storage: the products accumulate in f32 (small M: f32 FMAs of the widened
// values, exact products; tiles: one bf16 mma.sync m16n8k8 a step, into a
// fresh accumulator a slice added with one rounding, bf16_mma.cuh), the
// bias is widened and the activation applied in f32, and y is rounded to
// bf16 as it is stored. The shared memory holds f32 as in the f32 form: a
// slice's bf16 elements are loaded into registers and stored widened. Small
// M is bound by the bytes of W at 2 bytes an element; the tiles by
// operations at 989 TFLOP/s. Its kernels have names of their own in a
// profile (mba_bf16_*).
#include "bf16_mma.cuh"
#include "tf32x3.cuh"

namespace {

using namespace mxt::tf32x3;
using mxt::IsBf16;
using mxt::ldg1;
using mxt::ldg4;
using mxt::st1;
using mxt::st2;

enum Act { kRelu = 0, kSigmoid = 1, kTanh = 2, kSoftrelu = 3 };
enum Schedule { kSmallM = 0, kTiles = 1 };

__device__ __forceinline__ float apply_act(float p, int act) {
  switch (act) {
    case kRelu: return fmaxf(p, 0.f);
    case kSigmoid: return 1.f / (1.f + expf(-p));
    case kTanh: return tanhf(p);
    default: return fmaxf(p, 0.f) + log1pf(expf(-fabsf(p)));  // log(1 + e^p)
  }
}

// ------------------------------------------------------------ small M
constexpr int kSmallThreads = 256;              // 8 warps, one output column each
constexpr int kSmallCols = kSmallThreads / 32;  // output columns a block
constexpr int kSmallRows = 32;                  // rows of A a block: its register tile
constexpr int kSmallMaxSmem = 64 * 1024;        // a block's rows of A: rows · K · 4 bytes
constexpr int kUnroll = 4;                      // W loads in flight a lane

template <int MT, bool VEC, typename T>
__device__ __forceinline__ void small_m(const T* __restrict__ A, const T* __restrict__ W,
                                        const T* __restrict__ bias, T* __restrict__ C, int M,
                                        int N, int K, int act) {
  extern __shared__ __align__(16) float as[];  // as[m * K + k] = A[m0 + m, k]
  const int tid = threadIdx.x, lane = tid & 31;
  const int n = blockIdx.x * kSmallCols + (tid >> 5);
  // this block's rows: blockIdx.y's group of kSmallRows (the last one ragged)
  const int m0 = blockIdx.y * kSmallRows;
  M = min(M - m0, kSmallRows);
  A += static_cast<size_t>(m0) * K;
  C += static_cast<size_t>(m0) * N;
  if constexpr (IsBf16<T>::value) {
    // widened as it is staged: its loads wait here, before W's first round
    if (VEC) {
      for (int c = tid; c < M * K / 4; c += kSmallThreads)
        *reinterpret_cast<float4*>(as + 4 * c) = ldg4(A + 4 * c);
    } else {
      for (int e = tid; e < M * K; e += kSmallThreads) as[e] = ldg1(A + e);
    }
  } else if (VEC) {
    for (int c = tid; c < M * K / 4; c += kSmallThreads) cp_async16(as + 4 * c, A + 4 * c, true);
  } else {
    for (int e = tid; e < M * K; e += kSmallThreads) cp_async4(as + e, A + e, true);
  }
  cp_async_commit();
  const bool live = n < N;
  const T* wr = W + static_cast<size_t>(live ? n : 0) * K;
  constexpr int kStep = (VEC ? 4 : 1) * 32 * kUnroll;  // K covered by one round of loads
  float4 wv[kUnroll];
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + (VEC ? 4 : 1) * (lane + 32 * u);
      if (VEC) {
        wv[u] = live && k < K ? ldg4(wr + k) : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        wv[u].x = live && k < K ? ldg1(wr + k) : 0.f;
      }
    }
  };
  load(0);  // W's first round is in flight while A lands
  cp_async_wait<0>();
  __syncthreads();
  if (!live) return;
  float acc[MT] = {};
  for (int k0 = 0; k0 < K; k0 += kStep) {
    if (k0 > 0) load(k0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + (VEC ? 4 : 1) * (lane + 32 * u);
      if (k >= K) break;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m >= M) break;
        if (VEC) {
          const float4 a = *reinterpret_cast<const float4*>(as + m * K + k);
          acc[m] = fmaf(a.x, wv[u].x, acc[m]);
          acc[m] = fmaf(a.y, wv[u].y, acc[m]);
          acc[m] = fmaf(a.z, wv[u].z, acc[m]);
          acc[m] = fmaf(a.w, wv[u].w, acc[m]);
        } else {
          acc[m] = fmaf(as[m * K + k], wv[u].x, acc[m]);
        }
      }
    }
  }
  float mine = 0.f;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float s = mxt::warp_sum(acc[m]);
    if (lane == m) mine = s;
  }
  if (lane < M) {
    if (bias != nullptr) mine += ldg1(bias + n);
    st1(C + static_cast<size_t>(lane) * N + n, apply_act(mine, act));
  }
}

template <int MT, bool VEC>
__global__ void __launch_bounds__(kSmallThreads)
matmul_bias_act_small_m_kernel(const float* __restrict__ A, const float* __restrict__ W,
                               const float* __restrict__ bias, float* __restrict__ C, int M,
                               int N, int K, int act) {
  small_m<MT, VEC>(A, W, bias, C, M, N, K, act);
}

template <int MT, bool VEC>
__global__ void __launch_bounds__(kSmallThreads)
mba_bf16_small_m_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ W,
                        const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ C,
                        int M, int N, int K, int act) {
  small_m<MT, VEC>(A, W, bias, C, M, N, K, act);
}

// ------------------------------------------------------------ tiles
constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3;
constexpr int kThreads = 256;                   // 8 warps: 2 along M x 4 along N
constexpr int kWM = kBM / 2, kWN = kBN / 4;     // a warp's 64 x 32 tile
constexpr int kMT = kWM / 16, kNT = kWN / 8;    // its m16 and n8 tiles
constexpr int kRow = kBK + 8;                   // padded shared row: 8 mod 32 floats
constexpr int kStageFloats = (kBM + kBN) * kRow;
constexpr int kTileSmem = kStages * kStageFloats * 4;  // 122 880 bytes

// One K slice of A and W into stage s: rows past M or N and columns past K
// are zero-filled.
template <bool VEC, typename T>
__device__ __forceinline__ void load_slice(float* st, const T* __restrict__ A,
                                           const T* __restrict__ W, int m0, int n0, int k0,
                                           int M, int N, int K, int tid) {
  float* as = st;
  float* ws = st + kBM * kRow;
  if constexpr (IsBf16<T>::value) {
    // every load of the slice first, then the widened stores
    constexpr int kPer = VEC ? 4 : 1, kCols = kBK / kPer, kIt = kBM * kBK / kPer / kThreads;
    const int col = (tid % kCols) * kPer, k = k0 + col;
    float4 av[kIt], wv[kIt];
#pragma unroll
    for (int i = 0; i < kIt; ++i) {
      const int r = tid / kCols + i * (kThreads / kCols);
      const bool pa = m0 + r < M && k < K, pw = n0 + r < N && k < K;
      const T* fa = A + static_cast<size_t>(m0 + r) * K + k;
      const T* fw = W + static_cast<size_t>(n0 + r) * K + k;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      av[i] = !pa ? z : (VEC ? ldg4(fa) : make_float4(ldg1(fa), 0.f, 0.f, 0.f));
      wv[i] = !pw ? z : (VEC ? ldg4(fw) : make_float4(ldg1(fw), 0.f, 0.f, 0.f));
    }
#pragma unroll
    for (int i = 0; i < kIt; ++i) {
      const int r = tid / kCols + i * (kThreads / kCols);
      if (VEC) {
        *reinterpret_cast<float4*>(as + r * kRow + col) = av[i];
        *reinterpret_cast<float4*>(ws + r * kRow + col) = wv[i];
      } else {
        as[r * kRow + col] = av[i].x;
        ws[r * kRow + col] = wv[i].x;
      }
    }
    return;
  }
  if (VEC) {
    const int col = (tid % (kBK / 4)) * 4, k = k0 + col;
#pragma unroll
    for (int i = 0; i < kBM * kBK / 4 / kThreads; ++i) {
      const int r = tid / (kBK / 4) + i * (kThreads / (kBK / 4));
      const bool pa = m0 + r < M && k < K, pw = n0 + r < N && k < K;
      cp_async16(as + r * kRow + col, pa ? A + static_cast<size_t>(m0 + r) * K + k : A, pa);
      cp_async16(ws + r * kRow + col, pw ? W + static_cast<size_t>(n0 + r) * K + k : W, pw);
    }
  } else {
    const int col = tid % kBK, k = k0 + col;
#pragma unroll
    for (int i = 0; i < kBM * kBK / kThreads; ++i) {
      const int r = tid / kBK + i * (kThreads / kBK);
      const bool pa = m0 + r < M && k < K, pw = n0 + r < N && k < K;
      cp_async4(as + r * kRow + col, pa ? A + static_cast<size_t>(m0 + r) * K + k : A, pa);
      cp_async4(ws + r * kRow + col, pw ? W + static_cast<size_t>(n0 + r) * K + k : W, pw);
    }
  }
}

template <bool VEC, typename T>
__device__ __forceinline__ void tiles(const T* __restrict__ A, const T* __restrict__ W,
                                      const T* __restrict__ bias, T* __restrict__ C, int M, int N,
                                      int K, int act) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int KT = (K + kBK - 1) / kBK;
  float acc[kMT][kNT][4] = {};

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_slice<VEC>(smem + s * kStageFloats, A, W, m0, n0, s * kBK, M, N, K, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice kt landed; every warp is done with slice kt - 1's stage
    const int nk = kt + kStages - 1;
    if (nk < KT)
      load_slice<VEC>(smem + (nk % kStages) * kStageFloats, A, W, m0, n0, nk * kBK, M, N, K,
                      tid);
    cp_async_commit();
    const float* as = smem + (kt % kStages) * kStageFloats + (wm * kWM) * kRow;
    const float* ws = smem + (kt % kStages) * kStageFloats + (kBM + wn * kWN) * kRow;
    if constexpr (IsBf16<T>::value) {
      // k = 2t and 2t + 1 of the step from columns 2t, 2t + 1 (bf16_mma.cuh)
      float d[kMT][kNT][4] = {};
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 8) {
        uint32_t b[kNT];
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni) {
          const float2 v = *reinterpret_cast<const float2*>(ws + (ni * 8 + g) * kRow + kk + 2 * t);
          b[ni] = mxt::bf16::pack(v.x, v.y);
        }
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
          const float* ar = as + (mi * 16 + g) * kRow + kk + 2 * t;
          const float2 lo = *reinterpret_cast<const float2*>(ar);
          const float2 hi = *reinterpret_cast<const float2*>(ar + 8 * kRow);
          const uint32_t a[2] = {mxt::bf16::pack(lo.x, lo.y), mxt::bf16::pack(hi.x, hi.y)};
#pragma unroll
          for (int ni = 0; ni < kNT; ++ni) mxt::bf16::mma(d[mi][ni], a, b[ni]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mi][ni][i] += d[mi][ni][i];
    } else {
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 8) {
        // k = t and t + 4 of the step from columns 2t, 2t + 1 (tf32x3.cuh)
        uint32_t b_hi[kNT][2], b_lo[kNT][2];
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni)
          split2(ws + (ni * 8 + g) * kRow + kk + 2 * t, b_hi[ni][0], b_lo[ni][0], b_hi[ni][1],
                 b_lo[ni][1]);
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
          const float* ar = as + (mi * 16 + g) * kRow + kk + 2 * t;
          uint32_t a_hi[4], a_lo[4];
          split2(ar, a_hi[0], a_lo[0], a_hi[2], a_lo[2]);
          split2(ar + 8 * kRow, a_hi[1], a_lo[1], a_hi[3], a_lo[3]);
#pragma unroll
          for (int ni = 0; ni < kNT; ++ni) mma3(acc[mi][ni], a_hi, a_lo, b_hi[ni], b_lo[ni]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const bool pairs = (N & 1) == 0;  // C rows 8-byte aligned: store two columns at once
#pragma unroll
  for (int ni = 0; ni < kNT; ++ni) {
    const int col = n0 + wn * kWN + ni * 8 + 2 * t;
    if (col >= N) continue;
    const float b0 = bias != nullptr ? ldg1(bias + col) : 0.f;
    const float b1 = bias != nullptr && col + 1 < N ? ldg1(bias + col + 1) : 0.f;
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * kWM + mi * 16 + g + 8 * h;
        if (row >= M) continue;
        T* out = C + static_cast<size_t>(row) * N + col;
        const float v0 = apply_act(acc[mi][ni][2 * h] + b0, act);
        const float v1 = apply_act(acc[mi][ni][2 * h + 1] + b1, act);
        if (pairs && col + 1 < N) {
          st2(out, v0, v1);
        } else {
          st1(out, v0);
          if (col + 1 < N) st1(out + 1, v1);
        }
      }
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
matmul_bias_act_tile_kernel(const float* __restrict__ A, const float* __restrict__ W,
                            const float* __restrict__ bias, float* __restrict__ C, int M, int N,
                            int K, int act) {
  tiles<VEC>(A, W, bias, C, M, N, K, act);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
mba_bf16_tile_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ W,
                     const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ C, int M,
                     int N, int K, int act) {
  tiles<VEC>(A, W, bias, C, M, N, K, act);
}

// Raise a kernel's dynamic shared-memory limit (above 48 KB it must be
// asked for); once a process, to the largest size the kernel takes.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool* raised) {
  if (bytes <= 48 * 1024 || *raised) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  *raised = err == cudaSuccess;
  return err;
}

template <int MT, bool VEC, typename T>
cudaError_t launch_small(const T* a, const T* w, const T* bias, T* c, int M, int N, int K,
                         int act, cudaStream_t st) {
  const int smem = (M < kSmallRows ? M : kSmallRows) * K * 4;
  auto kernel = [] {
    if constexpr (IsBf16<T>::value) return mba_bf16_small_m_kernel<MT, VEC>;
    else return matmul_bias_act_small_m_kernel<MT, VEC>;
  }();
  static bool raised = false;
  cudaError_t err = allow_smem(kernel, kSmallMaxSmem, &raised);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kSmallCols - 1) / kSmallCols, (M + kSmallRows - 1) / kSmallRows);
  kernel<<<grid, kSmallThreads, smem, st>>>(a, w, bias, c, M, N, K, act);
  return cudaGetLastError();
}

template <bool VEC, typename T>
cudaError_t launch_tiles(const T* a, const T* w, const T* bias, T* c, int M, int N, int K,
                         int act, cudaStream_t st) {
  auto kernel = [] {
    if constexpr (IsBf16<T>::value) return mba_bf16_tile_kernel<VEC>;
    else return matmul_bias_act_tile_kernel<VEC>;
  }();
  static bool raised = false;
  cudaError_t err = allow_smem(kernel, kTileSmem, &raised);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  kernel<<<grid, kThreads, kTileSmem, st>>>(a, w, bias, c, M, N, K, act);
  return cudaGetLastError();
}

// Both schedules on storage T; align: what a, w must be aligned to for the
// 4-element loads (16 bytes for f32, 8 for bf16).
template <typename T>
int matmul_bias_act_run(const T* a, const T* w, const T* bias, T* c, int M, int N, int K,
                        int act, int schedule, void* stream) {
  if (M < 1 || N < 1 || K < 1 || act < kRelu || act > kSoftrelu || M > 65535 * kBM)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned align = 4 * sizeof(T);
  const bool vec = K % 4 == 0 && (reinterpret_cast<uintptr_t>(a) % align) == 0 &&
                   (reinterpret_cast<uintptr_t>(w) % align) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (schedule == kSmallM) {
    if (M > 65535 * kSmallRows ||
        static_cast<long long>(M < kSmallRows ? M : kSmallRows) * K * 4 > kSmallMaxSmem)
      return static_cast<int>(cudaErrorInvalidValue);
    if (M <= 8)
      err = vec ? launch_small<8, true>(a, w, bias, c, M, N, K, act, st)
                : launch_small<8, false>(a, w, bias, c, M, N, K, act, st);
    else if (M <= 16)
      err = vec ? launch_small<16, true>(a, w, bias, c, M, N, K, act, st)
                : launch_small<16, false>(a, w, bias, c, M, N, K, act, st);
    else
      err = vec ? launch_small<32, true>(a, w, bias, c, M, N, K, act, st)
                : launch_small<32, false>(a, w, bias, c, M, N, K, act, st);
  } else if (schedule == kTiles) {
    err = vec ? launch_tiles<true>(a, w, bias, c, M, N, K, act, st)
              : launch_tiles<false>(a, w, bias, c, M, N, K, act, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // namespace

// schedule: 0 small M (min(M, 32)·K·4 <= 64 KiB), 1 tiles.
extern "C" int mxt_matmul_bias_act_fwd(const float* a, const float* w, const float* bias,
                                       float* c, int M, int N, int K, int act, int schedule,
                                       void* stream) {
  return matmul_bias_act_run(a, w, bias, c, M, N, K, act, schedule, stream);
}

// The bf16 form: a, w, bias and c bf16; the schedules and their rules are the
// f32 form's (the small-M schedule stages its rows of a as f32, so the same
// shared-memory limit holds).
extern "C" int mxt_matmul_bias_act_fwd_bf16(const __nv_bfloat16* a, const __nv_bfloat16* w,
                                            const __nv_bfloat16* bias, __nv_bfloat16* c, int M,
                                            int N, int K, int act, int schedule, void* stream) {
  return matmul_bias_act_run(a, w, bias, c, M, N, K, act, schedule, stream);
}
