// C = A · B with the column sums of C and of C², f32, the sums taken from the
// f32 accumulators before C is stored: the statistics a BatchNorm after a 1x1
// convolution needs, without reading C again.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_matmul_stats.py _kernel (:47),
// launched by matmul_with_stats (:71, pallas_call :99). A is (M, K) and B is
// (K, N), both row-major; B is read as it lies, and no transposed copy is
// made. col_sum and col_sumsq are (N,) f32.
//
// Bound on an H100, at ResNet-50's 1x1 convolutions at batch 32 (2·M·K·N =
// 3.29 GFLOP each): the products on the TF32 tensor cores at f32 accuracy
// (tf32x3.cuh's 3xTF32: three mma.sync m16n8k8 a step, each step in a fresh
// accumulator) take 0.0199 ms at the 495 TFLOP/s peak, about 0.039 ms at the
// 84 TFLOP/s of f32 work that mma.sync reaches with that step and nothing
// else to do (chip_smoke.py's mma_sync_rate). Where K is short the bytes bound
// as much: at (100352, 64) · (64, 256) the 103 MB of C take 0.0384 ms at
// 3.35 TB/s, so there the stores must overlap the products.
//
// One kernel, 8 warps of 32 x 32 (64 x 32 in the 256 x 64 tile), A streamed
// through a cp.async ring of K slices (rows padded to BK + 8 floats, 8 mod
// 32: a thread's two values of a step are one 8-byte load, a half-warp's on
// distinct banks). Each 8-deep step issues its three products across the
// n-tiles of each m16 tile in turn (tf32x3.cuh's mma3_tiles), so independent
// mma.sync stand between two that depend on each other. Two schedules,
// picked by the caller (ops/matmul_stats.py _schedule), differ in where B
// lives:
//
// - Short K (K <= 128: the deploy tap (100352, 64, 256)). Persistent
//   blocks, about one an SM: block (p, s) owns B's N-slab s and the M-tiles
//   p, p + P, p + 2P, ... (P = gridDim.x), fixed by blockIdx alone. It
//   stages its slab once, split into TF32 (hi, lo) pairs, in shared memory
//   ([k][n], rows of 2·BN + 4 words, 4 mod 32, so a quad's 8-byte loads of
//   rows 2t and 2t + 1 fall on distinct banks), and streams its A-tiles in
//   64-deep slices through a 4-stage ring that runs on across tile
//   boundaries: the next tiles' slices are in flight while a tile's C is
//   stored, straight from the accumulator fragments as 8-byte stores (each
//   warp instruction fills whole 32-byte sectors), which do not hold the
//   warp. (Streaming stores and a fourth stage measured no faster.)
// - Long K (the rest: (100352, 256, 64), (25088, 512, 128), (1568, 2048,
//   512)). One tile a block, matmul_bias_act's structure: A and B slices
//   through a 3-stage ring, B's as it lies ([k][n], rows of BN + 4 floats, 4
//   mod 32), split as each warp loads its fragments; 64 x 128 tiles in
//   64-deep slices, or 256 x 64 in 32-deep ones for N <= 64. No split K: it
//   measured no faster.
//
// Column sums from the fragments. In the m16n8 accumulator a thread holds
// rows g and g + 8 of columns 2t and 2t + 1; it adds its own rows into
// registers it keeps across its M-tiles (the TPU kernel's sequential M sweep,
// done once a block). At the end the 8 values of g are combined by
// __shfl_xor_sync over lane offsets 4, 8, 16, the warps along M through
// shared memory in warp order, into one partial row [Σc | Σc²] a block of a
// (P, 2, N) buffer; a second kernel (common.cuh's sum_rows) adds the P rows
// in a fixed order. No atomics: two runs give the same bits. Rows and
// columns past the edge, and K past its end, are zero-filled on load, so they
// add nothing; K or N no multiple of 4 takes 4-byte copies.
//
// Where it stands (PERF.md §6): 30-37 TFLOP/s of f32 work, under half of
// mma_sync_rate's ceiling; 16 warps, other warp tiles, split K and deeper
// rings measured no faster. wgmma (B's slab stored K-major, A split in
// registers) is the next step (ROADMAP.md §2b D).
#include "tf32x3.cuh"

namespace {

using namespace mxt::tf32x3;

constexpr int kSmemMax = 232448;   // the dynamic shared memory a block may have

// A block's tile BM x BN, its warps WM along M by WN along N, the K slice a
// ring stage holds, and whether B's slab is resident (short K) or streamed
// (long K).
template <int BM_, int BN_, int WM_, int WN_, int BK_, bool RES_>
struct Layout {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, BK = BK_;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr bool RES = RES_;
  static constexpr int MT = BM / WM / 16, NT = BN / WN / 8;  // a warp's m16 and n8 tiles
  static constexpr int kStages = RES ? 4 : 3;
  static constexpr int kARow = BK + 8;                        // floats, 8 mod 32
  static constexpr int kBRow = RES ? 2 * BN + 4 : BN + 4;    // words, 4 mod 32
  static constexpr int kStageFloats = BM * kARow + (RES ? 0 : BK * kBRow);
  static_assert(MT >= 1 && NT >= 1 && BN % 32 == 0 && BK % 32 == 0, "layout");
  // bytes of dynamic shared memory for KS slices of K
  static long long smem(int KS) {
    return 4LL * (kStages * kStageFloats + (RES ? static_cast<long long>(KS) * BK * kBRow : 0));
  }
};

// The layouts by their code (ops/matmul_stats.py LAYOUTS), 8 warps each.
using Short64x128 = Layout<64, 128, 2, 4, 64, true>;    // warps of 32 x 32
using Short128x64 = Layout<128, 64, 4, 2, 64, true>;    // 32 x 32
using Tile64x128 = Layout<64, 128, 2, 4, 64, false>;    // 32 x 32
using Tile256x64 = Layout<256, 64, 4, 2, 32, false>;    // 64 x 32, 32-deep slices

template <class L>
__global__ void __launch_bounds__(L::kThreads, 1)
matmul_stats_kernel(const float* __restrict__ A, const float* __restrict__ B,
                    float* __restrict__ C, float* __restrict__ part, int M, int N, int K) {
  extern __shared__ __align__(16) float smem[];
  constexpr int BK = L::BK, kARow = L::kARow;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % L::WM, wn = warp / L::WM;
  const int P = gridDim.x, p = blockIdx.x, n0 = blockIdx.y * L::BN;
  const int tiles = ((M + L::BM - 1) / L::BM - p + P - 1) / P;  // M-tiles p, p + P, ...
  const int KS = (K + BK - 1) / BK;
  const int items = tiles * KS;  // ring items: slice i % KS of this block's tile i / KS
  const bool vec_a = K % 4 == 0, vec_b = N % 4 == 0;
  uint32_t* bres = reinterpret_cast<uint32_t*>(smem + L::kStages * L::kStageFloats);

  auto issue = [&](int i) {
    float* as = smem + (i % L::kStages) * L::kStageFloats;
    const int m0 = (p + (i / KS) * P) * L::BM, k0 = (i % KS) * BK;
    if (vec_a) {
#pragma unroll
      for (int e = tid; e < L::BM * BK / 4; e += L::kThreads) {
        const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
        const bool ok = m0 + r < M && k0 + c < K;
        cp_async16(as + r * kARow + c, ok ? A + static_cast<size_t>(m0 + r) * K + k0 + c : A,
                   ok);
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < L::BM * BK; e += L::kThreads) {
        const int r = e / BK, c = e % BK;
        const bool ok = m0 + r < M && k0 + c < K;
        cp_async4(as + r * kARow + c, ok ? A + static_cast<size_t>(m0 + r) * K + k0 + c : A, ok);
      }
    }
    if (!L::RES) {
      float* bs = as + L::BM * kARow;
      if (vec_b) {
#pragma unroll
        for (int e = tid; e < BK * L::BN / 4; e += L::kThreads) {
          const int r = e / (L::BN / 4), c = (e % (L::BN / 4)) * 4;
          const bool ok = k0 + r < K && n0 + c < N;
          cp_async16(bs + r * L::kBRow + c,
                     ok ? B + static_cast<size_t>(k0 + r) * N + n0 + c : B, ok);
        }
      } else {
#pragma unroll 4
        for (int e = tid; e < BK * L::BN; e += L::kThreads) {
          const int r = e / L::BN, c = e % L::BN;
          const bool ok = k0 + r < K && n0 + c < N;
          cp_async4(bs + r * L::kBRow + c, ok ? B + static_cast<size_t>(k0 + r) * N + n0 + c : B,
                    ok);
        }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < L::kStages - 1; ++s) {
    if (s < items) issue(s);
    cp_async_commit();
  }
  if (L::RES) {
    // B's slab, once: rows k < KS·32 (zeros past K), columns n0 .. n0 + BN
    // (zeros past N), each value stored as its (hi, lo) pair
    for (int e = tid; e < KS * BK * (L::BN / 4); e += L::kThreads) {
      const int k = e / (L::BN / 4), c = (e % (L::BN / 4)) * 4, n = n0 + c;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (k < K) {
        const float* src = B + static_cast<size_t>(k) * N + n;
        if (vec_b && n < N) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(src));
          v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n + j < N) v[j] = __ldg(src + j);
        }
      }
      uint32_t h[4], l[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) split(v[j], h[j], l[j]);
      uint4* dst = reinterpret_cast<uint4*>(bres + k * L::kBRow + 2 * c);
      dst[0] = make_uint4(h[0], l[0], h[1], l[1]);
      dst[1] = make_uint4(h[2], l[2], h[3], l[3]);
    }
  }

  float acc[L::MT][L::NT][4] = {};
  float csum[L::NT][2] = {}, csq[L::NT][2] = {};  // this thread's columns 2t, 2t + 1
  for (int i = 0; i < items; ++i) {
    cp_async_wait<L::kStages - 2>();
    __syncthreads();  // item i landed (and B's slab); every warp is done with item i - 1
    if (i + L::kStages - 1 < items) issue(i + L::kStages - 1);
    cp_async_commit();
    const int ks = i % KS;
    const float* as = smem + (i % L::kStages) * L::kStageFloats + wm * L::MT * 16 * kARow;
    const float* bs = smem + (i % L::kStages) * L::kStageFloats + L::BM * kARow;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      // k = t and t + 4 of the step from rows 2t and 2t + 1 of B, columns 2t
      // and 2t + 1 of A (tf32x3.cuh's permutation)
      uint32_t b_hi[L::NT][2], b_lo[L::NT][2];
#pragma unroll
      for (int ni = 0; ni < L::NT; ++ni) {
        const int col = wn * L::NT * 8 + ni * 8 + g;
        if (L::RES) {
          const uint32_t* br = bres + (ks * BK + kk + 2 * t) * L::kBRow + 2 * col;
          const uint2 v0 = *reinterpret_cast<const uint2*>(br);
          const uint2 v1 = *reinterpret_cast<const uint2*>(br + L::kBRow);
          b_hi[ni][0] = v0.x; b_lo[ni][0] = v0.y;
          b_hi[ni][1] = v1.x; b_lo[ni][1] = v1.y;
        } else {
          const float* br = bs + (kk + 2 * t) * L::kBRow + col;
          split(br[0], b_hi[ni][0], b_lo[ni][0]);
          split(br[L::kBRow], b_hi[ni][1], b_lo[ni][1]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < L::MT; ++mi) {
        const float* ar = as + (mi * 16 + g) * kARow + kk + 2 * t;
        uint32_t a_hi[4], a_lo[4];
        split2(ar, a_hi[0], a_lo[0], a_hi[2], a_lo[2]);
        split2(ar + 8 * kARow, a_hi[1], a_lo[1], a_hi[3], a_lo[3]);
        mma3_tiles(acc[mi], a_hi, a_lo, b_hi, b_lo);
      }
    }
    if (ks != KS - 1) continue;
    // the tile is done: its columns into this thread's sums, its C stored
    // from the fragments, the accumulators zeroed for the next tile
    const int row0 = (p + (i / KS) * P) * L::BM + wm * L::MT * 16 + g;
#pragma unroll
    for (int ni = 0; ni < L::NT; ++ni) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int mi = 0; mi < L::MT; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v = acc[mi][ni][2 * h + j];
            csum[ni][j] += v;
            csq[ni][j] = fmaf(v, v, csq[ni][j]);
          }
      const int col = n0 + wn * L::NT * 8 + ni * 8 + 2 * t;
      if (col < N) {
#pragma unroll
        for (int mi = 0; mi < L::MT; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + mi * 16 + 8 * h;
            if (row >= M) continue;
            float* out = C + static_cast<size_t>(row) * N + col;
            if (vec_b) {  // N even: rows 8-byte aligned, col + 1 < N
              *reinterpret_cast<float2*>(out) =
                  make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
            } else {
              out[0] = acc[mi][ni][2 * h];
              if (col + 1 < N) out[1] = acc[mi][ni][2 * h + 1];
            }
          }
      }
#pragma unroll
      for (int mi = 0; mi < L::MT; ++mi)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;
    }
  }
  cp_async_wait<0>();

  // the block's partial row: the 8 rows g of a quad by shuffles, then the
  // warps along M in warp order (shared memory: the ring, no longer read)
  float* red = smem;  // [WM][2][BN]
  __syncthreads();
#pragma unroll
  for (int ni = 0; ni < L::NT; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float s = csum[ni][j], q = csq[ni][j];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s += __shfl_xor_sync(mxt::kFullMask, s, o);
        q += __shfl_xor_sync(mxt::kFullMask, q, o);
      }
      if (g == 0) {
        const int col = wn * L::NT * 8 + ni * 8 + 2 * t + j;
        red[(wm * 2) * L::BN + col] = s;
        red[(wm * 2 + 1) * L::BN + col] = q;
      }
    }
  __syncthreads();
  for (int e = tid; e < 2 * L::BN; e += L::kThreads) {
    const int which = e / L::BN, col = e % L::BN;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < L::WM; ++w) v += red[(w * 2 + which) * L::BN + col];
    if (n0 + col < N) part[(static_cast<size_t>(p) * 2 + which) * N + n0 + col] = v;
  }
}

// sums[c] = Σ_{p < P} part[p · C + c], c < C = 2N, in a fixed order (sum_rows).
__global__ void matmul_stats_sum_kernel(const float* __restrict__ part, float* __restrict__ sums,
                                        int P, int C) {
  mxt::sum_rows(part, sums, P, C);
}

// groups: the blocks along M (short K: 1 <= P <= the M-tiles, persistent;
// long K: the M-tiles).
template <class L>
cudaError_t launch(const float* a, const float* b, float* c, float* part, int M, int K, int N,
                   int groups, cudaStream_t st) {
  const int m_tiles = (M + L::BM - 1) / L::BM, n_slabs = (N + L::BN - 1) / L::BN;
  const long long smem = L::smem((K + L::BK - 1) / L::BK);
  if ((L::RES ? groups < 1 || groups > m_tiles : groups != m_tiles) || smem > kSmemMax ||
      n_slabs > 65535)
    return cudaErrorInvalidValue;
  auto kernel = matmul_stats_kernel<L>;
  static bool raised = false;
  cudaError_t err = mxt::raise_smem(kernel, kSmemMax, &raised);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(groups, n_slabs), L::kThreads, static_cast<int>(smem), st>>>(a, b, c, part, M,
                                                                            N, K);
  return cudaGetLastError();
}

}  // namespace

// layout: 0 short K 64 x 128, 1 short K 128 x 64, 2 tiles 64 x 128, 3 tiles
// 256 x 64. groups: the blocks along M, P (checked here against the layout);
// part: (P, 2, N) scratch the caller allocated; sums: (2, N), row 0 the
// column sums and row 1 the sums of squares.
extern "C" int mxt_matmul_stats_fwd(const float* a, const float* b, float* c, float* part,
                                    float* sums, int M, int K, int N, int layout, int groups,
                                    void* stream) {
  if (M < 1 || N < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (layout) {
    case 0: err = launch<Short64x128>(a, b, c, part, M, K, N, groups, st); break;
    case 1: err = launch<Short128x64>(a, b, c, part, M, K, N, groups, st); break;
    case 2: err = launch<Tile64x128>(a, b, c, part, M, K, N, groups, st); break;
    case 3: err = launch<Tile256x64>(a, b, c, part, M, K, N, groups, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 sgrid, sblock;
  mxt::sum_rows_shape(groups, 2 * N, &sgrid, &sblock);
  matmul_stats_sum_kernel<<<sgrid, sblock, 0, st>>>(part, sums, groups, 2 * N);
  return static_cast<int>(cudaGetLastError());
}
