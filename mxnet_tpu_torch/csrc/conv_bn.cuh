// Shared pieces of the fused conv + BatchNorm kernels: the shape gate and
// the fixed-order sum of per-block partial rows (conv_bn.cu forward and
// conv_bn_bwd.cu backward), and the backward's tiling and f32 implicit-GEMM
// step over one staged chunk (the forward tiles for the tensor cores in
// conv_bn.cu). In the backward a block owns a 64-channel by 64-position output tile of one image and
// 256 threads, each a 4 x 4 register micro-tile (4 channels by 4 positions).
// For a 1x1 kernel the 64 positions run along the flattened output grid;
// for a 3x3 kernel they are an 8 x 8 pixel tile, and the staged input chunk
// is that tile with its one-pixel border (10 x 10), so the 9 taps are shifted
// reads of one staged chunk and a border pixel outside the image is a 0 (the
// pad-1 semantics of the TPU kernel's _shift_masks, pallas_conv_bn.py:216).
#pragma once

#include "common.cuh"

namespace mxt {
namespace convbn {

constexpr int kTileC = 64;                // output channels of a block
constexpr int kTileP = 64;                // output positions of a block
constexpr int kTileHW = 8;                // 3x3: the positions are 8 x 8 pixels
constexpr int kHaloW = kTileHW + 2;       // ... staged with a one-pixel border
constexpr int kHalo = kHaloW * kHaloW;    // 100 staged positions
constexpr int kChunk = 8;                 // contraction channels staged a step
constexpr int kThreads = 256;             // 16 x 16 threads, 4 x 4 micro-tiles
constexpr int kWRow = kTileC + 4;         // a padded shared row of 64 channels

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The geometry of one call: x (B, K, H, W), w (N, K, taps), output grid
// (Ho, Wo) (a 1x1 kernel of stride 2 samples every second row and column).
struct Geo {
  int B, K, H, W, N, Ho, Wo, stride;
  int tiles_x;  // 3x3: 8-pixel tiles across a row of the output grid
  int ptiles;   // position tiles of one image
};

inline Geo make_geo(int B, int K, int H, int W, int N, int taps, int stride) {
  Geo g;
  g.B = B, g.K = K, g.H = H, g.W = W, g.N = N, g.stride = stride;
  g.Ho = taps == 1 ? ceil_div(H, stride) : H;
  g.Wo = taps == 1 ? ceil_div(W, stride) : W;
  g.tiles_x = ceil_div(g.Wo, kTileHW);
  g.ptiles = taps == 1 ? ceil_div(g.Ho * g.Wo, kTileP) : ceil_div(g.Ho, kTileHW) * g.tiles_x;
  return g;
}

// The shape gate of pallas_conv_bn._conv_geometry (K % 8 == 0 also makes the
// forward's K chunks exact), plus the launch limits.
inline bool valid_call(int B, int K, int H, int W, int N, int taps, int stride) {
  if (B < 1 || B > 65535 || N < 1 || K < kChunk || K % kChunk || H < 1 || W < 1) return false;
  if (taps == 1) {
    if (stride != 1 && stride != 2) return false;
  } else if (taps != 9 || stride != 1) {
    return false;
  }
  const Geo g = make_geo(B, K, H, W, N, taps, stride);
  return g.Ho * g.Wo >= 8 && ceil_div(N, kTileC) <= 65535 && ceil_div(K, kTileC) * 9 <= 65535;
}

// Output position of the thread's j-th column in position tile pt (the
// flattened index in the Ho x Wo grid), or -1 past the edge.
template <int TAPS>
__device__ __forceinline__ int tile_pos(const Geo& g, int pt, int tp, int j) {
  if (TAPS == 1) {
    const int p = pt * kTileP + tp * 4 + j;
    return p < g.Ho * g.Wo ? p : -1;
  }
  const int oy = (pt / g.tiles_x) * kTileHW + (tp >> 1);
  const int ox = (pt % g.tiles_x) * kTileHW + (tp & 1) * 4 + j;
  return oy < g.Ho && ox < g.Wo ? oy * g.Wo + ox : -1;
}

// Staged position j of tile pt (the tile itself for 1x1, the tile and its
// border for 3x3): its (oy, ox) in the output grid; false outside the grid.
template <int TAPS>
__device__ __forceinline__ bool staged_pos(const Geo& g, int pt, int j, int* oy, int* ox) {
  if (TAPS == 1) {
    const int p = pt * kTileP + j;
    *oy = p / g.Wo;
    *ox = p - *oy * g.Wo;
    return p < g.Ho * g.Wo;
  }
  *oy = (pt / g.tiles_x) * kTileHW - 1 + j / kHaloW;
  *ox = (pt % g.tiles_x) * kTileHW - 1 + j % kHaloW;
  return *oy >= 0 && *oy < g.Ho && *ox >= 0 && *ox < g.Wo;
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 a, const float* b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], b[j], acc[i][j]);
}

// acc[i][j] += Σ_c Σ_t ws[c, t][tc*4 + i] · xs[c][tap t's source of position
// tp*4 + j], over the kChunk staged contraction channels c. ws holds a row
// of kWRow for each (c, t), row c * TAPS + t; xs a row of kTileP (1x1) or
// kHalo (3x3) for each c. Tap t = 3·dy + dx reads the staged position
// (row + dy, col + dx) of the bordered tile.
template <int TAPS>
__device__ __forceinline__ void mma_chunk(const float* __restrict__ ws,
                                          const float* __restrict__ xs, float (&acc)[4][4],
                                          int tc, int tp) {
#pragma unroll
  for (int c = 0; c < kChunk; ++c) {
    if (TAPS == 1) {
      const float4 a = *reinterpret_cast<const float4*>(ws + c * kWRow + tc * 4);
      const float4 b4 = *reinterpret_cast<const float4*>(xs + c * kTileP + tp * 4);
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
      fma4x4(acc, a, b);
    } else {
      const float* xr = xs + c * kHalo + (tp >> 1) * kHaloW + (tp & 1) * 4;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float b[6];
#pragma unroll
        for (int q = 0; q < 6; ++q) b[q] = xr[dy * kHaloW + q];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 a =
              *reinterpret_cast<const float4*>(ws + (c * 9 + dy * 3 + dx) * kWRow + tc * 4);
          fma4x4(acc, a, b + dx);
        }
      }
    }
  }
}

// Sum of a value over the 16 threads of a half-warp that share tc.
__device__ __forceinline__ float tile_row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// out[col] = Σ_{p < P} part[p · C + col] in a fixed order: lane l of a column
// adds rows l, l + L, l + 2L, ..., then lane 0 adds the L lane sums in order.
// No atomics, so two runs give the same bits. Block (256 / L, L).
__device__ __forceinline__ void sum_rows(const float* __restrict__ part,
                                         float* __restrict__ out, int P, int C) {
  __shared__ float red[kThreads];
  const int cols = blockDim.x, L = blockDim.y;
  const int col = blockIdx.x * cols + threadIdx.x;
  float s = 0.f;
  if (col < C)
    for (int p = threadIdx.y; p < P; p += L) s += part[static_cast<size_t>(p) * C + col];
  red[threadIdx.y * cols + threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < C) {
    float t = 0.f;
    for (int l = 0; l < L; ++l) t += red[l * cols + threadIdx.x];
    out[col] = t;
  }
}

// The launch shape of sum_rows for P rows of C columns.
inline void sum_rows_shape(int P, int C, dim3* grid, dim3* block) {
  const int L = P >= 64 ? 16 : (P >= 8 ? 4 : 1);
  *block = dim3(kThreads / L, L);
  *grid = dim3(ceil_div(C, kThreads / L));
}

}  // namespace convbn
}  // namespace mxt
