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
// matmul_bias_act's 3 stages. The main loop is conv_bn.cuh's tc_mainloop,
// which the backward's dgrad (conv_bn_bwd.cu) runs too.
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

namespace {

using namespace mxt::convbn;

// Two blocks an SM (at most 128 registers a thread): at the 1x1 sites with
// few input channels the kernel is bound by bytes, and one block an SM
// leaves too few loads and stores in flight.
template <int TAPS, bool VEC, bool PRO, bool STATS>
__global__ void __launch_bounds__(kThreads, 2)
conv_bn_fwd_tc_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ scale, const float* __restrict__ shift,
                      const float* __restrict__ res, float* __restrict__ c,
                      float* __restrict__ part, Geo geo, bool relu) {
  using C = Cfg<TAPS>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % C::WARPS_M, wn = warp / C::WARPS_M;
  // the channel blocks of one position tile run one after another, so the
  // tile's x is read from device memory once and from L2 by the others
  const int cblocks = ceil_div(geo.N, C::BM);
  const int pt = blockIdx.x / cblocks, n0 = (blockIdx.x - pt * cblocks) * C::BM;
  const int N = geo.N, HWo = geo.Ho * geo.Wo;
  const TcArgs args{w, x, scale, shift, N, geo.K, geo.K, geo.B,
                    geo.H, geo.W, geo.Ho, geo.Wo, geo.stride, relu};
  float acc[C::MT][C::NT][4] = {};
  tc_mainloop<TAPS, VEC, PRO>(args, pt, n0, smem, acc);

  // ---- epilogue: the thread's columns 2t, 2t + 1 of each n8 tile, each
  // with its own output offset at channel 0 (a 1x1 tile may start the next
  // image between the two)
  size_t ob[C::NT][2];
  bool in[C::NT][2];
#pragma unroll
  for (int ni = 0; ni < C::NT; ++ni) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      int b, oy, ox;
      in[ni][j] = tile_col<TAPS>(geo, pt, wn * C::WN + ni * 8 + 2 * t + j, &b, &oy, &ox);
      ob[ni][j] = static_cast<size_t>(b) * N * HWo + static_cast<size_t>(oy) * geo.Wo + ox;
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
    float sum, sq;
    tile_row_sums<TAPS>(s, q2, smem, &sum, &sq);
    if (tid < C::BM && n0 + tid < N) {
      part[(static_cast<size_t>(pt) * 2) * N + n0 + tid] = sum;
      part[(static_cast<size_t>(pt) * 2 + 1) * N + n0 + tid] = sq;
    }
  }
}

// The statistics' second pass: (ssum, ssq) = Σ over the partial rows.
__global__ void conv_bn_fwd_stats_sum(const float* __restrict__ part, float* __restrict__ out,
                                      int P, int C) {
  mxt::sum_rows(part, out, P, C);
}

template <int TAPS, bool VEC, bool PRO, bool STATS>
cudaError_t launch(dim3 grid, cudaStream_t st, const float* x, const float* w,
                   const float* scale, const float* shift, const float* res, float* c,
                   float* part, const Geo& g, bool relu) {
  auto kernel = conv_bn_fwd_tc_kernel<TAPS, VEC, PRO, STATS>;
  constexpr int smem = Cfg<TAPS>::SMEM;
  static bool raised = false;
  cudaError_t err = mxt::raise_smem(kernel, smem, &raised);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(x, w, scale, shift, res, c, part, g, relu);
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

// parts: the partial rows the caller allocated (ops/conv_bn.py _tc_parts),
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
  if (misaligned(x, 16) || misaligned(w, 16) || misaligned(c, 16) ||
      (res != nullptr && misaligned(res, 16)) ||
      (scale != nullptr && (misaligned(scale, 8) || misaligned(shift, 8))))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Geo g = make_geo(B, K, H, W, N, taps, stride);
  const bool stats = part != nullptr, pro = scale != nullptr;
  const int ptiles = tc_parts(g, taps);
  if (stats && parts != ptiles) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(ptiles * ceil_div(N, kTileM));
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
  mxt::sum_rows_shape(parts, 2 * N, &sgrid, &sblock);
  conv_bn_fwd_stats_sum<<<sgrid, sblock, 0, st>>>(part, sums, parts, 2 * N);
  return static_cast<int>(cudaGetLastError());
}
