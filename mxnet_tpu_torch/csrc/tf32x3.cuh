// The shared core of the port's tensor-core kernels: matmul_bias_act.cu, the
// conv + BatchNorm forward (conv_bn.cu) and its backward's dgrad and wgrad
// (conv_bn_bwd.cu), the forward and the dgrad through conv_bn.cuh's
// tc_mainloop: float32-accurate products on the TF32 tensor cores
// ("3xTF32"), and cp.async copies for their rings.
//
// What it replaces: the f32 FMAs on the CUDA cores of the first versions of
// those kernels (67 TFLOP/s on an H100 SXM). The port runs in float32
// with TF32 off, and one TF32 pass keeps only 11 significant bits of each
// operand (about 1e-3 relative, beyond the kernels' tolerances; see
// tests/test_torch_tf32x3.py). 3xTF32 splits each operand in two,
//   x = hi + lo,  hi = tf32(x),  lo = tf32(x − hi)      (x − hi is exact),
// and takes hi·hi + hi·lo + lo·hi for each 8-deep step in f32. The dropped
// lo·lo term and lo's own rounding are about 2^-22 relative, so the result
// is as accurate as an f32 dot product, at 495 / 3 = 165 TFLOP/s.
//
// Why mma.sync and not wgmma: the kernels transform every operand element
// before the product, the hi/lo split of both operands and, in conv_bn and
// the backward's wgrad, the BatchNorm prologue relu(x·scale + shift) of the
// input. mma.sync takes its operands from registers, so both transformations
// happen while a warp loads its fragments from shared memory, with no second
// pass over the tile.
// wgmma reads B from shared memory and, for tf32, wants both operands
// K-major; NCHW's x is position-major, so it would need a second,
// transformed copy of every stage. wgmma, TMA and warp specialisation are
// later work (ROADMAP.md §3).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace mxt {
namespace tf32x3 {

// x = hi + lo for the TF32 tensor cores, each rounded to 10 mantissa bits,
// half away from zero: the rounding of cvt.rna.tf32.f32, as two integer
// operations on the bits. x − hi is exact in f32.
__device__ __forceinline__ uint32_t round_tf32(uint32_t u) { return (u + 0x1000u) & 0xffffe000u; }

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(__float_as_uint(x));
  lo = round_tf32(__float_as_uint(x - __uint_as_float(hi)));
}

// d += a · b for one m16n8k8 tile: a 16 x 8 (row), b 8 x 8 (col), d 16 x 8.
// With g = lane / 4 and t = lane % 4 a thread holds
//   a[0] (g, t), a[1] (g + 8, t), a[2] (g, t + 4), a[3] (g + 8, t + 4);
//   b[0] (k = t, n = g), b[1] (k = t + 4, n = g);
//   d[0] (g, 2t), d[1] (g, 2t + 1), d[2] (g + 8, 2t), d[3] (g + 8, 2t + 1).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += a · b to f32 accuracy. The tensor cores add a product's terms to
// the accumulator with truncation, a bias toward zero: chained through
// K/8 · 3 products it shrank the sums of squares of a K = 1032 convolution by
// 1.3e-5 of their size on an H100 (tests/test_torch_tf32x3.py emulates the
// drift), and a version that chained through 4 steps, with lo truncated
// rather than rounded, moved ResNet-50's probabilities past the smoke's
// card-vs-CPU check. So each step's three products go into a fresh
// accumulator, the two small ones first, and that is added to the running
// sum with one rounding to nearest.
__device__ __forceinline__ void mma3(float (&acc)[4], const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                     const uint32_t (&b_lo)[2]) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma(d, a_lo, b_hi);
  mma(d, a_hi, b_lo);
  mma(d, a_hi, b_hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += d[i];
}

// acc[ni] += a · b[ni] for the N n-tiles of one 8-deep step, to f32
// accuracy: mma3's arithmetic (a fresh accumulator a step, the
// two small products first, then one rounding to nearest into acc), issued
// product by product across the n-tiles. mma3 issues each n-tile's three
// mma.sync back to back, each waiting for the one before; here N
// independent ones stand between two that depend on each other, which
// hides the tensor cores' latency inside one warp (the kernels run two
// warps a scheduler).
template <int N>
__device__ __forceinline__ void mma3_tiles(float (&acc)[N][4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[N][2],
                                           const uint32_t (&b_lo)[N][2]) {
  float d[N][4];
#pragma unroll
  for (int n = 0; n < N; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], a_lo, b_hi[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], a_hi, b_lo[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], a_hi, b_hi[n]);
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] += d[n][i];
}

// The fragment layouts above number k = t and k = t + 4 for thread t. Any
// one permutation of the 8 k of a step, used for both A and B, leaves the
// product as it is; the kernels read k = t from column 2t and k = t + 4 from
// column 2t + 1 of the step where an operand's rows run along k, so that a
// thread's two values are one 8-byte shared load (rows padded to 8 mod 32
// floats keep a half-warp's loads on distinct banks).
__device__ __forceinline__ void split2(const float* p, uint32_t& hi0, uint32_t& lo0,
                                       uint32_t& hi1, uint32_t& lo1) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  split(v.x, hi0, lo0);
  split(v.y, hi1, lo1);
}

// ---- cp.async: global -> shared without registers. pred == false copies
// nothing and zero-fills the destination (src-size 0); src must still be a
// valid address then, so callers pass the tensor's base.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace tf32x3
}  // namespace mxt
