// bf16 products on the tensor cores by mma.sync (the bf16 forms of the
// flash-attention kernels through flash_tc.cuh, matmul_bias_act.cu's and
// matmul_stats.cu's), the prologue's bf16 arithmetic, and the loads and
// stores of bf16 storage (those kernels and the bf16 conv+BN kernels,
// conv_bn_bf16.cuh, whose products run on wgmma instead: wgmma.cuh).
//
// What it computes is the TPU kernels' arithmetic on bf16 operands (for
// the conv+BN kernel, mxnet_tpu/ops/pallas_conv_bn.py _kernel :240-290):
// the prologue x·scale + shift is two bf16 operations, each rounded to
// bf16; a product of two bf16 values is exact in f32 and takes an f32
// accumulator; a result stored as bf16 is rounded to the nearest.
//
// One mma.sync m16n8k8 with bf16 operands takes the place of the 3xTF32
// path's three m16n8k8 TF32 products and its two splits (tf32x3.cuh): the
// fragment registers hold the same k positions (thread t: k = 2t, 2t + 1 in
// one register, which the kernels map to the same shared-memory columns and
// rows as the TF32 path's k = t, t + 4).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace mxt {

// ---- storage: the kernels' operands are float or __nv_bfloat16 (T). A load
// widens to f32, which is exact for a bf16 value; a store to bf16 rounds to
// the nearest (ties to even), as torch's and XLA's casts do. The bf16 loads
// take 2, 4 or 8 bytes: the caller keeps 2, 4 or 8 bf16 values aligned.
__device__ __forceinline__ float bits_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bits_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ float ldg1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg1(const __nv_bfloat16* p) {
  return bits_lo(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ldg2(const __nv_bfloat16* p) {
  const uint32_t u = __ldg(reinterpret_cast<const unsigned int*>(p));
  return make_float2(bits_lo(u), bits_hi(u));
}
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(bits_lo(u.x), bits_hi(u.x), bits_lo(u.y), bits_hi(u.y));
}

__device__ __forceinline__ void st1(float* p, float v) { *p = v; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T>
struct IsBf16 {
  static constexpr bool value = false;
};
template <>
struct IsBf16<__nv_bfloat16> {
  static constexpr bool value = true;
};

namespace bf16 {

// x rounded to the nearest bf16 (ties to even), as f32: the rounding of
// torch's and XLA's casts to bfloat16.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Two f32 values as one register of two bf16, each rounded to the nearest
// (ties to even): lo in the low half, the fragment's lower k.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a · b for one m16n8k8 tile of bf16 operands into f32. With g = lane /
// 4 and t = lane % 4 a thread holds
//   a[0] (g, k = 2t | 2t + 1), a[1] (g + 8, k = 2t | 2t + 1);
//   b (k = 2t | 2t + 1, n = g);
//   d[0] (g, 2t), d[1] (g, 2t + 1), d[2] (g + 8, 2t), d[3] (g + 8, 2t + 1).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// The prologue relu(x·scale + shift) on bf16 values held in f32: the product
// rounded to bf16, then the sum rounded to bf16, as two bf16 operations
// round (ops/conv_bn.py conv_block_infer_plain states why two). The f32
// product of two bf16 values is exact, and so is the f32 sum of two unless
// they are more than 2^16 apart, where both roundings give the larger one,
// so each bf16 result is the correctly rounded one. A bf16 FMA, which rounds
// once, would differ.
__device__ __forceinline__ float prologue(float x, float sc, float sh, bool relu) {
  const float v = round_bf16(__fadd_rn(round_bf16(__fmul_rn(x, sc)), sh));
  return relu ? fmaxf(v, 0.f) : v;
}

}  // namespace bf16
}  // namespace mxt
