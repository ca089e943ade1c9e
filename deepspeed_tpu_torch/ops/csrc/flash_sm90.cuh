// Shared pieces of the attention kernels on wgmma (sm_90a): the mask, the
// backward's recomputation of the probabilities from the saved log-sum-exp
// and its score gradient, each on one fp32 accumulator element in registers,
// and the store of an m64nD accumulator's rows. The flash forward
// (flash_attention_fwd.cu) and dk/dv kernel (flash_attention_bwd.cu) use
// them; a dq kernel on wgmma would take the same.
//
// Accumulator element e of a thread (wgmma.cuh's layout, g = lane / 4,
// t = lane % 4) lies in row 16 warp + g + 8 ((e >> 1) & 1) of the
// warpgroup's 64 and column 8 (e >> 2) + 2t + (e & 1): acc_half(e) and
// acc_col(e) below.
#pragma once

#include "common.cuh"
#include "wgmma.cuh"

namespace dstorch {
namespace attn {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ int acc_half(int e) { return (e >> 1) & 1; }
__device__ __forceinline__ int acc_col(int e, int t) { return 8 * (e >> 2) + 2 * t + (e & 1); }

// 2^x on the special-function unit (ex2.approx.ftz: about 2 ulp; results
// below 2^-126 flush to 0, far under the 16-bit rounding of p)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Whether the pair (query, key) lies outside the attention: past either
// length, or a future key under causal masking.
__device__ __forceinline__ bool masked(int query, int key, int Tq, int Tk, bool causal) {
  return query >= Tq || key >= Tk || (causal && key > query);
}

// p = exp(s * scale - lse) from the unscaled score s, in base 2 (scale_log2
// = scale * log2(e), lse2 = lse * log2(e)); 0 where masked. fp32: the caller
// rounds p to dO's dtype where it packs it for the dV product.
__device__ __forceinline__ float recompute_p(float s, float scale_log2, float lse2, bool is_masked) {
  return is_masked ? 0.f : exp2_approx(fmaf(s, scale_log2, -lse2));
}

// ds = p (dp - delta), with p unrounded and dp = dO . v; fp32 (rounded to q's
// dtype where it is packed for the dK product, k's for a dQ product).
__device__ __forceinline__ float score_grad(float p, float dp, float delta) {
  return p * (dp - delta);
}

// Row acc_half = r of this thread's m64nD accumulator, times mul, rounded to
// T, to dst (the row's first element): columns 8j + 2t, +1.
template <typename T, int D>
__device__ __forceinline__ void store_acc_row(T* dst, const float (&acc)[D / 2], int r, int t,
                                              float mul) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * t) =
        pack2<T>(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
}

}  // namespace attn
}  // namespace dstorch
