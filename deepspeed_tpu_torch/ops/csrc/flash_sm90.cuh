// Shared pieces of the attention kernels on wgmma (sm_90a): the mask, the
// backward's recomputation of the probabilities from the saved log-sum-exp
// and its score gradient, each on one fp32 accumulator element in registers,
// the store of an m64nD accumulator's rows, and the shapes and shared memory
// of the backward's dq and dk/dv blocks (bwd::DqCfg, bwd::DkvCfg). The flash
// kernels (flash_attention_fwd.cu, flash_attention_bwd.cu) and the
// block-sparse backward (block_sparse_attention.cu) use them.
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

namespace bwd {

constexpr int kBM = 64;  // query rows a Q or dO tile of the dk/dv ring

// kWG consumer warpgroups of 64 keys each (1 or 2), then the producer warp
template <int D, int kWG> struct DkvCfg {
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kBN = 64 * kWG;     // keys a block
  static constexpr int kBoxes = D / 64;    // 128-byte swizzled boxes across D
  static constexpr int kKBox = kBN * 128;  // bytes of one box of the K or V tile
  static constexpr int kQBox = kBM * 128;  // of one box of a Q or dO tile
  static constexpr int kKBytes = kBoxes * kKBox;
  static constexpr int kQBytes = kBoxes * kQBox;
  // a stage: the Q tile, the dO tile, then lse * log2(e) and delta (kBM
  // floats each), padded to the swizzle atom
  static constexpr int kStageBytes = 2 * kQBytes + 1024;
  static constexpr int kStages = 3;
  // K, V, the ring, then the barriers: kv, full[kStages], empty[kStages]
  static constexpr int kSmem = 1024 + 2 * kKBytes + kStages * kStageBytes + 8 * (1 + 2 * kStages);
};

// kWG consumer warpgroups of 64 query rows each (1 or 2), then the producer warp
template <int D, int kWG> struct DqCfg {
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kBM = 64 * kWG;     // query rows a block
  static constexpr int kBN = 64;           // keys a K or V tile
  static constexpr int kBoxes = D / 64;    // 128-byte swizzled boxes across D
  static constexpr int kQBox = kBM * 128;  // bytes of one box of the Q or dO tile
  static constexpr int kKBox = kBN * 128;  // of one box of a K or V tile
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKBytes = kBoxes * kKBox;
  static constexpr int kStages = D == 64 ? 4 : 3;
  // Q, dO, kStages (K tile, V tile) pairs, then the barriers: q, full[kS], empty[kS]
  static constexpr int kSmem = 1024 + 2 * kQBytes + kStages * 2 * kKBytes + 8 * (1 + 2 * kStages);
};

}  // namespace bwd
}  // namespace dstorch
