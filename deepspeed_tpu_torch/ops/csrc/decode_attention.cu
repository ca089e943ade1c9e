// Single-token cached attention over a contiguous KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/attention/decode_attention.py::
// decode_attention (pallas_call at :318, kernel body _decode_kernel at :128),
// both of its cache types: one query row per (sequence, head) attends over the
// first lengths[b] cache positions, softmax(q . K^T * scale + alibi) . V, with
// grouped-query heads mapped h -> h / (H / KV) and fp32 statistics; an int8
// cache carries fp32 scales per cached row.
//
// Layout: q (B, H, D); K/V one layer's (B, KV, S, D) slice (positions-major:
// each cache row is D contiguous elements) in q's dtype, or int8 with scales
// (B, KV, S) fp32; lengths (B,) int32 including the token just written;
// optional ALiBi slopes (H,) fp32; out (B, H, D).
//
// The kernel (one block of 4 warps per (sequence, KV-head group of up to 16
// query heads, S-chunk), its "mma" and "fma" designs, the chunks' merge and
// what bounds it) lives in decode_sm90.cuh, which paged_decode_attention.cu
// instantiates too. This file gives it its row source, position p of
// (b, KV head) at row (b * KV + kv head) * S + p with the one query row of a
// sequence at position lengths[b] - 1, and its C entries.
#include "decode_sm90.cuh"

namespace dstorch {
namespace {

// The contiguous cache: (B, KV, S) rows, lengths[b] clamped to [0, S].
struct ContiguousRows {
  const int* lengths;
  int S;
  static constexpr bool kTable = false;
  static constexpr bool kOneRow = true;
  static constexpr int kMaxTableBytes = 0;
  struct Block {
    size_t row0;  // the row of position 0
    static constexpr bool kWhole = true;
    __device__ size_t row(int p) const { return row0 + p; }
  };
  __host__ __device__ int capacity() const { return S; }
  int table_bytes(int) const { return 0; }
  __device__ int start(int b) const {
    const int n = lengths[b];
    return (n < 0 ? 0 : (n > S ? S : n)) - 1;
  }
  __device__ Block block(int b, int kvh, int KV, int, int, int*) const {
    return {((size_t)b * KV + kvh) * S};
  }
};

}  // namespace
}  // namespace dstorch

// C entry points bound with ctypes; each returns its launches' cudaGetLastError().
// design: decode_attention.py's decode_design (0 FMA, 1 mma.sync); splits and
// chunk: its decode_plan (S-chunks of `chunk` positions, a multiple of 64);
// partials: fp32 scratch of B * H * splits * (2 + D) for splits > 1.
extern "C" int dstorch_decode_attention(int dtype, int design, const void* q, const void* k,
                                        const void* v, const void* lengths, const void* slopes,
                                        void* out, void* partials, int B, int H, int KV, int S,
                                        int D, int splits, int chunk, float scale, void* stream) {
  const dstorch::decode::Args a{q, k, v, nullptr, nullptr, static_cast<const float*>(slopes),
                                out, static_cast<float*>(partials), B, 1, H, KV, D, splits,
                                chunk, scale};
  const dstorch::ContiguousRows src{static_cast<const int*>(lengths), S};
  return (int)dstorch::decode::dispatch(dtype, design, false, a, src,
                                        static_cast<cudaStream_t>(stream));
}

// The int8 cache: q and out in dtype, k/v int8, k_scale/v_scale fp32 (B, KV, S).
extern "C" int dstorch_decode_attention_int8(int dtype, int design, const void* q, const void* k,
                                             const void* v, const void* k_scale,
                                             const void* v_scale, const void* lengths,
                                             const void* slopes, void* out, void* partials,
                                             int B, int H, int KV, int S, int D, int splits,
                                             int chunk, float scale, void* stream) {
  const dstorch::decode::Args a{q, k, v, static_cast<const float*>(k_scale),
                                static_cast<const float*>(v_scale),
                                static_cast<const float*>(slopes), out,
                                static_cast<float*>(partials), B, 1, H, KV, D, splits, chunk,
                                scale};
  const dstorch::ContiguousRows src{static_cast<const int*>(lengths), S};
  return (int)dstorch::decode::dispatch(dtype, design, true, a, src,
                                        static_cast<cudaStream_t>(stream));
}
