// Single-token cached attention over a contiguous KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/attention/decode_attention.py::
// decode_attention (pallas_call at :318, kernel body _decode_kernel at :128).
// One query row per (sequence, head) attends over the first lengths[b] cache
// positions: softmax(q . K^T * scale + alibi) . V, with grouped-query heads
// mapped h -> h / (H / KV), fp32 statistics and the probabilities rounded to
// the cache dtype before the PV product, as the TPU kernel does.
//
// Layout: q (B, H, D); K/V one layer's (B, KV, S, D) slice (positions-major:
// each cache row is D contiguous elements); lengths (B,) int32 including the
// token just written; optional ALiBi slopes (H,) fp32; out (B, H, D).
//
// What bounds it on the H100: bytes. Each step reads 2 * len * D elements of
// K and V per (b, kv-head) and does 4 * D flops per position, ~1 flop per
// byte, far below the ~295 flop/byte ridge. So the design only tries to keep
// the cache reads coalesced and in flight:
//   * one block per (b, h), 8 warps; a warp covers 32 / (D / 8) cache rows per
//     sweep with D / 8 lanes per row, so each lane issues 16-byte loads and a
//     warp reads whole contiguous rows (D = 64 bf16: 4 rows = 512 bytes);
//   * each lane loads kUnroll positions of K and V before using any of them;
//   * the loop stops at lengths[b], so traffic follows the live length, not
//     the allocated S (the TPU kernel's index-map clamp did the same);
//   * each row group keeps its own running (max, sum, acc) online softmax and
//     the block merges the 8 * rows-per-warp partial states in shared memory.
// Not yet done (later work): split-S across blocks (flash-decoding) to fill
// all 132 SMs when B * H is small, TMA loads.
//
// The int8 cache variant (decode_attention_int8_kernel, entry point
// dstorch_decode_attention_int8) is the TPU kernel's k_scale/v_scale path: K/V
// are int8 (B, KV, S, D) with fp32 scales (B, KV, S), one per cached row. The
// K scale multiplies the score and the V scale the probability, per position,
// so no row is ever dequantized; the scaled probability is rounded to bf16 for
// bf16 queries (fp32 otherwise) before the PV product, as on the TPU. An int8
// row is D bytes, so one 16-byte load holds 16 elements: D / 16 lanes per row
// (4 at D = 64, against 8 for bf16), and twice the positions per sweep for the
// same bytes in flight. Its loads are issued branch-free and unpacked after all
// of them are out (the paged kernel's pattern); the bf16 kernel above keeps its
// own loads, which a change of pattern was measured to slow down.
#include "common.cuh"

namespace dstorch {
namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ lengths,
                        const float* __restrict__ slopes, T* __restrict__ out,
                        int H, int KV, int S, float scale) {
  constexpr int kVec = Vec<T>::kN;
  constexpr int kLanesPerRow = D / kVec;
  static_assert(D % kVec == 0 && 32 % kLanesPerRow == 0, "unsupported head dim");
  constexpr int kRowsPerWarp = 32 / kLanesPerRow;
  constexpr int kStates = kWarps * kRowsPerWarp;  // also positions per sweep

  __shared__ float sm_m[kStates];
  __shared__ float sm_l[kStates];
  __shared__ float sm_acc[kStates][D];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / kLanesPerRow, sub = lane % kLanesPerRow;
  const int state = warp * kRowsPerWarp + grp;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const float slope = slopes != nullptr ? slopes[h] : 0.f;

  float qf[kVec];
  load_vec(q + (size_t)bh * D + sub * kVec, qf);
  const size_t kv_base = ((size_t)b * KV + kvh) * (size_t)S * D + sub * kVec;
  const T* kp = k + kv_base;
  const T* vp = v + kv_base;

  float m = kNegInf, l = 0.f;
  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;

  // The loop bound is uniform across the warp (every lane sees the same
  // base), so the shuffles below always run with all 32 lanes.
  for (int base = warp * kRowsPerWarp; base < len; base += kStates * kUnroll) {
    float kf[kUnroll][kVec], vf[kUnroll][kVec];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = base + u * kStates + grp;
      valid[u] = pos < len;
      if (valid[u]) {
        load_vec(kp + (size_t)pos * D, kf[u]);
        load_vec(vp + (size_t)pos * D, vf[u]);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) kf[u][i] = vf[u][i] = 0.f;
      }
    }
    float s[kUnroll];
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) dot += qf[i] * kf[u][i];
#pragma unroll
      for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int pos = base + u * kStates + grp;
      s[u] = dot * scale + slope * (float)(pos - (len - 1));
      if (valid[u]) m_new = fmaxf(m_new, s[u]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!valid[u]) continue;
      const float p = expf(s[u] - m_new);
      l += p;
      const float pr = round_through<T>(p);
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] += pr * vf[u][i];
    }
    m = m_new;
  }

  if (sub == 0) {
    sm_m[state] = m;
    sm_l[state] = l;
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) sm_acc[state][sub * kVec + i] = acc[i];
  __syncthreads();

  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    float mx = kNegInf;
    for (int st = 0; st < kStates; ++st) mx = fmaxf(mx, sm_m[st]);
    float tot = 0.f, o = 0.f;
    for (int st = 0; st < kStates; ++st) {
      const float w = expf(sm_m[st] - mx);
      tot += sm_l[st] * w;
      o += sm_acc[st][d] * w;
    }
    // max(l, 1e-30): a free slot (length 0) yields 0, never NaN
    out[(size_t)bh * D + d] = from_float<T>(o / fmaxf(tot, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths,
                   const float* slopes, void* out, int B, int H, int KV, int S,
                   float scale, cudaStream_t stream) {
  decode_attention_kernel<T, D><<<B * H, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      lengths, slopes, static_cast<T*>(out), H, KV, S, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int D, const void* q, const void* k, const void* v,
                       const int* lengths, const float* slopes, void* out, int B,
                       int H, int KV, int S, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, lengths, slopes, out, B, H, KV, S, scale, stream);
    case 64: return launch<T, 64>(q, k, v, lengths, slopes, out, B, H, KV, S, scale, stream);
    case 128: return launch<T, 128>(q, k, v, lengths, slopes, out, B, H, KV, S, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------ int8 cache
template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                             const int8_t* __restrict__ v, const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale,
                             const int* __restrict__ lengths,
                             const float* __restrict__ slopes, T* __restrict__ out, int H,
                             int KV, int S, float scale) {
  constexpr int kLanesPerRow = D / 16;
  static_assert(D % 16 == 0 && 32 % kLanesPerRow == 0, "unsupported head dim");
  constexpr int kRowsPerWarp = 32 / kLanesPerRow;
  constexpr int kStates = kWarps * kRowsPerWarp;  // also positions per sweep

  __shared__ float sm_m[kStates];
  __shared__ float sm_l[kStates];
  __shared__ float sm_acc[kStates][D];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / kLanesPerRow, sub = lane % kLanesPerRow;
  const int state = warp * kRowsPerWarp + grp;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const float slope = slopes != nullptr ? slopes[h] : 0.f;

  float qf[16];
  load_16(q + (size_t)bh * D + sub * 16, qf);
  const size_t row_base = ((size_t)b * KV + kvh) * (size_t)S;  // scale index of position 0
  const int8_t* kp = k + row_base * D + sub * 16;
  const int8_t* vp = v + row_base * D + sub * 16;
  const float* ksp = k_scale + row_base;
  const float* vsp = v_scale + row_base;

  float m = kNegInf, l = 0.f;
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;

  // The loop bound is uniform across the warp, so the shuffles below always
  // run with all 32 lanes. A lane past the length reads position 0 (always
  // allocated) instead of branching, and its values are masked.
  for (int base = warp * kRowsPerWarp; base < len; base += kStates * kUnroll) {
    uint4 kraw[kUnroll], vraw[kUnroll];
    float ks[kUnroll], vs[kUnroll];
    int pos[kUnroll];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      pos[u] = base + u * kStates + grp;
      valid[u] = pos[u] < len;
      const size_t p = valid[u] ? pos[u] : 0;
      kraw[u] = *reinterpret_cast<const uint4*>(kp + p * D);
      vraw[u] = *reinterpret_cast<const uint4*>(vp + p * D);
      ks[u] = ksp[p];
      vs[u] = vsp[p];
    }
    float s[kUnroll];
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[16];
      unpack_i8x16(kraw[u], kf);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) dot += qf[i] * kf[i];
#pragma unroll
      for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      s[u] = dot * scale * ks[u] + slope * (float)(pos[u] - (len - 1));
      if (valid[u]) m_new = fmaxf(m_new, s[u]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!valid[u]) continue;
      const float p = expf(s[u] - m_new);
      l += p;
      const float pr = round_p_int8<T>(p * vs[u]);
      float vf[16];
      unpack_i8x16(vraw[u], vf);
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] += pr * vf[i];
    }
    m = m_new;
  }

  if (sub == 0) {
    sm_m[state] = m;
    sm_l[state] = l;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) sm_acc[state][sub * 16 + i] = acc[i];
  __syncthreads();

  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    float mx = kNegInf;
    for (int st = 0; st < kStates; ++st) mx = fmaxf(mx, sm_m[st]);
    float tot = 0.f, o = 0.f;
    for (int st = 0; st < kStates; ++st) {
      const float w = expf(sm_m[st] - mx);
      tot += sm_l[st] * w;
      o += sm_acc[st][d] * w;
    }
    out[(size_t)bh * D + d] = from_float<T>(o / fmaxf(tot, 1e-30f));
  }
}

template <typename T>
cudaError_t launch_int8_dim(int D, const void* q, const void* k, const void* v,
                            const float* ks, const float* vs, const int* lengths,
                            const float* slopes, void* out, int B, int H, int KV, int S,
                            float scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const int8_t* kt = static_cast<const int8_t*>(k);
  const int8_t* vt = static_cast<const int8_t*>(v);
  T* o = static_cast<T*>(out);
  switch (D) {
    case 32:
      decode_attention_int8_kernel<T, 32><<<B * H, kWarps * 32, 0, stream>>>(
          qt, kt, vt, ks, vs, lengths, slopes, o, H, KV, S, scale);
      break;
    case 64:
      decode_attention_int8_kernel<T, 64><<<B * H, kWarps * 32, 0, stream>>>(
          qt, kt, vt, ks, vs, lengths, slopes, o, H, KV, S, scale);
      break;
    case 128:
      decode_attention_int8_kernel<T, 128><<<B * H, kWarps * 32, 0, stream>>>(
          qt, kt, vt, ks, vs, lengths, slopes, o, H, KV, S, scale);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace dstorch

// C entry point of the int8-cache variant, bound with ctypes. q and out are in
// dtype; k/v are int8 and k_scale/v_scale fp32. Returns cudaGetLastError().
extern "C" int dstorch_decode_attention_int8(int dtype, const void* q, const void* k,
                                             const void* v, const void* k_scale,
                                             const void* v_scale, const void* lengths,
                                             const void* slopes, void* out, int B, int H,
                                             int KV, int S, int D, float scale,
                                             void* stream) {
  using namespace dstorch;
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* len = static_cast<const int*>(lengths);
  const float* sl = static_cast<const float*>(slopes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return (int)launch_int8_dim<float>(D, q, k, v, ks, vs, len, sl, out, B, H, KV, S, scale, st);
    case kBFloat16: return (int)launch_int8_dim<__nv_bfloat16>(D, q, k, v, ks, vs, len, sl, out, B, H, KV, S, scale, st);
    case kFloat16: return (int)launch_int8_dim<__half>(D, q, k, v, ks, vs, len, sl, out, B, H, KV, S, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// C entry point bound with ctypes. Returns the launch's cudaGetLastError().
extern "C" int dstorch_decode_attention(int dtype, const void* q, const void* k,
                                        const void* v, const void* lengths,
                                        const void* slopes, void* out, int B, int H,
                                        int KV, int S, int D, float scale,
                                        void* stream) {
  using namespace dstorch;
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const int* len = static_cast<const int*>(lengths);
  const float* sl = static_cast<const float*>(slopes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return (int)launch_dim<float>(D, q, k, v, len, sl, out, B, H, KV, S, scale, st);
    case kBFloat16: return (int)launch_dim<__nv_bfloat16>(D, q, k, v, len, sl, out, B, H, KV, S, scale, st);
    case kFloat16: return (int)launch_dim<__half>(D, q, k, v, len, sl, out, B, H, KV, S, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
