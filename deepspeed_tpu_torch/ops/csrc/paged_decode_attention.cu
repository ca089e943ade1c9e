// Cached attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/attention/paged_attention.py::
// paged_decode_attention (pallas_call at :247, kernel body _paged_kernel at :58).
// Each slot b has 1 <= T <= 8 query rows (plain decode T = 1; speculative
// verify T = K + 1). Row t sits at absolute position starts[b] + t and attends
// the cache positions [0, starts[b] + t]: softmax(q . K^T * scale + alibi) . V,
// with grouped-query heads mapped h -> h / (H / KV), fp32 statistics and the
// probabilities rounded to the cache dtype before the PV product, as the
// contiguous decode kernel (decode_attention.cu) does.
//
// Layout: q (B, T, H, D); K/V one layer's page pool (P, KV, page_size, D),
// positions-major inside a page (each cache row is D contiguous elements);
// table (B, max_pages) int32, where position p of slot b lives in page
// table[b, p / page_size], row p % page_size; starts (B,) int32, the cache
// length before this step's T rows (which the caller has already written);
// optional ALiBi slopes (H,) fp32; out (B, T, H, D).
//
// Page ids are never trusted: an unmapped entry holds the sentinel P and is
// clipped to page P - 1. Such a page is only ever reached past a slot's live
// length, and every read past the length is masked, so its contents never
// reach the output.
//
// What bounds it on the H100: bytes, as for the contiguous decode kernel: each
// step reads 2 * len * D elements of K and V per (b, kv-head) and does
// 4 * T * D flops per position. The design keeps the reads coalesced and in
// flight and reads only live pages:
//   * the block loads its slot's live page-table entries into shared memory
//     once (this replaces the TPU's scalar prefetch of the table);
//   * one block per (b, h), 8 warps; D / 8 lanes (16-byte loads) read one
//     cache row, so a warp reads 32 / (D / 8) whole rows per sweep, and each
//     row group keeps kUnroll positions of K and V in flight: the loads are
//     branch-free and unpacked only after all of them are issued (a load
//     whose conversion sat inside its own bounds branch made the next one
//     wait, which cost 1.9x in time);
//   * the loop stops at starts[b] + T, so traffic follows the live length (the
//     TPU kernel clamped its index map to the last live page for the same);
//   * every row group keeps one online-softmax state per query row, so K/V
//     are read once for all T rows; the block merges the partial states of
//     each row in shared memory.
// Not yet done (later work): split-S across blocks (flash-decoding) to fill
// all 132 SMs when B * H is small, one block per KV head serving its H / KV
// query heads so a page is read once under GQA, TMA loads.
//
// The int8 page variant (paged_decode_int8_kernel, entry point
// dstorch_paged_decode_attention_int8) is the TPU kernel's k_scale_pages /
// v_scale_pages path: pages are int8 (P, KV, page_size, D) with fp32 scale
// pages (P, KV, page_size), one scale per cached row, resolved through the same
// table. As in decode_attention.cu's int8 variant, the K scale multiplies the
// score and the V scale the probability, D / 16 lanes read one row, and the
// scaled probability is rounded to bf16 for bf16 queries before the PV product.
#include "common.cuh"

namespace dstorch {
namespace {

constexpr int kWarps = 8;
constexpr int kMaxRows = 8;  // MAX_QUERY_ROWS in ops/attention/paged_attention.py

// R: query rows the kernel is compiled for (1, or kMaxRows for 2..8 rows).
template <typename T, int D, int R>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ table,
                    const int* __restrict__ starts, const float* __restrict__ slopes,
                    T* __restrict__ out, int rows, int H, int KV, int P, int ps,
                    int max_pages, float scale) {
  constexpr int kVec = Vec<T>::kN;
  constexpr int kLanesPerRow = D / kVec;
  static_assert(D % kVec == 0 && 32 % kLanesPerRow == 0, "unsupported head dim");
  constexpr int kRowsPerWarp = 32 / kLanesPerRow;
  constexpr int kStates = kWarps * kRowsPerWarp;  // also positions per sweep
  constexpr int kUnroll = R == 1 ? 4 : 2;         // fewer in flight: R states live

  extern __shared__ int sm_table[];  // the slot's live page ids, clipped
  __shared__ float sm_m[kStates];
  __shared__ float sm_l[kStates];
  __shared__ float sm_acc[kStates][D];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / kLanesPerRow, sub = lane % kLanesPerRow;
  const int state = warp * kRowsPerWarp + grp;

  // q does not depend on the table: its loads go out first
  const float slope = slopes != nullptr ? slopes[h] : 0.f;
  float qf[R][kVec];
#pragma unroll
  for (int t = 0; t < R; ++t) {
    if (t < rows) {
      load_vec(q + ((size_t)(b * rows + t) * H + h) * D + sub * kVec, qf[t]);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) qf[t][i] = 0.f;
    }
  }

  const int start = starts[b] < 0 ? 0 : starts[b];
  const int cap = max_pages * ps;
  const int len = start + rows < cap ? start + rows : cap;  // positions read
  const int n_pages = (len + ps - 1) / ps;
  for (int i = threadIdx.x; i < n_pages; i += blockDim.x) {
    const int pid = table[(size_t)b * max_pages + i];
    sm_table[i] = pid < 0 ? 0 : (pid >= P ? P - 1 : pid);
  }
  __syncthreads();
  // a power-of-two page size (the usual case) resolves positions by shifts
  const int shift = (ps & (ps - 1)) == 0 ? __ffs(ps) - 1 : -1;

  float m[R], l[R], acc[R][kVec];
#pragma unroll
  for (int t = 0; t < R; ++t) {
    m[t] = kNegInf;
    l[t] = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[t][i] = 0.f;
  }

  // (page, kv-head) blocks of ps rows of D elements; this lane's column offset
  const size_t head_off = (size_t)kvh * ps * D + sub * kVec;
  // The loop bound is uniform across the warp (every lane sees the same
  // base), so the shuffles below always run with all 32 lanes.
  for (int base = warp * kRowsPerWarp; base < len; base += kStates * kUnroll) {
    // All 2 * kUnroll loads are issued before any is used: a lane past the
    // length reads position 0 (always mapped) instead of branching, so no
    // load waits behind another's conversion; its values are masked below.
    uint4 kraw[kUnroll], vraw[kUnroll];
    int pos[kUnroll];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      pos[u] = base + u * kStates + grp;
      valid[u] = pos[u] < len;
      const int p = valid[u] ? pos[u] : 0;
      const int idx = shift >= 0 ? p >> shift : p / ps;
      const size_t off = (size_t)sm_table[idx] * KV * ps * D + head_off +
                         (size_t)(p - idx * ps) * D;
      kraw[u] = *reinterpret_cast<const uint4*>(k + off);
      vraw[u] = *reinterpret_cast<const uint4*>(v + off);
    }
    float kf[kUnroll][kVec], vf[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      unpack_vec<T>(kraw[u], kf[u]);
      unpack_vec<T>(vraw[u], vf[u]);
    }
#pragma unroll
    for (int t = 0; t < R; ++t) {
      if (t >= rows) break;  // uniform across the block
      const int limit = start + t;  // row t sees positions <= limit
      float s[kUnroll];
      bool live[kUnroll];
      float m_new = m[t];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < kVec; ++i) dot += qf[t][i] * kf[u][i];
#pragma unroll
        for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[u] = dot * scale + slope * (float)(pos[u] - limit);
        live[u] = valid[u] && pos[u] <= limit;
        if (live[u]) m_new = fmaxf(m_new, s[u]);
      }
      const float alpha = expf(m[t] - m_new);
      l[t] *= alpha;
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[t][i] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!live[u]) continue;
        const float p = expf(s[u] - m_new);
        l[t] += p;
        const float pr = round_through<T>(p);
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[t][i] += pr * vf[u][i];
      }
      m[t] = m_new;
    }
  }

  // Merge the kStates partial states of each query row in turn. Position 0 is
  // visible to every row, so some state of each row holds a finite max.
#pragma unroll
  for (int t = 0; t < R; ++t) {
    if (t >= rows) break;  // uniform across the block
    if (sub == 0) {
      sm_m[state] = m[t];
      sm_l[state] = l[t];
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) sm_acc[state][sub * kVec + i] = acc[t][i];
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
      out[((size_t)(b * rows + t) * H + h) * D + d] = from_float<T>(o / fmaxf(tot, 1e-30f));
    }
    __syncthreads();
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* table,
                   const int* starts, const float* slopes, void* out, int B, int rows,
                   int H, int KV, int P, int ps, int max_pages, float scale,
                   cudaStream_t stream) {
  const size_t smem = (size_t)max_pages * sizeof(int);
  const dim3 grid(B * H), block(kWarps * 32);
  if (rows == 1) {
    paged_decode_kernel<T, D, 1><<<grid, block, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        table, starts, slopes, static_cast<T*>(out), rows, H, KV, P, ps, max_pages,
        scale);
  } else {
    paged_decode_kernel<T, D, kMaxRows><<<grid, block, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        table, starts, slopes, static_cast<T*>(out), rows, H, KV, P, ps, max_pages,
        scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int D, const void* q, const void* k, const void* v,
                       const int* table, const int* starts, const float* slopes,
                       void* out, int B, int rows, int H, int KV, int P, int ps,
                       int max_pages, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, table, starts, slopes, out, B, rows, H, KV, P, ps, max_pages, scale, stream);
    case 64: return launch<T, 64>(q, k, v, table, starts, slopes, out, B, rows, H, KV, P, ps, max_pages, scale, stream);
    case 128: return launch<T, 128>(q, k, v, table, starts, slopes, out, B, rows, H, KV, P, ps, max_pages, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------- int8 pages
template <typename T, int D, int R>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                         const int8_t* __restrict__ v, const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale, const int* __restrict__ table,
                         const int* __restrict__ starts, const float* __restrict__ slopes,
                         T* __restrict__ out, int rows, int H, int KV, int P, int ps,
                         int max_pages, float scale) {
  constexpr int kLanesPerRow = D / 16;
  static_assert(D % 16 == 0 && 32 % kLanesPerRow == 0, "unsupported head dim");
  constexpr int kRowsPerWarp = 32 / kLanesPerRow;
  constexpr int kStates = kWarps * kRowsPerWarp;  // also positions per sweep
  constexpr int kUnroll = R == 1 ? 4 : 2;

  extern __shared__ int sm_table[];
  __shared__ float sm_m[kStates];
  __shared__ float sm_l[kStates];
  __shared__ float sm_acc[kStates][D];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / kLanesPerRow, sub = lane % kLanesPerRow;
  const int state = warp * kRowsPerWarp + grp;

  // the query rows sit in shared memory: at 16 elements a lane, R = 8 rows
  // in registers beside their 8 accumulators would spill
  __shared__ float sm_q[R][D];
  const float slope = slopes != nullptr ? slopes[h] : 0.f;
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x)
    sm_q[i / D][i % D] = to_float(q[((size_t)(b * rows + i / D) * H + h) * D + i % D]);

  const int start = starts[b] < 0 ? 0 : starts[b];
  const int cap = max_pages * ps;
  const int len = start + rows < cap ? start + rows : cap;
  const int n_pages = (len + ps - 1) / ps;
  for (int i = threadIdx.x; i < n_pages; i += blockDim.x) {
    const int pid = table[(size_t)b * max_pages + i];
    sm_table[i] = pid < 0 ? 0 : (pid >= P ? P - 1 : pid);
  }
  __syncthreads();
  const int shift = (ps & (ps - 1)) == 0 ? __ffs(ps) - 1 : -1;

  float m[R], l[R], acc[R][16];
#pragma unroll
  for (int t = 0; t < R; ++t) {
    m[t] = kNegInf;
    l[t] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[t][i] = 0.f;
  }

  // (page, kv-head) blocks of ps rows: row index of position 0 of the head
  const size_t head_row = (size_t)kvh * ps;
  for (int base = warp * kRowsPerWarp; base < len; base += kStates * kUnroll) {
    uint4 kraw[kUnroll], vraw[kUnroll];
    float ks[kUnroll], vs[kUnroll];
    int pos[kUnroll];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      pos[u] = base + u * kStates + grp;
      valid[u] = pos[u] < len;
      const int p = valid[u] ? pos[u] : 0;
      const int idx = shift >= 0 ? p >> shift : p / ps;
      const size_t row = (size_t)sm_table[idx] * KV * ps + head_row + (p - idx * ps);
      kraw[u] = *reinterpret_cast<const uint4*>(k + row * D + sub * 16);
      vraw[u] = *reinterpret_cast<const uint4*>(v + row * D + sub * 16);
      ks[u] = k_scale[row];
      vs[u] = v_scale[row];
    }
    float kf[kUnroll][16];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) unpack_i8x16(kraw[u], kf[u]);
#pragma unroll
    for (int t = 0; t < R; ++t) {
      if (t >= rows) break;  // uniform across the block
      const int limit = start + t;
      float s[kUnroll];
      bool live[kUnroll];
      float m_new = m[t];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) dot += sm_q[t][sub * 16 + i] * kf[u][i];
#pragma unroll
        for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[u] = dot * scale * ks[u] + slope * (float)(pos[u] - limit);
        live[u] = valid[u] && pos[u] <= limit;
        if (live[u]) m_new = fmaxf(m_new, s[u]);
      }
      const float alpha = expf(m[t] - m_new);
      l[t] *= alpha;
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[t][i] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!live[u]) continue;
        const float p = expf(s[u] - m_new);
        l[t] += p;
        const float pr = round_p_int8<T>(p * vs[u]);
        float vf[16];
        unpack_i8x16(vraw[u], vf);
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[t][i] += pr * vf[i];
      }
      m[t] = m_new;
    }
  }

#pragma unroll
  for (int t = 0; t < R; ++t) {
    if (t >= rows) break;  // uniform across the block
    if (sub == 0) {
      sm_m[state] = m[t];
      sm_l[state] = l[t];
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) sm_acc[state][sub * 16 + i] = acc[t][i];
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
      out[((size_t)(b * rows + t) * H + h) * D + d] = from_float<T>(o / fmaxf(tot, 1e-30f));
    }
    __syncthreads();
  }
}

template <typename T, int D>
cudaError_t launch_int8(const void* q, const void* k, const void* v, const float* ks,
                        const float* vs, const int* table, const int* starts,
                        const float* slopes, void* out, int B, int rows, int H, int KV,
                        int P, int ps, int max_pages, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)max_pages * sizeof(int);
  const dim3 grid(B * H), block(kWarps * 32);
  const T* qt = static_cast<const T*>(q);
  const int8_t* kt = static_cast<const int8_t*>(k);
  const int8_t* vt = static_cast<const int8_t*>(v);
  T* o = static_cast<T*>(out);
  if (rows == 1) {
    paged_decode_int8_kernel<T, D, 1><<<grid, block, smem, stream>>>(
        qt, kt, vt, ks, vs, table, starts, slopes, o, rows, H, KV, P, ps, max_pages, scale);
  } else {
    paged_decode_int8_kernel<T, D, kMaxRows><<<grid, block, smem, stream>>>(
        qt, kt, vt, ks, vs, table, starts, slopes, o, rows, H, KV, P, ps, max_pages, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_int8_dim(int D, const void* q, const void* k, const void* v,
                            const float* ks, const float* vs, const int* table,
                            const int* starts, const float* slopes, void* out, int B,
                            int rows, int H, int KV, int P, int ps, int max_pages,
                            float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_int8<T, 32>(q, k, v, ks, vs, table, starts, slopes, out, B, rows, H, KV, P, ps, max_pages, scale, stream);
    case 64: return launch_int8<T, 64>(q, k, v, ks, vs, table, starts, slopes, out, B, rows, H, KV, P, ps, max_pages, scale, stream);
    case 128: return launch_int8<T, 128>(q, k, v, ks, vs, table, starts, slopes, out, B, rows, H, KV, P, ps, max_pages, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dstorch

// C entry point of the int8-page variant, bound with ctypes. q and out are in
// dtype; pages are int8 and scale pages fp32. Returns cudaGetLastError().
extern "C" int dstorch_paged_decode_attention_int8(
    int dtype, const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* table, const void* starts, const void* slopes,
    void* out, int B, int T, int H, int KV, int P, int ps, int max_pages, int D,
    float scale, void* stream) {
  using namespace dstorch;
  if (B <= 0 || T < 1 || T > kMaxRows || H <= 0 || KV <= 0 || H % KV != 0 || P <= 0 ||
      ps <= 0 || max_pages <= 0)
    return (int)cudaErrorInvalidValue;
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tbl = static_cast<const int*>(table);
  const int* st = static_cast<const int*>(starts);
  const float* sl = static_cast<const float*>(slopes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return (int)launch_int8_dim<float>(D, q, k, v, ks, vs, tbl, st, sl, out, B, T, H, KV, P, ps, max_pages, scale, s);
    case kBFloat16: return (int)launch_int8_dim<__nv_bfloat16>(D, q, k, v, ks, vs, tbl, st, sl, out, B, T, H, KV, P, ps, max_pages, scale, s);
    case kFloat16: return (int)launch_int8_dim<__half>(D, q, k, v, ks, vs, tbl, st, sl, out, B, T, H, KV, P, ps, max_pages, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// C entry point bound with ctypes. Returns the launch's cudaGetLastError().
extern "C" int dstorch_paged_decode_attention(int dtype, const void* q, const void* k,
                                              const void* v, const void* table,
                                              const void* starts, const void* slopes,
                                              void* out, int B, int T, int H, int KV,
                                              int P, int ps, int max_pages, int D,
                                              float scale, void* stream) {
  using namespace dstorch;
  if (B <= 0 || T < 1 || T > kMaxRows || H <= 0 || KV <= 0 || H % KV != 0 || P <= 0 ||
      ps <= 0 || max_pages <= 0)
    return (int)cudaErrorInvalidValue;
  const int* tbl = static_cast<const int*>(table);
  const int* st = static_cast<const int*>(starts);
  const float* sl = static_cast<const float*>(slopes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return (int)launch_dim<float>(D, q, k, v, tbl, st, sl, out, B, T, H, KV, P, ps, max_pages, scale, s);
    case kBFloat16: return (int)launch_dim<__nv_bfloat16>(D, q, k, v, tbl, st, sl, out, B, T, H, KV, P, ps, max_pages, scale, s);
    case kFloat16: return (int)launch_dim<__half>(D, q, k, v, tbl, st, sl, out, B, T, H, KV, P, ps, max_pages, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
