// Cached attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/attention/paged_attention.py::
// paged_decode_attention (pallas_call at :247, kernel body _paged_kernel at :58),
// both of its page types. Each slot b has 1 <= T <= 8 query rows (plain decode
// T = 1; speculative verify T = K + 1). Row t sits at absolute position
// starts[b] + t and attends the cache positions [0, starts[b] + t]:
// softmax(q . K^T * scale + slope * (pos - (starts[b] + t))) . V, with
// grouped-query heads mapped h -> h / (H / KV), fp32 statistics and the
// probabilities rounded to the page dtype before the PV product; int8 pages
// carry fp32 scale pages, one scale per cached row (the K scale multiplies the
// score, the V scale the probability).
//
// Layout: q (B, T, H, D); K/V one layer's page pool (P, KV, page_size, D),
// positions-major inside a page (each cache row is D contiguous elements), in
// q's dtype or int8 with scale pages (P, KV, page_size) fp32; table
// (B, max_pages) int32, where position p of slot b lives in page
// table[b, p / page_size], row p % page_size; starts (B,) int32, the cache
// length before this step's T rows (which the caller has already written);
// optional ALiBi slopes (H,) fp32; out (B, T, H, D).
//
// The kernel is the contiguous decode kernel's (decode_sm90.cuh: one block of
// 4 warps per (slot, KV head, tile of 16 (query row, query head) pairs,
// S-chunk), mma.sync or FMA, split S merged in chunk order; its header says
// what bounds it and how the design answers) with the rows of this file's
// source: the page table, as the JAX kernel mirrors its dense decode kernel
// but for the index map and the per-row limits. Each block stages the page
// ids its chunk touches, at most ceil(chunk / page_size) + 1, in shared
// memory (this replaces the TPU's scalar prefetch of the table). With pages
// of a power of two of at least 16 positions a 16-position group lies in one
// page, whose row the block looks up once a group by a shift; otherwise it
// resolves the page of every 16-byte piece's row on its own, so a group may
// cross a page boundary of any page size.
//
// Page ids are never trusted: an entry below 0 reads page 0, and the
// unmapped sentinel P (or any id past it) reads page P - 1. Such a page is
// only ever reached past a slot's live length (a free slot's table is all
// sentinels and its one visible position is 0 of page P - 1, as in the JAX
// kernel), and every read past a row's limit is masked, so nothing else of
// it reaches the output.
#include "decode_sm90.cuh"

namespace dstorch {
namespace {

// page ids one block may stage: 64 KB beside the largest ring (fp32 at
// D = 128, 148 KB) within the 227 KB of a block; paged_attention.py's
// MAX_TABLE_PAGES
constexpr int kMaxStagedPages = 16384;

// The paged pool: position p of slot b at row (page * KV + kv head) * ps +
// p % ps of the pool, page = table[b, p / ps] clipped to [0, P - 1]; query
// row 0 of slot b at position max(starts[b], 0). kWhole: ps is a power of two
// of at least 16, so a group's 16 positions (from a multiple of 16) share a
// page, found by a shift (a division, or a choice between the two, would add
// a branch and its instructions to every step of the walk).
template <bool kWhole_>
struct PagedRows {
  const int* table;
  const int* starts;
  int P, ps, max_pages;
  static constexpr bool kTable = true;
  static constexpr bool kOneRow = false;
  static constexpr int kMaxTableBytes = kMaxStagedPages * 4;
  struct Block {
    static constexpr bool kWhole = kWhole_;
    const int* ids;  // the staged ids: entry 0 is the table's entry `first`
    int first, ps, shift;
    size_t page_rows, head_row;  // KV * ps rows a page; kv head * ps
    __device__ size_t row(int p) const {
      int idx;
      if constexpr (kWhole)
        idx = p >> shift;
      else
        idx = shift >= 0 ? p >> shift : p / ps;
      return (size_t)ids[idx - first] * page_rows + head_row + (p - idx * ps);
    }
  };
  __host__ __device__ int capacity() const { return max_pages * ps; }
  // the entries a chunk of `chunk` positions touches, at most
  int staged(int chunk) const { return (chunk + ps - 1) / ps + 1; }
  int table_bytes(int chunk) const { return (staged(chunk) * 4 + 15) / 16 * 16; }
  __device__ int start(int b) const { return max(starts[b], 0); }
  // stage the clipped ids of the pages of positions [c0, c0 + chunk) below
  // the capacity (every thread takes part; the kernel syncs after). They do
  // not depend on the slot's start, so their loads go out beside its load.
  __device__ Block block(int b, int kvh, int KV, int c0, int chunk, int* ids) const {
    const int shift = (ps & (ps - 1)) == 0 ? __ffs(ps) - 1 : -1;
    const int first = shift >= 0 ? c0 >> shift : c0 / ps;
    const int end = min(c0 + chunk, max_pages * ps) - 1;
    const int last = shift >= 0 ? end >> shift : end / ps;
    const int* entries = table + (size_t)b * max_pages + first;
    for (int i = threadIdx.x; i <= last - first; i += blockDim.x) {
      const int pid = entries[i];
      ids[i] = pid < 0 ? 0 : (pid >= P ? P - 1 : pid);
    }
    return {ids, first, ps, shift, (size_t)KV * ps, (size_t)kvh * ps};
  }
};

int paged_dispatch(int dtype, int design, bool quantized, const dstorch::decode::Args& a,
                   const int* table, const int* starts, int P, int ps, int max_pages,
                   void* stream) {
  if (P <= 0 || ps <= 0 || max_pages <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((ps & (ps - 1)) == 0 && ps >= 16)
    return (int)decode::dispatch(dtype, design, quantized, a,
                                 PagedRows<true>{table, starts, P, ps, max_pages}, st);
  return (int)decode::dispatch(dtype, design, quantized, a,
                               PagedRows<false>{table, starts, P, ps, max_pages}, st);
}

}  // namespace
}  // namespace dstorch

// C entry points bound with ctypes; each returns its launches'
// cudaGetLastError(). design: paged_attention.py's design (decode_design: 0
// FMA, 1 mma.sync); splits and chunk: its paged_plan (chunks of `chunk`
// positions, a multiple of 64, over max_pages * ps); partials: fp32 scratch
// of B * T * H * splits * (2 + D) for splits > 1.
extern "C" int dstorch_paged_decode_attention(int dtype, int design, const void* q,
                                              const void* k, const void* v, const void* table,
                                              const void* starts, const void* slopes, void* out,
                                              void* partials, int B, int T, int H, int KV, int P,
                                              int ps, int max_pages, int D, int splits, int chunk,
                                              float scale, void* stream) {
  const dstorch::decode::Args a{q, k, v, nullptr, nullptr, static_cast<const float*>(slopes),
                                out, static_cast<float*>(partials), B, T, H, KV, D, splits,
                                chunk, scale};
  return dstorch::paged_dispatch(dtype, design, false, a, static_cast<const int*>(table),
                                 static_cast<const int*>(starts), P, ps, max_pages, stream);
}

// int8 pages: q and out in dtype, pages int8, scale pages fp32 (P, KV, ps).
extern "C" int dstorch_paged_decode_attention_int8(
    int dtype, int design, const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* table, const void* starts, const void* slopes, void* out,
    void* partials, int B, int T, int H, int KV, int P, int ps, int max_pages, int D, int splits,
    int chunk, float scale, void* stream) {
  const dstorch::decode::Args a{q, k, v, static_cast<const float*>(k_scale),
                                static_cast<const float*>(v_scale),
                                static_cast<const float*>(slopes), out,
                                static_cast<float*>(partials), B, T, H, KV, D, splits, chunk,
                                scale};
  return dstorch::paged_dispatch(dtype, design, true, a, static_cast<const int*>(table),
                                 static_cast<const int*>(starts), P, ps, max_pages, stream);
}
