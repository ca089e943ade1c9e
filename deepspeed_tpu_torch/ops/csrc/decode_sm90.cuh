// The cached-attention kernel that decode_attention.cu (a contiguous cache)
// and paged_decode_attention.cu (a paged pool read through its page table)
// instantiate, for Hopper (sm_90a). One template for both cache types (the
// query dtype, or int8 with fp32 per-row scales) and both designs; the two
// sources differ only in where a cache row lies (a Src policy, below) and in
// their C entries.
//
// What it computes: for slot b, each of its T query rows t (T = 1 for plain
// decode, up to kMaxSlotRows for speculative verify) and each query head h,
// softmax(q . K^T * scale + slope_h * (pos - limit)) . V over the cache
// positions pos <= limit = start_b + t, with grouped-query heads mapped
// h -> h / (H / KV) and fp32 statistics. A cache in the query dtype rounds p
// to that dtype before the PV product; an int8 cache (the TPU kernels'
// k_scale/v_scale branch) carries fp32 scales per cached row: the K scale
// multiplies the score and the V scale the probability, so no row is
// dequantized, and the scaled probability is rounded to bf16 for bf16
// queries (kept to fp32 for fp32 and fp16 queries) before the PV product.
//
// Layout: q and out (B, T, H, D); a cache row is D contiguous elements, row
// Src::Block::row(p) of the K and V pools (and of the scale pools) for
// position p; optional ALiBi slopes (H,) fp32.
//
// What bounds it on the H100: bytes. Each step reads every live K and V row
// once per KV head and does 4 * D flops per (query row, position): at most
// T * g flops a byte (g = H / KV), far below the ~295 flop/byte ridge. What
// costs time at the serving shapes is latency: one SM streams a slot's rows
// at a rate of its own (a few tens of GB/s on the H100), TinyLlama has 32
// (slot, KV head) groups for 132 SMs at 8 slots, and every block and launch
// costs fixed time. So the design spreads the groups over the card:
//  - one block of 4 warps per (slot, KV head, row tile, S-chunk): the A rows
//    of the tile are the T * g (query row, query head) pairs of the KV head,
//    16 to a tile (zero past the end), and the block computes all of them
//    against each cache row it reads, so a row (and its scales) is read once
//    a tile, not once a query head (at T = 1 one tile holds g <= 16 heads);
//  - split S (flash-decoding): the wrappers' decode_plan / paged_plan pick
//    the chunk from the shapes only, never from the lengths or starts, which
//    live on the device (reading them would sync the host and could not be
//    captured in a CUDA graph). A chunk at or past the tile's last visible
//    position loads nothing and leaves the empty state (m = -inf, l = 0);
//  - each A row keeps its own limit start_b + t (and its ALiBi slope and
//    distance): a position past it scores -inf before the max and gets p = 0;
//  - each warp takes 16-position groups of its chunk in turn through its own
//    ring of cp.async stages in shared memory, row-major with the 16-byte
//    pieces of each row permuted so that neither the copies nor the lanes'
//    fragment reads meet a bank conflict (a layout in the lanes' read order
//    made the copies conflict, and streamed slower: PERF.md), so later rows
//    are in flight while the current ones are multiplied. A group whose 16
//    rows lie together (a contiguous cache, pages of a power of two of at
//    least 16 positions) looks up its first row once, a step ahead; otherwise each
//    piece's row is resolved on its own (Src::Block::row), so a group may
//    cross a page boundary of any page size;
//  - each block merges its 4 warps' (max, sum, acc) states in warp order; with
//    one chunk it writes the output, with more it writes its state to fp32
//    partials (the wrapper's scratch) and decode_combine merges a row's
//    chunks in chunk order: the same result from run to run, and a row whose
//    every chunk is empty gets 0 (max(l, 1e-30)). The combine kernel costs a
//    launch; the other way, a thread-block cluster per group merged through
//    distributed shared memory, cost more on the H100 the more clusters a
//    launch had (PERF.md).
// Two designs, picked by decode_attention.py's decode_design:
//  - "mma" (design 1), bf16 and fp16 queries at D = 64 and 128: both products
//    on the tensor cores with mma.sync m16n8k16, fp32 accumulators. S = Q K^T
//    takes K as B, and P, packed from S's accumulators, is the A operand of
//    O += P V. The order of the head dim inside each 64-wide slice is
//    permuted (the sum does not care; Q and K use the same order), and so are
//    the positions of a group and the output columns, so that every operand
//    comes from one contiguous read per lane: K rows as they lie, V pairs of
//    positions built by byte permutes. An int8 K or V row converts to 16-bit
//    in registers, exactly (every int8 value is a bf16 and an fp16 number), so
//    the rounding points stay the TPU kernels'; fp16 queries over an int8
//    cache feed p * v_scale as a bf16 pair hi + lo (16 significant bits), for
//    fp32-like probabilities.
//  - "fma" (design 0), every dtype at D = 32, 64, 128 (fp32 queries, whose
//    tolerance bf16 operands miss, and D = 32): the same grid, ring and merge,
//    the products on the FMA units from fp32 q and padded row-major stages.
//
// A Src policy gives, on the device: start(b), the position of query row 0
// of slot b (-1: the slot has none); capacity(), the positions a slot can
// hold; block(b, kvh, KV, c0, chunk, staged), a Block whose row(p) is the
// pool row of position p in [c0, c0 + chunk) of KV head kvh below the slot's
// capacity (it may stage what it needs in `staged`, shared memory past the
// kernel's own, behind one __syncthreads when kTable) and whose kWhole says
// that the 16 positions of every group from p0 = c0 + 16 i lie in rows
// row(p0) .. row(p0) + 15; kOneRow, that T is 1; on the host:
// table_bytes(chunk), the bytes it stages, at most kMaxTableBytes.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "flash_sm90.cuh"
#include "wgmma.cuh"

namespace dstorch {
namespace decode {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;       // A rows a block takes: the mma tile's rows
constexpr int kGroup = 16;      // positions a warp takes at a time
constexpr int kMaxSplits = 16;
constexpr int kMaxSlotRows = 8;  // MAX_QUERY_ROWS in ops/attention/paged_attention.py

struct Args {
  const void *q, *k, *v;
  const float *k_scale, *v_scale;  // int8 cache only
  const float* slopes;             // nullptr: no ALiBi
  void* out;
  float* partials;  // splits > 1: (B * T * H, splits, 2 + D) fp32 (m, l, acc)
  int B, T, H, KV, D, splits, chunk;
  float scale;
};

// Shared memory of one block. Each warp owns kStages stages of one group:
// its K rows, its V rows and (int8) the group's 16 K then 16 V scales. After
// the walk the same bytes hold the 4 warps' states (m, l, acc of 16 rows),
// then come (FMA) the fp32 query rows, each warp's 16 x 16 scores and 16
// factors, and the rows' limits and ALiBi slopes; then what the Src stages.
template <typename Cache, int D, bool kMma>
struct Cfg {
  static constexpr bool kQuant = std::is_same<Cache, int8_t>::value;
  static constexpr int kRowBytes = D * (int)sizeof(Cache);
  // FMA rows are padded by 16 bytes: 8 lanes reading one column of 8 rows
  // hit 8 banks
  static constexpr int kLd = kRowBytes + (kMma ? 0 : 16);
  static constexpr int kRowsBytes = kGroup * kLd;  // a group's K rows (V the same)
  static constexpr int kStageBytes = 2 * kRowsBytes + (kQuant ? 2 * kGroup * 4 : 0);
  // 2 to 8 stages in about 16 KB a warp: a warp's step waits for a DRAM
  // round trip unless kStages - 1 steps cover it (8 warps, or 32 KB a warp,
  // were no faster on the H100)
  static constexpr int kBudget = 16896 / kStageBytes;
  static constexpr int kStages = kBudget > 8 ? 8 : (kBudget < 2 ? 2 : kBudget);
  static constexpr int kRing = kWarps * kStages * kStageBytes;
  static constexpr int kStateFloats = 2 * kRows + kRows * D;
  static constexpr int kStates = kWarps * kStateFloats * 4;
  static constexpr int kData = kRing > kStates ? kRing : kStates;
  static constexpr int kWarpFma = (kRows * kGroup + kRows) * 4;
  static constexpr int kSmem =
      kData + (kMma ? 0 : kRows * D * 4 + kWarps * kWarpFma + 2 * kRows * 4);
};

// ------------------------------------------------------------------ helpers
// Element i of a cached row in shared memory, as a float.
template <typename Cache>
__device__ __forceinline__ float elem(const unsigned char* row, int i) {
  if constexpr (std::is_same<Cache, int8_t>::value)
    return (float)reinterpret_cast<const int8_t*>(row)[i];
  else
    return to_float(reinterpret_cast<const Cache*>(row)[i]);
}

// The 16 / sizeof(Cache) elements of a 16-byte word of a cached row, as floats.
template <typename Cache>
__device__ __forceinline__ void unpack16(uint4 raw, float* dst) {
  if constexpr (std::is_same<Cache, int8_t>::value)
    unpack_i8x16(raw, dst);
  else
    unpack_vec<Cache>(raw, dst);
}

// Where the mma design's stage keeps 16-byte piece c of row r (0..15) of a
// group: row-major, so that the copies of a warp fill whole 128-byte lines
// (no bank conflict), with the pieces of each line permuted by a per-row XOR
// so that the lanes' fragment reads meet no conflict either. The 16 rows are
// the two 8-position n-tiles of S = Q K^T: tile j = (r >> 1) & 1, column gg =
// 2 (r >> 2) + (r & 1), so lane (gg, t) of tile j holds position 4t + 2j + e
// at its accumulator column 2t + e. K: lane 4gg + t reads physical dims 16t
// .. 16t + 15 of each 64-wide slice of row 4 (gg >> 1) + 2j + (gg & 1), the
// lanes of a read two rows that differ in bit 0. V: lane 4gg + t reads D / 8
// dims from (D / 8) gg of rows 4t .. 4t + 3, the lanes of a read four rows
// 4t + i. 16-bit rows: bit 0 of the XOR from bit 0 of the row, bits 1-2 from
// bits 2-3 (at D = 128 a V read of two 16-dim pieces meets a 2-way
// conflict). int8 at D = 64 (two rows a line): bits 1-2 from bits 2-3 of the
// row; at D = 128: bit 2 from bit 0, bits 1-2 from bits 2-3.
template <typename Cache, int D>
__device__ __forceinline__ int slot(int r, int c) {
  constexpr int kPer = D * (int)sizeof(Cache) / 16;  // pieces a row
  int swz = ((r >> 2) & 3) << 1;
  if constexpr (!std::is_same<Cache, int8_t>::value)
    swz |= r & 1;
  else if constexpr (D == 128)
    swz ^= (r & 1) << 2;
  const int e = r * kPer + c;
  return (e >> 3) * 128 + (((e & 7) ^ swz) << 4);
}

// ------------------------------------------------------------------ kernel
template <typename T, typename Cache, int D, bool kMma, typename Src>
__global__ void __launch_bounds__(kThreads) decode_kernel(const Args a, const Src src) {
  using C = Cfg<Cache, D, kMma>;
  constexpr bool kQuant = C::kQuant;
  constexpr int kS = C::kStages;
  extern __shared__ __align__(16) unsigned char smem[];

  const int split = blockIdx.x;
  const int g = a.H / a.KV, pairs = a.T * g, tiles = (pairs + kRows - 1) / kRows;
  const int tile = blockIdx.y % tiles, bkv = blockIdx.y / tiles;  // bkv = b * KV + kv head
  const int b = bkv / a.KV, kvh = bkv % a.KV;
  const int r0 = tile * kRows;                 // (query row, head) pair of A row 0
  const int gh = min(kRows, pairs - r0);       // the tile's live A rows
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // A row r is pair r0 + r: query row (r0 + r) / g of slot b, query head
  // kvh * g + (r0 + r) % g; its row of q and out (of B * T * H), and its
  // last visible position, start + its query row
  auto flat = [&](int r) {
    const int pr = r0 + r, t = Src::kOneRow || a.T == 1 ? 0 : pr / g;
    return (b * a.T + t) * a.H + kvh * g + pr - t * g;
  };
  const int c0 = split * a.chunk;
  // the source's own loads (the slot's start; the page ids of the chunk, into
  // `staged` past the kernel's shared memory) go out together, first
  const int start = src.start(b);
  const typename Src::Block rows =
      src.block(b, kvh, a.KV, c0, a.chunk, reinterpret_cast<int*>(smem + C::kSmem));
  // the positions the tile reads: up to its last row's limit
  const int len = max(0, min(start + (a.T == 1 ? 0 : (r0 + gh - 1) / g) + 1, src.capacity()));
  const int live = max(0, min(a.chunk, len - c0));  // positions of this chunk below len
  const int groups = (live + kGroup - 1) / kGroup;
  const int mine = groups > warp ? (groups - warp + kWarps - 1) / kWarps : 0;
  if (live == 0) {  // an empty chunk: no loads; its state is m = -inf (one chunk: out 0)
    T* out = static_cast<T*>(a.out);
    for (int x = threadIdx.x; x < gh * (a.splits == 1 ? D : 1); x += kThreads) {
      if (a.splits == 1)
        out[(size_t)flat(x / D) * D + x % D] = from_float<T>(0.f);
      else
        a.partials[((size_t)flat(x) * a.splits + split) * (2 + D)] = kNegInf;
    }
    return;
  }
  const float scale2 = a.scale * attn::kLog2e;
  const T* q = static_cast<const T*>(a.q);
  unsigned char* ring = smem + warp * kS * C::kStageBytes;
  float* qf = reinterpret_cast<float*>(smem + C::kData);  // FMA: the rows' queries in fp32
  float* sp = qf + kRows * D + warp * (C::kWarpFma / 4);  // FMA: this warp's scores, factors
  int* row_lim = reinterpret_cast<int*>(qf + kRows * D + kWarps * (C::kWarpFma / 4));
  float* row_slope = reinterpret_cast<float*>(row_lim + kRows);  // FMA: per A row
  // the last visible position (at most len - 1; -1 past the tile's rows) and
  // the ALiBi slope (base 2) of A row r
  auto limit_of = [&](int r) {
    return r < gh ? min(start + (a.T == 1 ? 0 : (r0 + r) / g), len - 1) : -1;
  };
  auto slope_of = [&](int r) {
    return a.slopes != nullptr && r < gh ? a.slopes[kvh * g + (r0 + r) % g] * attn::kLog2e : 0.f;
  };
  if constexpr (!kMma) {
    for (int e = threadIdx.x; e < kRows * D; e += kThreads)
      qf[e] = e / D < gh ? to_float(q[(size_t)flat(e / D) * D + e % D]) : 0.f;
    if (threadIdx.x < kRows) {
      row_lim[threadIdx.x] = limit_of(threadIdx.x);
      row_slope[threadIdx.x] = slope_of(threadIdx.x);
    }
  }
  if constexpr (!kMma || Src::kTable) __syncthreads();

  // the lane's 16-byte pieces of a group's K and V rows: row, byte offset in
  // the row, and places in the stage (the same for every group)
  constexpr int kPieces = C::kRowBytes / 16;
  constexpr int kMine = kGroup * kPieces / 32;
  int piece_row[kMine], piece_col[kMine], piece_k[kMine], piece_v[kMine];
#pragma unroll
  for (int x = 0; x < kMine; ++x) {
    const int e = lane + 32 * x, r = e / kPieces, c = e % kPieces;
    piece_row[x] = r;
    piece_col[x] = c * 16;
    if constexpr (kMma) {
      piece_k[x] = slot<Cache, D>(r, c);
      piece_v[x] = C::kRowsBytes + piece_k[x];
    } else {
      piece_k[x] = r * C::kLd + c * 16;
      piece_v[x] = C::kRowsBytes + piece_k[x];
    }
  }
  const char* k_pool = static_cast<const char*>(a.k);
  const char* v_pool = static_cast<const char*>(a.v);

  // group gi of the chunk (positions c0 + 16 gi ..) into `stage`; rows past
  // len arrive as zeros. When the source keeps every 16-position group in
  // one run of rows (a contiguous cache, or pages of a power of two of at
  // least 16 positions), `base` is the row of the group's first position, looked up
  // before the step whose end issues the load (its shared-memory read then
  // waits behind the step's products, not in front of the copies);
  // otherwise each piece's row is resolved on its own, so a group may cross
  // a page boundary
  auto group_base = [&](int gi) {
    if constexpr (Src::Block::kWhole)
      return rows.row(c0 + kGroup * gi);
    else
      return (size_t)0;
  };
  auto load_group = [&](int gi, int stage, size_t base) {
    const uint32_t st = sm90::smem_u32(ring + stage * C::kStageBytes);
    const int p0 = c0 + kGroup * gi;
#pragma unroll
    for (int x = 0; x < kMine; ++x) {
      const int p = p0 + piece_row[x];
      const bool ok = p < len;
      size_t row;
      if constexpr (Src::Block::kWhole)
        row = base + piece_row[x];
      else
        row = ok ? rows.row(p) : 0;
      const size_t src_off = ok ? row * C::kRowBytes + piece_col[x] : 0;
      cp_async16(st + piece_k[x], k_pool + src_off, ok);
      cp_async16(st + piece_v[x], v_pool + src_off, ok);
    }
    if constexpr (kQuant) {  // lanes 0-15: the K scales, 16-31: the V scales
      const int p = p0 + (lane & 15);
      const bool ok = p < len;
      size_t row;
      if constexpr (Src::Block::kWhole)
        row = base + (lane & 15);
      else
        row = ok ? rows.row(p) : 0;
      const float* sc = (lane < 16 ? a.k_scale : a.v_scale) + (ok ? row : 0);
      cp_async4(st + 2 * C::kRowsBytes + lane * 4, sc, ok);
    }
  };

  const int g4 = lane >> 2, t = lane & 3;  // mma: the lane's row and column group
  // mma: the running max (base 2) and this lane's share of the sums of rows
  // g4 and g4 + 8, with their limits and slopes; FMA: row `lane` (< gh) alone
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  int lim[2];
  float slope2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kMma ? g4 + 8 * r : lane;
    // one query row a slot: every row's limit is the tile's last position
    // (rows past gh hold zero queries and are never written), so the
    // masks and ALiBi distances are shared by both rows of a lane
    lim[r] = Src::kOneRow ? len - 1 : limit_of(row);
    slope2[r] = slope_of(row);
  }
  constexpr int kJd = D / 8;  // mma: the n-tiles of O
  float o[kMma ? kJd : 1][4];
  constexpr int kDl = D / 32;  // FMA: the lane's dims lane * kDl ..
  float acc[kMma ? 1 : kRows][kDl];
  uint32_t qa[kMma ? D / 16 : 1][4];  // mma: Q's A fragments, k-step 4 sl + s of slice sl
  if constexpr (kMma) {
#pragma unroll
    for (int jd = 0; jd < kJd; ++jd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[jd][e] = 0.f;
    // lane (g4, t): physical dims 16t .. 16t + 15 of each slice; k-step s
    // takes words 2s (a[0], a[1]) and 2s + 1 (a[2], a[3]) of them
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g4 + 8 * r;
      const T* qrow = q + (row < gh ? (size_t)flat(row) * D : 0);
#pragma unroll
      for (int sl = 0; sl < D / 64; ++sl) {
        uint4 w0 = make_uint4(0, 0, 0, 0), w1 = w0;
        if (row < gh) {
          const uint4* src4 = reinterpret_cast<const uint4*>(qrow + 64 * sl + 16 * t);
          w0 = src4[0];
          w1 = src4[1];
        }
        const uint32_t w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          qa[4 * sl + s][r] = w[2 * s];
          qa[4 * sl + s][2 + r] = w[2 * s + 1];
        }
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < kRows; ++h)
#pragma unroll
      for (int k = 0; k < kDl; ++k) acc[h][k] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < kS; ++s) {
    if (s < mine) load_group(warp + kWarps * s, s, group_base(warp + kWarps * s));
    cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    const int next = warp + kWarps * (i + kS);  // the group this step refills with
    const size_t next_base = i + kS < mine ? group_base(next) : 0;
    cp_async_wait<kS - 1>();  // group i has landed
    __syncwarp();
    const unsigned char* st = ring + (i % kS) * C::kStageBytes;
    const unsigned char* ks = st;
    const unsigned char* vs = st + C::kRowsBytes;
    const float* scales = reinterpret_cast<const float*>(st + 2 * C::kRowsBytes);
    const int p0 = c0 + kGroup * (warp + kWarps * i);

    if constexpr (kMma) {
      // P: the PV product's 16-bit type (bf16 for an int8 cache)
      using P = typename std::conditional<kQuant, __nv_bfloat16, T>::type;
      constexpr bool kSplitP = kQuant && std::is_same<T, __half>::value;
      float sc[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
        for (int sl = 0; sl < D / 64; ++sl) {
          uint32_t bf[8];  // k-step s: bf[2s], bf[2s + 1]
          const int kr = 4 * (g4 >> 1) + 2 * j + (g4 & 1);  // the lane's K row
          if constexpr (kQuant) {
            const uint4 raw = *reinterpret_cast<const uint4*>(ks + slot<Cache, D>(kr, 4 * sl + t));
            const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              bf[2 * s] = i8x2_to<T>(__byte_perm(w[s], 0, 0x4140));
              bf[2 * s + 1] = i8x2_to<T>(__byte_perm(w[s], 0, 0x4342));
            }
          } else {
            const uint4 lo = *reinterpret_cast<const uint4*>(ks + slot<Cache, D>(kr, 8 * sl + 2 * t));
            const uint4 hi =
                *reinterpret_cast<const uint4*>(ks + slot<Cache, D>(kr, 8 * sl + 2 * t + 1));
            const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
            for (int e = 0; e < 8; ++e) bf[e] = w[e];
          }
#pragma unroll
          for (int s = 0; s < 4; ++s) mma_16816<T>(sc[j], qa[4 * sl + s], bf[2 * s], bf[2 * s + 1]);
        }
      }
      // this lane's positions p0 + 4t + 2j + (e & 1) of rows g4 + 8 (e >> 1)
      float ksc[4] = {1.f, 1.f, 1.f, 1.f}, vsc[4] = {1.f, 1.f, 1.f, 1.f};
      if constexpr (kQuant) {
        const float4 k4 = *reinterpret_cast<const float4*>(scales + 4 * t);
        const float4 v4 = *reinterpret_cast<const float4*>(scales + kGroup + 4 * t);
        ksc[0] = k4.x; ksc[1] = k4.y; ksc[2] = k4.z; ksc[3] = k4.w;
        vsc[0] = v4.x; vsc[1] = v4.y; vsc[2] = v4.z; vsc[3] = v4.w;
      }
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pi = 2 * j + (e & 1), pos = p0 + 4 * t + pi, r = e >> 1;
          float x = sc[j][e] * scale2 * ksc[pi] + slope2[r] * (float)(pos - lim[r]);
          sc[j][e] = x = pos <= lim[r] ? x : kNegInf;
          mx[r] = fmaxf(mx[r], x);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // the 4 lanes t of a row
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = attn::exp2_approx(m_run[r] - mx[r]);  // 1 while both are empty
        m_run[r] = mx[r];
      }
      float pv[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pi = 2 * j + (e & 1), r = e >> 1;
          const float p =
              p0 + 4 * t + pi <= lim[r] ? attn::exp2_approx(sc[j][e] - mx[r]) : 0.f;
          sum[r] += p;
          pv[j][e] = p * vsc[pi];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + sum[r];
#pragma unroll
      for (int jd = 0; jd < kJd; ++jd)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[jd][e] *= alpha[e >> 1];
      // P as the A fragment: logical k 2t, 2t + 1 are positions 4t, 4t + 1
      // (n-tile 0), k 2t + 8, 2t + 9 positions 4t + 2, 4t + 3 (n-tile 1)
      uint32_t pa[4], pl[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int j = x >> 1, e = 2 * (x & 1);
        pa[x] = pack2<P>(pv[j][e], pv[j][e + 1]);
        if constexpr (kSplitP) {
          const float2 hi = unpack2<P>(pa[x]);
          pl[x] = pack2<P>(pv[j][e] - hi.x, pv[j][e + 1] - hi.y);
        }
      }
      // V: rows 4t .. 4t + 3 of the group, dims (D / 8) g4 .. as 32-bit words
      constexpr int kW = kJd * (int)sizeof(Cache) / 4;
      uint32_t vw[4][kW];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (kQuant && D == 64) {  // 8 bytes: half a piece
          const uint2 raw =
              *reinterpret_cast<const uint2*>(vs + slot<Cache, D>(4 * t + i, g4 >> 1) + (g4 & 1) * 8);
          vw[i][0] = raw.x;
          vw[i][1] = raw.y;
        } else {
#pragma unroll
          for (int x = 0; x < kW / 4; ++x) {
            const uint4 raw =
                *reinterpret_cast<const uint4*>(vs + slot<Cache, D>(4 * t + i, (kW / 4) * g4 + x));
            vw[i][4 * x] = raw.x;
            vw[i][4 * x + 1] = raw.y;
            vw[i][4 * x + 2] = raw.z;
            vw[i][4 * x + 3] = raw.w;
          }
        }
      }
#pragma unroll
      for (int jd = 0; jd < kJd; ++jd) {
        uint32_t b0, b1;  // (V[4t][dim], V[4t + 1][dim]), (V[4t + 2][dim], V[4t + 3][dim])
        if constexpr (kQuant) {
          const int w = jd >> 2, k = jd & 3, sel = k | ((4 + k) << 8);
          b0 = i8x2_to<P>(__byte_perm(vw[0][w], vw[1][w], sel));
          b1 = i8x2_to<P>(__byte_perm(vw[2][w], vw[3][w], sel));
        } else {
          const int w = jd >> 1, sel = (jd & 1) ? 0x7632 : 0x5410;
          b0 = __byte_perm(vw[0][w], vw[1][w], sel);
          b1 = __byte_perm(vw[2][w], vw[3][w], sel);
        }
        mma_16816<P>(o[jd], pa, b0, b1);
        if constexpr (kSplitP) mma_16816<P>(o[jd], pl, b0, b1);
      }
    } else {
      // scores of (row h, position p) pairs, one pair a lane at a time
      for (int x = lane; x < gh * kGroup; x += 32) {
        const int h = x / kGroup, p = x % kGroup, pos = p0 + p;
        const unsigned char* krow = ks + p * C::kLd;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < C::kRowBytes / 16; ++c) {
          constexpr int kN = 16 / (int)sizeof(Cache);
          float kv[kN];
          unpack16<Cache>(*reinterpret_cast<const uint4*>(krow + c * 16), kv);
          const float* qq = qf + h * D + c * kN;
#pragma unroll
          for (int e = 0; e < kN; ++e) dot += qq[e] * kv[e];
        }
        const float s = dot * scale2 * (kQuant ? scales[p] : 1.f) +
                        row_slope[h] * (float)(pos - row_lim[h]);
        sp[h * kGroup + p] = pos <= row_lim[h] ? s : kNegInf;
      }
      __syncwarp();
      if (lane < gh) {  // lane h: row h's online softmax over the group
        float mx = m_run[0];
        for (int p = 0; p < kGroup; ++p) mx = fmaxf(mx, sp[lane * kGroup + p]);
        const float alpha = attn::exp2_approx(m_run[0] - mx);
        float sum = 0.f;
        for (int p = 0; p < kGroup; ++p) {
          const float pr = p0 + p <= lim[0] ? attn::exp2_approx(sp[lane * kGroup + p] - mx) : 0.f;
          sum += pr;
          if constexpr (kQuant)
            sp[lane * kGroup + p] = round_p_int8<T>(pr * scales[kGroup + p]);
          else
            sp[lane * kGroup + p] = round_through<Cache>(pr);
        }
        l_run[0] = l_run[0] * alpha + sum;
        m_run[0] = mx;
        sp[kRows * kGroup + lane] = alpha;
      }
      __syncwarp();
#pragma unroll
      for (int h = 0; h < kRows; ++h)
        if (h < gh) {
          const float f = sp[kRows * kGroup + h];
#pragma unroll
          for (int k = 0; k < kDl; ++k) acc[h][k] *= f;
        }
#pragma unroll 4
      for (int p = 0; p < kGroup; ++p) {
        float vv[kDl];
#pragma unroll
        for (int k = 0; k < kDl; ++k) vv[k] = elem<Cache>(vs + p * C::kLd, lane * kDl + k);
#pragma unroll
        for (int h = 0; h < kRows; ++h)
          if (h < gh) {
            const float pr = sp[h * kGroup + p];
#pragma unroll
            for (int k = 0; k < kDl; ++k) acc[h][k] += pr * vv[k];
          }
      }
    }
    __syncwarp();  // every lane is done with the stage before it is refilled
    if (i + kS < mine) load_group(next, i % kS, next_base);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();  // every ring is idle: the warps' states take its place

  float* ws = reinterpret_cast<float*>(smem) + warp * C::kStateFloats;  // m[16], l[16], acc[16][D]
  if constexpr (kMma) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if (t == 0) {
        ws[g4 + 8 * r] = m_run[r];
        ws[kRows + g4 + 8 * r] = l;
      }
    }
#pragma unroll
    for (int jd = 0; jd < kJd; ++jd)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ws[2 * kRows + (g4 + 8 * (e >> 1)) * D + kJd * (2 * t + (e & 1)) + jd] = o[jd][e];
  } else {
    if (lane < gh) {
      ws[lane] = m_run[0];
      ws[kRows + lane] = l_run[0];
    }
#pragma unroll
    for (int h = 0; h < kRows; ++h)
      if (h < gh)
#pragma unroll
        for (int k = 0; k < kDl; ++k) ws[2 * kRows + h * D + lane * kDl + k] = acc[h][k];
  }
  __syncthreads();

  // the block's state: its warps merged in order 0..3
  const float* states = reinterpret_cast<const float*>(smem);
  T* out = static_cast<T*>(a.out);
  for (int x = threadIdx.x; x < gh * D; x += kThreads) {
    const int row = x / D, d = x % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, states[w * C::kStateFloats + row]);
    float tot = 0.f, acc_o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* sw = states + w * C::kStateFloats;
      const float f = attn::exp2_approx(sw[row] - mx);
      tot += sw[kRows + row] * f;
      acc_o += sw[2 * kRows + row * D + d] * f;
    }
    const size_t fr = flat(row);
    if (a.splits == 1) {
      out[fr * D + d] = from_float<T>(acc_o / fmaxf(tot, 1e-30f));  // max(l, 1e-30): a free slot gives 0
    } else {
      float* rec = a.partials + (fr * a.splits + split) * (2 + D);
      rec[2 + d] = acc_o;
      if (d == 0) {
        rec[0] = mx;
        rec[1] = tot;
      }
    }
  }
}

// out = the chunks' states of each output row merged in chunk order: one
// thread an output element. An empty chunk left only m = -inf: it is
// skipped, so a row with no live position gets 0.
template <typename T, int D>
__global__ void __launch_bounds__(256)
decode_combine(const float* __restrict__ partials, T* __restrict__ out, int heads, int splits) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= heads * D) return;
  const int hh = x / D, d = x % D;
  const float* rec = partials + (size_t)hh * splits * (2 + D);
  float mx = kNegInf;
  for (int r = 0; r < splits; ++r) mx = fmaxf(mx, rec[r * (2 + D)]);
  float tot = 0.f, acc_o = 0.f;
  for (int r = 0; r < splits; ++r) {
    const float* st = rec + r * (2 + D);
    if (st[0] == kNegInf) continue;
    const float f = attn::exp2_approx(st[0] - mx);
    tot += st[1] * f;
    acc_o += st[2 + d] * f;
  }
  out[x] = from_float<T>(acc_o / fmaxf(tot, 1e-30f));  // max(l, 1e-30): a free slot gives 0
}

// ------------------------------------------------------------------ launch
template <typename T, typename Cache, int D, bool kMma, typename Src>
cudaError_t launch(const Args& a, const Src& src, cudaStream_t stream) {
  using C = Cfg<Cache, D, kMma>;
  static bool configured = false;  // the attribute is per kernel, set once (eagerly)
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(decode_kernel<T, Cache, D, kMma, Src>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           C::kSmem + Src::kMaxTableBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int tiles = (a.T * (a.H / a.KV) + kRows - 1) / kRows;
  const dim3 grid(a.splits, a.B * a.KV * tiles);
  decode_kernel<T, Cache, D, kMma, Src>
      <<<grid, kThreads, C::kSmem + src.table_bytes(a.chunk), stream>>>(a, src);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const int n = a.B * a.T * a.H * D;
  decode_combine<T, D><<<(n + 255) / 256, 256, 0, stream>>>(a.partials, static_cast<T*>(a.out),
                                                            a.B * a.T * a.H, a.splits);
  return cudaGetLastError();
}

// design 1: mma.sync (bf16 and fp16 queries, D 64 and 128); design 0: FMA
// (every dtype, D 32, 64 and 128). Anything else is refused.
template <typename T, typename Cache, typename Src>
cudaError_t by_design(int design, const Args& a, const Src& src, cudaStream_t st) {
  if (design == 1) {
    if constexpr (std::is_same<T, float>::value) {
      return cudaErrorInvalidValue;
    } else {
      if (a.D == 64) return launch<T, Cache, 64, true>(a, src, st);
      if (a.D == 128) return launch<T, Cache, 128, true>(a, src, st);
      return cudaErrorInvalidValue;
    }
  }
  if (design != 0) return cudaErrorInvalidValue;
  switch (a.D) {
    case 32: return launch<T, Cache, 32, false>(a, src, st);
    case 64: return launch<T, Cache, 64, false>(a, src, st);
    case 128: return launch<T, Cache, 128, false>(a, src, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Src>
cudaError_t dispatch(int dtype, int design, bool quantized, const Args& a, const Src& src,
                     cudaStream_t st) {
  // the plan: 1..16 chunks of whole rounds (4 warps x 16 positions) that
  // cover a slot's capacity, none of them empty of positions; partials for
  // more than one; what the source stages within its shared memory
  const long long S = src.capacity();
  if (a.B <= 0 || a.T < 1 || a.T > kMaxSlotRows || a.H <= 0 || a.KV <= 0 || a.H % a.KV != 0 ||
      S <= 0 || a.splits < 1 || a.splits > kMaxSplits || a.chunk <= 0 ||
      a.chunk % (kWarps * kGroup) != 0 || (long long)a.splits * a.chunk < S ||
      (long long)(a.splits - 1) * a.chunk >= S || (a.splits > 1 && a.partials == nullptr) ||
      (long long)a.B * a.KV * ((a.T * (a.H / a.KV) + kRows - 1) / kRows) > 65535 ||
      src.table_bytes(a.chunk) > Src::kMaxTableBytes)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case kFloat32:
      return quantized ? by_design<float, int8_t>(design, a, src, st)
                       : by_design<float, float>(design, a, src, st);
    case kBFloat16:
      return quantized ? by_design<__nv_bfloat16, int8_t>(design, a, src, st)
                       : by_design<__nv_bfloat16, __nv_bfloat16>(design, a, src, st);
    case kFloat16:
      return quantized ? by_design<__half, int8_t>(design, a, src, st)
                       : by_design<__half, __half>(design, a, src, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace decode
}  // namespace dstorch
