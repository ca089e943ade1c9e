// Block-sparse flash attention (forward, dq, and dk with dv), for Hopper (sm_90a).
//
// Replaces the TPU kernels deepspeed_tpu/ops/sparse_attention/pallas_kernel.py::
// _sparse_fwd_kernel (:68, pallas_call at :151), _sparse_dq_kernel (:164,
// pallas_call at :288) and _sparse_dkv_kernel (:206, pallas_call at :328).
// Each visits only the live blocks of an (H, nq, nq) layout through the
// layout_to_schedule lists: idx[h, i, :cnt[h, i]] are the key blocks query
// block i attends (ascending), idx_t[h, j, :cnt_t[h, j]] the query blocks that
// attend key block j (the transposed layout's lists). With causal, masking is
// token-level (key > query is dropped).
//   forward: out = softmax(q k^T * scale) v over the live keys, online softmax
//            in fp32, p rounded to v's dtype before the PV product,
//            lse = m + log(max(l, 1e-30));
//   dq:      dq = ds k * scale,   ds = p * (dO v^T - delta) rounded to k's dtype;
//   dk, dv:  dv = p^T dO with p rounded to dO's dtype,
//            dk = ds^T q * scale with ds rounded to q's dtype;
// with p = exp(q k^T * scale - lse) recomputed from the forward's lse and
// delta = rowsum(dO * out), which the caller computes in fp32 (the JAX package
// does the same outside its kernels, :262). These are the TPU kernels' rounding
// points. A query row with no live key (an empty layout row, or a causal row
// whose live blocks all lie in its future) gets out = 0, lse = -1e30 and no
// gradient, as the JAX gather formulation gives.
//
// Layout: q/k/v/dO/out/dq/dk/dv (B, T, H, D), read in place with a row stride
// of H * D (the TPU kernels take (B * H, T, D)); lse/delta (B, H, T) fp32;
// idx (H, nq, M), cnt (H, nq), idx_t (H, nq, Mt), cnt_t (H, nq) int32, with
// nq = T / block. The layout granule `block` is any multiple of 64.
//
// The TPU kernels take the layout granule (>= 128) as their tile. These keep
// their own 64-row tiles, the flash kernels' shape, so the shared memory is
// fixed whatever the granule, and walk the live blocks of their layout row
// (forward, dq) or column (dk/dv), each as block / 64 tiles. Under causal the
// tiles wholly after a query tile are skipped, not masked: the forward and
// dq walks stop at the query tile's own diagonal, and the dk/dv walk starts
// at the key tile's own query tile; masking is token-level at the diagonal
// only.
//
// What bounds them on the H100: at the training path's shapes (GPT-2 small:
// B=1, H=12, D=64, T=8192, bf16, BigBird block 512, causal: 144.75 M live
// (query, key) pairs) the forward does 2 products of 2 * D flops per pair,
// dq 3 and dk/dv 4, against 4, 5 and 6 bf16 T x D tensors per head read or
// written (plus lse, delta): ~740 to ~970 flops per byte, far above the ~295
// ridge of the bf16 tensor cores (989 TFLOP/s over 3.35 TB/s), so the card's
// bound is operations, and the products belong on the tensor cores.
//
// The dq and dk/dv kernels have two designs; the entry points take the one
// block_sparse_kernel.py's sparse_design_code names:
//  - wgmma, bf16 and fp16 at D = 64 and 128 (design 1: 128-row blocks,
//    design 2: 64-row blocks; 64 where the granule is not a multiple of
//    128, where 128-row blocks would leave SMs idle, and for dk/dv at
//    D = 128, whose 128-key blocks spill registers). The dense flash
//    kernels' structure (flash_attention_bwd.cu, on flash_sm90.cuh and
//    wgmma.cuh) with the tile walk driven by the schedule: one producer warp
//    loads the block's own tiles once by TMA (3-D maps over (H * D, T, B))
//    and runs a ring of the other operand's 64-row tiles over the walk,
//    writing each tile's first row beside it in shared memory, so the
//    consumer warpgroups (64 rows each) need only the walk's length. dq:
//    one block per (batch * head, query tile), the later tiles first; S =
//    Q K^T and dP = dO V^T as two SS commit groups, P and dS on the fp32
//    accumulators, dS packed to k's dtype for dQ += dS K as RS wgmma (K read
//    MN-major), the next tile's S and dP issued behind.
//    dk/dv: one block per (batch * head, key tile) holding K and V for the
//    whole walk, the ring carrying Q, dO, lse * log2 e and delta; S^T and
//    dP^T as SS, then dV += P^T dO and dK += dS^T Q as RS with P^T and dS^T
//    packed from the accumulators. A block whose walk is empty (an empty
//    layout row or column, or under causal only blocks in its future) writes
//    zeros and waits on no barrier. dk/dv walks are uneven (at T=8192
//    BigBird's global column lists 16 query blocks, the others a few; a
//    Fixed layout's long columns lie at the end of each window), so its 1-D
//    grid takes the (head, layout column) pairs in the caller's launch
//    order, most live blocks first, wherever the layout puts them. dq keeps
//    a 2-D grid (batch * head in x, the later query tiles first in y): the
//    same order made it slower on both layouts (PERF.md).
//  - FMA, fp32 and D = 32 (design 0), and the forward in every case: 256
//    threads a block, tiles fp32 in shared memory, each thread owning a
//    4 x 4 block of the 64 x 64 score tile and a 4 x D/16 block of the
//    accumulators, the products on the fp32 FMA units (15x below the tensor
//    cores, which bound them). The forward is later work; PERF.md records
//    its gap to the bound.
#include "common.cuh"
#include "flash_sm90.cuh"
#include "wgmma.cuh"

namespace dstorch {
namespace {

constexpr int kTile = 64;  // rows of every q, k, v, dO tile
constexpr int kThreads = 256;
constexpr int kLdS = kTile + 1;

template <int D> constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (size_t)(3 * kTile * (D + 1) + kTile * kLdS);
}

template <int D> constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(4 * kTile * (D + 1) + kTile * kLdS);
}

template <int D> constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (size_t)(4 * kTile * (D + 1) + 2 * kTile * kLdS + 2 * kTile);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int *idx, *cnt;  // idx/cnt for the forward and dq, idx_t/cnt_t for dkv
  // the wgmma dk/dv kernel's launch order: (head, layout column) pairs
  // h * nq + j, most live blocks first (block_sparse_kernel.launch_order)
  const int* order;
  int B, T, H, M, block;
  float scale;
  int causal;
};

// The key tiles [s_begin, s_end) of key block kb that query tile m0 visits:
// all block / 64 of them, or under causal those that start at or before the
// query tile's last row.
__device__ __forceinline__ int key_tiles_end(int m0, int kb, int block, int causal) {
  const int sub = block / kTile;
  return causal ? min(sub, (m0 - kb * block) / kTile + 1) : sub;
}

// The query tiles of query block qb that attend key tile n0: under causal,
// from the key tile's own query tile on (the tiles are 64-aligned, so the
// divisions are exact).
__device__ __forceinline__ int query_tiles_begin(int n0, int qb, int block, int causal) {
  return causal ? max(0, (n0 - qb * block) / kTile) : 0;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) sparse_fwd_kernel(Args a, T* __restrict__ out,
                                                              float* __restrict__ lse) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kLd = D + 1;
  constexpr int kDJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * kLd;
  float* Vs = Ks + kTile * kLd;
  float* Ps = Vs + kTile * kLd;

  const int bh = blockIdx.x;
  const int m0 = blockIdx.y * kTile;
  const int b = bh / a.H, h = bh % a.H;
  const int nq = a.T / a.block;
  const int row_blk = m0 / a.block;
  const int* live = a.idx + ((size_t)h * nq + row_blk) * a.M;
  const int n_live = a.cnt[h * nq + row_blk];
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid & 15;  // S columns tx + 16 j; accumulator columns tx + 16 j

  const size_t row_stride = (size_t)a.H * D;
  const size_t head = ((size_t)b * a.T * a.H + h) * D;
  const T* qb = static_cast<const T*>(a.q) + head;
  const T* kb = static_cast<const T*>(a.k) + head;
  const T* vb = static_cast<const T*>(a.v) + head;

  load_tile_f32<T, D, kThreads>(Qs, qb, row_stride, m0, kTile, a.T);

  float m_i[4], l_i[4], acc[4][kDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) acc[i][j] = 0.f;
  }

  for (int m = 0; m < n_live; ++m) {
    const int blk = live[m];
    const int s_end = key_tiles_end(m0, blk, a.block, a.causal);
    for (int s = 0; s < s_end; ++s) {
      const int n0 = blk * a.block + s * kTile;
      __syncthreads();  // the previous tile's readers are done with Ks/Vs/Ps
      load_tile_f32<T, D, kThreads>(Ks, kb, row_stride, n0, kTile, a.T);
      load_tile_f32<T, D, kThreads>(Vs, vb, row_stride, n0, kTile, a.T);
      __syncthreads();

      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float qq[4], kk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qq[i] = Qs[(ty * 4 + i) * kLd + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kk[j] = Ks[(tx + 16 * j) * kLd + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] += qq[i] * kk[j];
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + ty * 4 + i;
        bool masked[4];
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n0 + tx + 16 * j;
          masked[j] = a.causal && col > row;
          sc[i][j] = masked[j] ? kNegInf : sc[i][j] * a.scale;
          mx = fmaxf(mx, sc[i][j]);
        }
        // the 16 lanes holding one row are one aligned half-warp
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_i[i], mx);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = masked[j] ? 0.f : expf(sc[i][j] - m_new);
          rs += p;
          Ps[(ty * 4 + i) * kLdS + tx + 16 * j] = round_through<T>(p);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          rs += __shfl_xor_sync(0xffffffffu, rs, off);
        const float alpha = expf(m_i[i] - m_new);
        l_i[i] = alpha * l_i[i] + rs;
#pragma unroll
        for (int j = 0; j < kDJ; ++j) acc[i][j] *= alpha;
        m_i[i] = m_new;
      }
      __syncthreads();

#pragma unroll 8
      for (int n = 0; n < kTile; ++n) {
        float p[4], vv[kDJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * kLdS + n];
#pragma unroll
        for (int j = 0; j < kDJ; ++j) vv[j] = Vs[n * kLd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kDJ; ++j) acc[i][j] += p[i] * vv[j];
      }
    }
  }

  // a row that saw no live key keeps m = -1e30 and l = 0: out 0, lse -1e30
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    const float l = fmaxf(l_i[i], 1e-30f);
    T* orow = out + (((size_t)b * a.T + row) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) orow[tx + 16 * j] = from_float<T>(acc[i][j] / l);
    if (tx == 0) lse[(size_t)bh * a.T + row] = m_i[i] + logf(l);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) sparse_dq_kernel(Args a, T* __restrict__ dq) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kLd = D + 1;
  constexpr int kDJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * kLd;
  float* Ks = dOs + kTile * kLd;
  float* Vs = Ks + kTile * kLd;
  float* dSs = Vs + kTile * kLd;

  const int bh = blockIdx.x;
  const int m0 = blockIdx.y * kTile;
  const int b = bh / a.H, h = bh % a.H;
  const int nq = a.T / a.block;
  const int row_blk = m0 / a.block;
  const int* live = a.idx + ((size_t)h * nq + row_blk) * a.M;
  const int n_live = a.cnt[h * nq + row_blk];
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  const size_t row_stride = (size_t)a.H * D;
  const size_t head = ((size_t)b * a.T * a.H + h) * D;
  const T* kb = static_cast<const T*>(a.k) + head;
  const T* vb = static_cast<const T*>(a.v) + head;

  load_tile_f32<T, D, kThreads>(Qs, static_cast<const T*>(a.q) + head, row_stride, m0, kTile,
                                a.T);
  load_tile_f32<T, D, kThreads>(dOs, static_cast<const T*>(a.dout) + head, row_stride, m0,
                                kTile, a.T);
  float row_lse[4], row_delta[4], acc[4][kDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    row_lse[i] = a.lse[(size_t)bh * a.T + row];
    row_delta[i] = a.delta[(size_t)bh * a.T + row];
#pragma unroll
    for (int j = 0; j < kDJ; ++j) acc[i][j] = 0.f;
  }

  for (int m = 0; m < n_live; ++m) {
    const int blk = live[m];
    const int s_end = key_tiles_end(m0, blk, a.block, a.causal);
    for (int s = 0; s < s_end; ++s) {
      const int n0 = blk * a.block + s * kTile;
      __syncthreads();  // the previous tile's readers are done with Ks/Vs/dSs
      load_tile_f32<T, D, kThreads>(Ks, kb, row_stride, n0, kTile, a.T);
      load_tile_f32<T, D, kThreads>(Vs, vb, row_stride, n0, kTile, a.T);
      __syncthreads();

      float sc[4][4], dp[4][4];
      two_score_tiles<D>(Qs, Ks, dOs, Vs, ty, tx, sc, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n0 + tx + 16 * j;
          const bool masked = a.causal && col > row;
          const float p = masked ? 0.f : expf(sc[i][j] * a.scale - row_lse[i]);
          dSs[(ty * 4 + i) * kLdS + tx + 16 * j] =
              round_through<T>(p * (dp[i][j] - row_delta[i]));
        }
      }
      __syncthreads();

#pragma unroll 8
      for (int n = 0; n < kTile; ++n) {
        float ds[4], kk[kDJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty * 4 + i) * kLdS + n];
#pragma unroll
        for (int j = 0; j < kDJ; ++j) kk[j] = Ks[n * kLd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kDJ; ++j) acc[i][j] += ds[i] * kk[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    T* drow = dq + (((size_t)b * a.T + row) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) drow[tx + 16 * j] = from_float<T>(acc[i][j] * a.scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
sparse_dkv_kernel(Args a, T* __restrict__ dk, T* __restrict__ dv) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kLd = D + 1;
  constexpr int kDJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * kLd;
  float* Qs = Vs + kTile * kLd;
  float* dOs = Qs + kTile * kLd;
  float* Ps = dOs + kTile * kLd;
  float* dSs = Ps + kTile * kLdS;
  float* lse_s = dSs + kTile * kLdS;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.x;
  const int n0 = blockIdx.y * kTile;  // this block's key rows
  const int b = bh / a.H, h = bh % a.H;
  const int nq = a.T / a.block;
  const int col_blk = n0 / a.block;
  const int* live = a.idx + ((size_t)h * nq + col_blk) * a.M;
  const int n_live = a.cnt[h * nq + col_blk];
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // key rows ty*4 .. ty*4+3 of the tile
  const int tx = tid & 15;  // query columns tx + 16 j; accumulator columns tx + 16 j

  const size_t row_stride = (size_t)a.H * D;
  const size_t head = ((size_t)b * a.T * a.H + h) * D;
  const T* qb = static_cast<const T*>(a.q) + head;
  const T* ob = static_cast<const T*>(a.dout) + head;
  load_tile_f32<T, D, kThreads>(Ks, static_cast<const T*>(a.k) + head, row_stride, n0, kTile,
                                a.T);
  load_tile_f32<T, D, kThreads>(Vs, static_cast<const T*>(a.v) + head, row_stride, n0, kTile,
                                a.T);

  float dk_acc[4][kDJ], dv_acc[4][kDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int sub = a.block / kTile;
  for (int m = 0; m < n_live; ++m) {
    const int blk = live[m];
    for (int s = query_tiles_begin(n0, blk, a.block, a.causal); s < sub; ++s) {
      const int m0 = blk * a.block + s * kTile;
      __syncthreads();  // the previous tile's readers are done with Qs/dOs/Ps/dSs
      load_tile_f32<T, D, kThreads>(Qs, qb, row_stride, m0, kTile, a.T);
      load_tile_f32<T, D, kThreads>(dOs, ob, row_stride, m0, kTile, a.T);
      if (tid < kTile) {
        lse_s[tid] = a.lse[(size_t)bh * a.T + m0 + tid];
        delta_s[tid] = a.delta[(size_t)bh * a.T + m0 + tid];
      }
      __syncthreads();

      // transposed tiles: rows are keys, columns queries
      float sc[4][4], dp[4][4];
      two_score_tiles<D>(Ks, Qs, Vs, dOs, ty, tx, sc, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = n0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = tx + 16 * j;
          const bool masked = a.causal && key > m0 + qc;
          const float p = masked ? 0.f : expf(sc[i][j] * a.scale - lse_s[qc]);
          Ps[(ty * 4 + i) * kLdS + qc] = round_through<T>(p);
          dSs[(ty * 4 + i) * kLdS + qc] = round_through<T>(p * (dp[i][j] - delta_s[qc]));
        }
      }
      __syncthreads();

#pragma unroll 8
      for (int n = 0; n < kTile; ++n) {
        float p[4], ds[4], oo[kDJ], qq[kDJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = Ps[(ty * 4 + i) * kLdS + n];
          ds[i] = dSs[(ty * 4 + i) * kLdS + n];
        }
#pragma unroll
        for (int j = 0; j < kDJ; ++j) {
          oo[j] = dOs[n * kLd + tx + 16 * j];
          qq[j] = Qs[n * kLd + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kDJ; ++j) {
            dv_acc[i][j] += p[i] * oo[j];
            dk_acc[i][j] += ds[i] * qq[j];
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = n0 + ty * 4 + i;
    const size_t off = (((size_t)b * a.T + key) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) {
      dk[off + tx + 16 * j] = from_float<T>(dk_acc[i][j] * a.scale);
      dv[off + tx + 16 * j] = from_float<T>(dv_acc[i][j]);
    }
  }
}

// ------------------------------------------------------- bf16 / fp16: wgmma

// The tiles [first, end) of layout block blk that a walk visits: dq the key
// tiles of the query tile at `pivot` (the block's last 64-row tile), dk/dv
// the query tiles that the key tile at `pivot` (the block's first) can see.
template <bool kDq>
__device__ __forceinline__ void tile_range(const Args& a, int pivot, int blk, int& first,
                                           int& end) {
  first = kDq ? 0 : query_tiles_begin(pivot, blk, a.block, a.causal);
  end = kDq ? key_tiles_end(pivot, blk, a.block, a.causal) : a.block / kTile;
}

// Tiles in the walk over live[0 .. n_live).
template <bool kDq>
__device__ int walk_length(const Args& a, const int* live, int n_live, int pivot) {
  int n = 0;
  for (int i = 0; i < n_live; ++i) {
    int first, end;
    tile_range<kDq>(a, pivot, live[i], first, end);
    n += max(0, end - first);
  }
  return n;
}

// Zeros rows [r0, r0 + rows) of one head (row r at base + r * stride), by
// the whole block: the gradient of rows whose walk is empty.
template <typename T, int D>
__device__ void zero_rows(T* base, size_t stride, int r0, int rows) {
  constexpr int kPerRow = D * (int)sizeof(T) / 16;
  for (int e = threadIdx.x; e < rows * kPerRow; e += blockDim.x)
    reinterpret_cast<uint4*>(base + (size_t)(r0 + e / kPerRow) * stride)[e % kPerRow] =
        make_uint4(0, 0, 0, 0);
}

// dq: one block per (batch * head, query tile of 64 kWG rows), inside one
// layout row, the later tiles first. The producer thread loads Q and dO
// once, then runs the (K, V) ring over the walk, writing each key tile's
// first row to rows[stage].
template <typename T, int D, int kWG>
__global__ void __launch_bounds__(bwd::DqCfg<D, kWG>::kThreads, 1)
sparse_dq_wgmma(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap do_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map, Args a, T* __restrict__ dq) {
  using namespace sm90;
  using C = bwd::DqCfg<D, kWG>;
  constexpr int kS = C::kStages, kBM = C::kBM, kBN = C::kBN;
  static_assert(kBN == kTile, "the ring's key tiles are the walk's tiles");
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // the longer causal walks first
  const int nq = a.T / a.block, row_blk = m0 / a.block, pivot = m0 + kBM - kTile;
  const int* live = a.idx + ((size_t)h * nq + row_blk) * a.M;
  const int n_live = a.cnt[h * nq + row_blk];
  const int n_tiles = walk_length<true>(a, live, n_live, pivot);
  const size_t row_stride = (size_t)a.H * D;
  T* dq_head = dq + ((size_t)b * a.T * a.H + h) * D;
  if (n_tiles == 0) {  // no live key in these rows: no gradient, no barrier
    zero_rows<T, D>(dq_head, row_stride, m0, kBM);
    return;
  }

  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  const uint32_t raw = smem_u32(smem_tiles);
  const uint32_t qs = (raw + 1023) & ~1023u, dos = qs + C::kQBytes;
  const uint32_t ring = dos + C::kQBytes;  // stage s: the K tile, then the V tile
  const uint32_t bars = ring + kS * 2 * C::kKBytes;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kS + s); };
  // the first key row of the tile in each stage, after the barriers
  int* rows = reinterpret_cast<int*>(smem_tiles + (bars + 8 * (1 + 2 * kS) - raw));
  const int wgi = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * kWG);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wgi == kWG) {  // producer: one thread issues every load
    if (threadIdx.x == 128 * kWG) {
      mbar_arrive_expect_tx(q_full, 2 * C::kQBytes);
      for (int x = 0; x < C::kBoxes; ++x) {
        tma_load_3d(qs + x * C::kQBox, &q_map, q_full, h * D + 64 * x, m0, b);
        tma_load_3d(dos + x * C::kQBox, &do_map, q_full, h * D + 64 * x, m0, b);
      }
      int it = 0;
      for (int i = 0; i < n_live; ++i) {
        const int blk = live[i];
        int first, end;
        tile_range<true>(a, pivot, blk, first, end);
        for (int tile = first; tile < end; ++tile, ++it) {
          const int s = it % kS, n0 = blk * a.block + tile * kTile;
          const uint32_t ks = ring + s * 2 * C::kKBytes, vs = ks + C::kKBytes;
          mbar_wait(empty(s), ((it / kS) & 1) ^ 1);
          rows[s] = n0;  // published by the arrival below (release)
          mbar_arrive_expect_tx(full(s), 2 * C::kKBytes);
          for (int x = 0; x < C::kBoxes; ++x) {
            tma_load_3d(ks + x * C::kKBox, &k_map, full(s), h * D + 64 * x, n0, b);
            tma_load_3d(vs + x * C::kKBox, &v_map, full(s), h * D + 64 * x, n0, b);
          }
        }
      }
    }
  } else {  // consumers: warpgroup wgi owns query rows m0 + 64 wgi .. + 63
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, t = lane & 3;
    const int row_lo = m0 + wgi * 64;
    const int row0 = row_lo + warp * 16 + (lane >> 2);  // this thread's rows row0, row0 + 8
    const float scale_log2 = a.scale * attn::kLog2e;
    const uint32_t qa = qs + wgi * 64 * 128, oa = dos + wgi * 64 * 128;  // this warpgroup's rows
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse2[r] = a.lse[(size_t)bh * a.T + row0 + 8 * r] * attn::kLog2e;
      dl[r] = a.delta[(size_t)bh * a.T + row0 + 8 * r];
    }
    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
    float st[kBN / 2], dpt[kBN / 2];  // S, then P; dP, then dS (rows queries, columns keys)
    uint32_t da[kBN / 16][4];         // dS rounded to k's dtype: the A operand of dQ += dS K

    // S = Q K^T and dP = dO V^T of walk tile it: two commit groups
    auto issue_sdp = [&](int it) {
      const uint32_t ks = ring + (it % kS) * 2 * C::kKBytes, vs = ks + C::kKBytes;
      mbar_wait(full(it % kS), (it / kS) & 1);
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<T, kBN, 0>(st, sw128_desc(qa + (kk >> 2) * C::kQBox + (kk & 3) * 32, 16, 1024),
                            sw128_desc(ks + (kk >> 2) * C::kKBox + (kk & 3) * 32, 16, 1024),
                            kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<T, kBN, 0>(dpt, sw128_desc(oa + (kk >> 2) * C::kQBox + (kk & 3) * 32, 16, 1024),
                            sw128_desc(vs + (kk >> 2) * C::kKBox + (kk & 3) * 32, 16, 1024),
                            kk > 0);
      wgmma_commit();
    };

    mbar_wait(q_full, 0);
    issue_sdp(0);
    for (int it = 0; it < n_tiles; ++it) {
      const int n0 = rows[it % kS];  // the stage is released only at it + 1
      wgmma_wait<1>();  // S (and dQ += dS K of the tile before) done; dP may still run
      fence_regs(st);
      fence_regs(dq_acc);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) fence_regs(da[kk]);  // read until here
      if (it > 0 && lane == 0) mbar_arrive(empty((it - 1) % kS));
      const bool edge = a.causal && n0 + kBN - 1 > row_lo;
#pragma unroll
      for (int e = 0; e < kBN / 2; ++e) {
        const int r = attn::acc_half(e);
        const bool msk =
            edge && attn::masked(row0 + 8 * r, n0 + attn::acc_col(e, t), a.T, a.T, true);
        st[e] = attn::recompute_p(st[e], scale_log2, lse2[r], msk);
      }
      wgmma_wait<0>();  // dP done
      fence_regs(dpt);
#pragma unroll
      for (int e = 0; e < kBN / 2; ++e)
        dpt[e] = attn::score_grad(st[e], dpt[e], dl[attn::acc_half(e)]);
      pack_afrags<T, kBN>(dpt, da);
      // dQ += dS K, K read MN-major (its rows are keys, D contiguous)
      const uint32_t ks = ring + (it % kS) * 2 * C::kKBytes;
      fence_regs(dq_acc);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) fence_regs(da[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs<T, D, 1>(dq_acc, da[kk], sw128_desc(ks + kk * 16 * 128, C::kKBox, 1024), 1);
      wgmma_commit();
      if (it + 1 < n_tiles) issue_sdp(it + 1);
    }
    wgmma_wait<0>();
    fence_regs(dq_acc);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) fence_regs(da[kk]);
    if (lane == 0) mbar_arrive(empty((n_tiles - 1) % kS));
#pragma unroll
    for (int r = 0; r < 2; ++r)
      attn::store_acc_row<T, D>(dq_head + (size_t)(row0 + 8 * r) * row_stride, dq_acc, r, t,
                                a.scale);
  }
}

// dk/dv: one block per (batch * head, key tile of 64 kWG keys), inside one
// layout column, K and V loaded once. Blocks start in index order (a 1-D
// grid), so the (head, column) pairs that a.order lists first, the longest
// walks, start first, each with all its batches and key tiles together.
// The producer warp runs the ring of (Q, dO, lse * log2 e, delta) over the
// walk of the transposed schedule, writing each query tile's first row
// after the stage's statistics.
template <typename T, int D, int kWG>
__global__ void __launch_bounds__(bwd::DkvCfg<D, kWG>::kThreads, 1)
sparse_dkv_wgmma(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap do_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, Args a, T* __restrict__ dk,
                 T* __restrict__ dv) {
  using namespace sm90;
  using C = bwd::DkvCfg<D, kWG>;
  constexpr int kS = C::kStages, kBM = bwd::kBM, kBN = C::kBN;
  static_assert(kBM == kTile, "the ring's query tiles are the walk's tiles");
  static_assert(2 * kBM * sizeof(float) + sizeof(int) <= 1024, "a stage's statistics overflow");
  const int per = a.block / kBN, nq = a.T / a.block;
  const int pair = a.order[blockIdx.x / (a.B * per)], rem = blockIdx.x % (a.B * per);
  const int b = rem / per, h = pair / nq, col_blk = pair % nq, bh = b * a.H + h;
  const int n0 = col_blk * a.block + (rem % per) * kBN;  // a column's first tile walks the most
  const int* live = a.idx + ((size_t)h * nq + col_blk) * a.M;
  const int n_live = a.cnt[h * nq + col_blk];
  const int steps = walk_length<false>(a, live, n_live, n0);
  const size_t row_stride = (size_t)a.H * D, head = ((size_t)b * a.T * a.H + h) * D;
  if (steps == 0) {  // no query attends these keys: no gradient, no barrier
    zero_rows<T, D>(dk + head, row_stride, n0, kBN);
    zero_rows<T, D>(dv + head, row_stride, n0, kBN);
    return;
  }

  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  const uint32_t raw = smem_u32(smem_tiles);
  const uint32_t ks = (raw + 1023) & ~1023u, vs = ks + C::kKBytes;
  const uint32_t ring = vs + C::kKBytes;
  unsigned char* ring_ptr = smem_tiles + (ring - raw);
  const uint32_t bars = ring + kS * C::kStageBytes;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kS + s); };
  // stage s's lse * log2 e [kBM], delta [kBM], then its first query row
  auto stats_of = [&](int s) {
    return reinterpret_cast<float*>(ring_ptr + s * C::kStageBytes + 2 * C::kQBytes);
  };
  const int wgi = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * kWG);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wgi == kWG) {
    if (threadIdx.x < 128 * kWG + 32) {  // one warp: lane 0 issues the loads, all copy lse and delta
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * C::kKBytes);
        for (int x = 0; x < C::kBoxes; ++x) {
          tma_load_3d(ks + x * C::kKBox, &k_map, kv_full, h * D + 64 * x, n0, b);
          tma_load_3d(vs + x * C::kKBox, &v_map, kv_full, h * D + 64 * x, n0, b);
        }
      }
      const size_t at = (size_t)bh * a.T;
      int it = 0;
      for (int i = 0; i < n_live; ++i) {
        const int blk = live[i];
        int first, end;
        tile_range<false>(a, n0, blk, first, end);
        for (int tile = first; tile < end; ++tile, ++it) {
          const int s = it % kS, m0 = blk * a.block + tile * kTile;
          const uint32_t st = ring + s * C::kStageBytes;
          float* stats = stats_of(s);
          mbar_wait(empty(s), ((it / kS) & 1) ^ 1);
          for (int r = lane; r < kBM; r += 32) {
            stats[r] = a.lse[at + m0 + r] * attn::kLog2e;
            stats[kBM + r] = a.delta[at + m0 + r];
          }
          if (lane == 0) reinterpret_cast<int*>(stats)[2 * kBM] = m0;
          __syncwarp();  // the lanes' stores precede lane 0's arrival (release)
          if (lane == 0) {
            mbar_arrive_expect_tx(full(s), 2 * C::kQBytes);
            for (int x = 0; x < C::kBoxes; ++x) {
              tma_load_3d(st + x * C::kQBox, &q_map, full(s), h * D + 64 * x, m0, b);
              tma_load_3d(st + C::kQBytes + x * C::kQBox, &do_map, full(s), h * D + 64 * x, m0,
                          b);
            }
          }
        }
      }
    }
  } else {  // consumers: warpgroup wgi owns keys n0 + 64 wgi .. + 63
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, t = lane & 3;
    const int key_lo = n0 + wgi * 64;
    const int key0 = key_lo + warp * 16 + (lane >> 2);  // this thread's keys key0, key0 + 8
    const float scale_log2 = a.scale * attn::kLog2e;
    const uint32_t ka = ks + wgi * 64 * 128, va = vs + wgi * 64 * 128;  // this warpgroup's rows
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(kv_full, 0);
    for (int it = 0; it < steps; ++it) {
      const int s = it % kS;
      const uint32_t qt = ring + s * C::kStageBytes, dot = qt + C::kQBytes;
      const float* stats = stats_of(s);
      mbar_wait(full(s), (it / kS) & 1);
      const int m0 = reinterpret_cast<const int*>(stats)[2 * kBM];
      // causal: a query tile wholly before this warpgroup's keys adds nothing
      if (!a.causal || m0 + kBM - 1 >= key_lo) {
        // four commit groups: S^T, dP^T, then dV += P^T dO once P^T is
        // packed (it runs while dS^T is formed), then dK += dS^T Q
        float st[kBM / 2], dpt[kBM / 2];  // S^T and dP^T: rows keys, columns queries
        uint32_t pa[kBM / 16][4], da[kBM / 16][4];  // P^T to dO's dtype, dS^T to q's
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<T, kBM, 0>(st, sw128_desc(ka + (kk >> 2) * C::kKBox + (kk & 3) * 32, 16, 1024),
                              sw128_desc(qt + (kk >> 2) * C::kQBox + (kk & 3) * 32, 16, 1024),
                              kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<T, kBM, 0>(dpt, sw128_desc(va + (kk >> 2) * C::kKBox + (kk & 3) * 32, 16, 1024),
                              sw128_desc(dot + (kk >> 2) * C::kQBox + (kk & 3) * 32, 16, 1024),
                              kk > 0);
        wgmma_commit();
        const bool edge = a.causal && key_lo + 63 > m0;
        wgmma_wait<1>();  // S^T is done; dP^T may still run
        fence_regs(st);
#pragma unroll
        for (int j = 0; j < kBM / 8; ++j) {  // query columns 8j + 2t, +1
          const float2 l2 = *reinterpret_cast<const float2*>(stats + 8 * j + 2 * t);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = 4 * j + i, qc = attn::acc_col(e, t);
            const bool msk =
                edge && attn::masked(m0 + qc, key0 + 8 * attn::acc_half(e), a.T, a.T, true);
            st[e] = attn::recompute_p(st[e], scale_log2, (i & 1) ? l2.y : l2.x, msk);
          }
        }
        pack_afrags<T, kBM>(st, pa);
        fence_regs(dv_acc);
#pragma unroll
        for (int kk = 0; kk < kBM / 16; ++kk) fence_regs(pa[kk]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBM / 16; ++kk)
          wgmma_rs<T, D, 1>(dv_acc, pa[kk], sw128_desc(dot + kk * 16 * 128, C::kQBox, 1024), 1);
        wgmma_commit();
        wgmma_wait<1>();  // dP^T is done; dV += P^T dO may still run
        fence_regs(dpt);
#pragma unroll
        for (int j = 0; j < kBM / 8; ++j) {
          const float2 d2 = *reinterpret_cast<const float2*>(stats + kBM + 8 * j + 2 * t);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = 4 * j + i;
            dpt[e] = attn::score_grad(st[e], dpt[e], (i & 1) ? d2.y : d2.x);
          }
        }
        pack_afrags<T, kBM>(dpt, da);
        fence_regs(dk_acc);
#pragma unroll
        for (int kk = 0; kk < kBM / 16; ++kk) fence_regs(da[kk]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBM / 16; ++kk)
          wgmma_rs<T, D, 1>(dk_acc, da[kk], sw128_desc(qt + kk * 16 * 128, C::kQBox, 1024), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
#pragma unroll
        for (int kk = 0; kk < kBM / 16; ++kk) {  // read until here
          fence_regs(pa[kk]);
          fence_regs(da[kk]);
        }
      }
      if (lane == 0) mbar_arrive(empty(s));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t off = head + (size_t)(key0 + 8 * r) * row_stride;
      attn::store_acc_row<T, D>(dk + off, dk_acc, r, t, a.scale);
      attn::store_acc_row<T, D>(dv + off, dv_acc, r, t, 1.f);
    }
  }
}

// ------------------------------------------------------------------ launch
enum Which { kFwd, kDq, kDkv };

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool* configured) {
  if (*configured) return cudaSuccess;  // the attribute is per kernel, set once
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *configured = true;
  return err;
}

template <typename T, int D>
cudaError_t launch(Which which, const Args& a, void* o1, void* o2, cudaStream_t st) {
  const dim3 grid(a.B * a.H, a.T / kTile);
  switch (which) {
    case kFwd: {
      constexpr size_t kSmem = fwd_smem_bytes<D>();
      static bool configured = false;
      cudaError_t err = allow_smem(sparse_fwd_kernel<T, D>, kSmem, &configured);
      if (err != cudaSuccess) return err;
      sparse_fwd_kernel<T, D><<<grid, kThreads, kSmem, st>>>(a, static_cast<T*>(o1),
                                                              static_cast<float*>(o2));
      break;
    }
    case kDq: {
      constexpr size_t kSmem = dq_smem_bytes<D>();
      static bool configured = false;
      cudaError_t err = allow_smem(sparse_dq_kernel<T, D>, kSmem, &configured);
      if (err != cudaSuccess) return err;
      sparse_dq_kernel<T, D><<<grid, kThreads, kSmem, st>>>(a, static_cast<T*>(o1));
      break;
    }
    case kDkv: {
      constexpr size_t kSmem = dkv_smem_bytes<D>();
      static bool configured = false;
      cudaError_t err = allow_smem(sparse_dkv_kernel<T, D>, kSmem, &configured);
      if (err != cudaSuccess) return err;
      sparse_dkv_kernel<T, D><<<grid, kThreads, kSmem, st>>>(a, static_cast<T*>(o1),
                                                              static_cast<T*>(o2));
      break;
    }
  }
  return cudaGetLastError();
}

// The four tensor maps over (B, T, H * D): q and dO with boxes of q_rows
// rows, k and v of k_rows.
inline cudaError_t encode_maps(bool bf16, const Args& a, int D, uint32_t q_rows, uint32_t k_rows,
                               CUtensorMap (&maps)[4]) {
  const uint64_t width = (uint64_t)a.H * D;
  const void* bases[4] = {a.q, a.dout, a.k, a.v};
  for (int i = 0; i < 4; ++i) {
    cudaError_t err =
        encode_tma_3d(&maps[i], bf16, bases[i], a.B, a.T, width, i < 2 ? q_rows : k_rows);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T, int D, int kWG>
cudaError_t launch_wgmma(Which which, const Args& a, void* o1, void* o2, cudaStream_t st) {
  constexpr bool kBf16 = sm90::WgmmaType<T>::kBf16;
  CUtensorMap m[4];
  if (which == kDq) {
    using C = bwd::DqCfg<D, kWG>;
    constexpr size_t kSmem = C::kSmem + sizeof(int) * C::kStages;  // + the stages' key rows
    static bool configured = false;
    cudaError_t err = allow_smem(sparse_dq_wgmma<T, D, kWG>, kSmem, &configured);
    if (err == cudaSuccess) err = encode_maps(kBf16, a, D, C::kBM, C::kBN, m);
    if (err != cudaSuccess) return err;
    sparse_dq_wgmma<T, D, kWG><<<dim3(a.B * a.H, a.T / C::kBM), C::kThreads, kSmem, st>>>(
        m[0], m[1], m[2], m[3], a, static_cast<T*>(o1));
  } else {
    using C = bwd::DkvCfg<D, kWG>;
    static bool configured = false;
    cudaError_t err = allow_smem(sparse_dkv_wgmma<T, D, kWG>, C::kSmem, &configured);
    if (err == cudaSuccess) err = encode_maps(kBf16, a, D, bwd::kBM, C::kBN, m);
    if (err != cudaSuccess) return err;
    sparse_dkv_wgmma<T, D, kWG><<<a.B * a.H * (a.T / C::kBN), C::kThreads, C::kSmem, st>>>(
        m[0], m[1], m[2], m[3], a, static_cast<T*>(o1), static_cast<T*>(o2));
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int D, Which which, const Args& a, void* o1, void* o2,
                         cudaStream_t st) {
  switch (D) {
    case 32: return launch<T, 32>(which, a, o1, o2, st);
    case 64: return launch<T, 64>(which, a, o1, o2, st);
    case 128: return launch<T, 128>(which, a, o1, o2, st);
    default: return cudaErrorInvalidValue;
  }
}

// kWG: 2 (128-row blocks) or 1 (64-row blocks)
template <typename T>
cudaError_t wgmma_dim(int D, int kWG, Which which, const Args& a, void* o1, void* o2,
                      cudaStream_t st) {
  if (D == 64 && kWG == 2) return launch_wgmma<T, 64, 2>(which, a, o1, o2, st);
  if (D == 64 && kWG == 1) return launch_wgmma<T, 64, 1>(which, a, o1, o2, st);
  if (D == 128 && kWG == 2) return launch_wgmma<T, 128, 2>(which, a, o1, o2, st);
  if (D == 128 && kWG == 1) return launch_wgmma<T, 128, 1>(which, a, o1, o2, st);
  return cudaErrorInvalidValue;
}

// design 0: the FMA kernels (every dtype, D 32, 64, 128; the only design of
// the forward); 1: wgmma with 128-row blocks (bf16 and fp16, D 64 and 128, a
// granule that is a multiple of 128, so a block lies in one layout row or
// column); 2: wgmma with 64-row blocks (any granule). Anything else is
// refused.
cudaError_t dispatch(int dtype, int design, int D, Which which, const Args& a, void* o1,
                     void* o2, cudaStream_t st) {
  if (a.B <= 0 || a.H <= 0 || a.M <= 0 || a.block <= 0 || a.block % kTile != 0 ||
      a.T <= 0 || a.T % a.block != 0)
    return cudaErrorInvalidValue;
  if (design == 0) {
    switch (dtype) {
      case kFloat32: return dispatch_dim<float>(D, which, a, o1, o2, st);
      case kBFloat16: return dispatch_dim<__nv_bfloat16>(D, which, a, o1, o2, st);
      case kFloat16: return dispatch_dim<__half>(D, which, a, o1, o2, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (which == kFwd || (design != 1 && design != 2) || (design == 1 && a.block % 128 != 0) ||
      (which == kDkv && a.order == nullptr))
    return cudaErrorInvalidValue;
  const int wgs = design == 1 ? 2 : 1;
  switch (dtype) {
    case kBFloat16: return wgmma_dim<__nv_bfloat16>(D, wgs, which, a, o1, o2, st);
    case kFloat16: return wgmma_dim<__half>(D, wgs, which, a, o1, o2, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dstorch

// C entry points bound with ctypes. Each returns its launch's cudaGetLastError().
// The dq and dk/dv entries take the design (see dispatch above) that
// block_sparse_kernel.py's sparse_design_code names; dk/dv also the wgmma
// kernel's launch order over (head, layout column), H * nq int32
// (launch_order; the FMA kernel launches in grid order and does not read it).
extern "C" int dstorch_block_sparse_fwd(int dtype, const void* q, const void* k, const void* v,
                                        void* out, void* lse, const void* idx, const void* cnt,
                                        int B, int T, int H, int D, int M, int block,
                                        float scale, int causal, void* stream) {
  const dstorch::Args a{q, k, v, nullptr, nullptr, nullptr,
                        static_cast<const int*>(idx), static_cast<const int*>(cnt), nullptr,
                        B, T, H, M, block, scale, causal};
  return (int)dstorch::dispatch(dtype, 0, D, dstorch::kFwd, a, out, lse,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int dstorch_block_sparse_dq(int dtype, int design, const void* q, const void* k,
                                       const void* v, const void* dout, const void* lse,
                                       const void* delta, const void* idx, const void* cnt,
                                       void* dq, int B, int T, int H, int D, int M, int block,
                                       float scale, int causal, void* stream) {
  const dstorch::Args a{q, k, v, dout, static_cast<const float*>(lse),
                        static_cast<const float*>(delta), static_cast<const int*>(idx),
                        static_cast<const int*>(cnt), nullptr, B, T, H, M, block, scale, causal};
  return (int)dstorch::dispatch(dtype, design, D, dstorch::kDq, a, dq, nullptr,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int dstorch_block_sparse_dkv(int dtype, int design, const void* q, const void* k,
                                        const void* v, const void* dout, const void* lse,
                                        const void* delta, const void* idx_t, const void* cnt_t,
                                        const void* order_t, void* dk, void* dv, int B, int T,
                                        int H, int D, int Mt, int block, float scale, int causal,
                                        void* stream) {
  const dstorch::Args a{q, k, v, dout, static_cast<const float*>(lse),
                        static_cast<const float*>(delta), static_cast<const int*>(idx_t),
                        static_cast<const int*>(cnt_t), static_cast<const int*>(order_t),
                        B, T, H, Mt, block, scale, causal};
  return (int)dstorch::dispatch(dtype, design, D, dstorch::kDkv, a, dk, dv,
                                static_cast<cudaStream_t>(stream));
}
