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
// fixed whatever the granule: one block of 256 threads owns (batch * head, a
// 64-row query tile) in the forward and dq kernels and walks the key blocks
// of its layout row, each as block / 64 key tiles; the dkv kernel owns (batch *
// head, a 64-row key tile) and walks the query blocks of its layout column.
// Under causal the key tiles wholly after a query tile are skipped, not
// masked: the forward and dq walks stop at the query tile's own diagonal, and
// the dkv walk starts at the key tile's own query tile. Tiles are fp32 in
// shared memory; each thread owns a 4 x 4 block of the 64 x 64 score tile and
// a 4 x D/16 block of the accumulators.
//
// What bounds it on the H100: at the training path's shapes (GPT-2 small:
// B=1, H=12, D=64, T=8192, bf16, BigBird block 512, causal: 144.75 M live
// (query, key) pairs) the forward does 2 products of 2 * D flops per pair,
// dq 3 and dkv 4, against 4, 5 and 6 bf16 T x D tensors per head read or
// written (plus lse, delta): ~740 to ~970 flops per byte, far above the ~295
// ridge of the bf16 tensor cores (989 TFLOP/s over 3.35 TB/s), so the card's
// bound is operations. These kernels run their products on the fp32 FMA units, 15x
// below the tensor cores, so those bound them. They are deliberately simple
// and correct rather than fast; wgmma with TMA-fed tiles is later work, and
// PERF.md records the gap to the bound. The dkv walk is uneven: key tiles of
// a global column are attended by every query block (Mt = 16 against M = 4
// at T=8192 / 512). The grid puts batch * head in x, so every head's first
// key tiles (BigBird's global block 0) are scheduled first.
#include "common.cuh"

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

cudaError_t dispatch(int dtype, int D, Which which, const Args& a, void* o1, void* o2,
                     cudaStream_t st) {
  if (a.B <= 0 || a.H <= 0 || a.M <= 0 || a.block <= 0 || a.block % kTile != 0 ||
      a.T <= 0 || a.T % a.block != 0)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case kFloat32: return dispatch_dim<float>(D, which, a, o1, o2, st);
    case kBFloat16: return dispatch_dim<__nv_bfloat16>(D, which, a, o1, o2, st);
    case kFloat16: return dispatch_dim<__half>(D, which, a, o1, o2, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dstorch

// C entry points bound with ctypes. Each returns its launch's cudaGetLastError().
extern "C" int dstorch_block_sparse_fwd(int dtype, const void* q, const void* k, const void* v,
                                        void* out, void* lse, const void* idx, const void* cnt,
                                        int B, int T, int H, int D, int M, int block,
                                        float scale, int causal, void* stream) {
  const dstorch::Args a{q, k, v, nullptr, nullptr, nullptr,
                        static_cast<const int*>(idx), static_cast<const int*>(cnt),
                        B, T, H, M, block, scale, causal};
  return (int)dstorch::dispatch(dtype, D, dstorch::kFwd, a, out, lse,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int dstorch_block_sparse_dq(int dtype, const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       const void* idx, const void* cnt, void* dq, int B,
                                       int T, int H, int D, int M, int block, float scale,
                                       int causal, void* stream) {
  const dstorch::Args a{q, k, v, dout, static_cast<const float*>(lse),
                        static_cast<const float*>(delta), static_cast<const int*>(idx),
                        static_cast<const int*>(cnt), B, T, H, M, block, scale, causal};
  return (int)dstorch::dispatch(dtype, D, dstorch::kDq, a, dq, nullptr,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int dstorch_block_sparse_dkv(int dtype, const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        const void* idx_t, const void* cnt_t, void* dk,
                                        void* dv, int B, int T, int H, int D, int Mt, int block,
                                        float scale, int causal, void* stream) {
  const dstorch::Args a{q, k, v, dout, static_cast<const float*>(lse),
                        static_cast<const float*>(delta), static_cast<const int*>(idx_t),
                        static_cast<const int*>(cnt_t), B, T, H, Mt, block, scale, causal};
  return (int)dstorch::dispatch(dtype, D, dstorch::kDkv, a, dk, dv,
                                static_cast<cudaStream_t>(stream));
}
