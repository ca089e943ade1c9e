// Flash-attention backward (dq, and dk with dv), for Hopper (sm_90a).
//
// Replaces the TPU kernels deepspeed_tpu/ops/attention/flash_attention.py::
// _bwd_dq_kernel (:210, pallas_call at :315) and _bwd_dkv_kernel (:253,
// pallas_call at :340). Both recompute the probabilities from the forward's
// saved log-sum-exp, p = exp(q k^T * scale - lse), and take
// delta = rowsum(dO * out), which the caller computes in fp32 beforehand
// (the JAX package does the same outside its kernels, :310):
//   dq = (p * (dO v^T - delta)) k * scale
//   dv = p^T dO,  dk = (p * (dO v^T - delta))^T q * scale
// with the TPU kernels' roundings: ds is rounded to k's dtype before the dq
// product (:244) and to q's dtype before the dk product (:292), and p to
// dO's dtype before the dv product; all sums are fp32.
//
// Layout: q/dO/dq (B, Tq, H, D), k/v/dk/dv (B, Tk, KV, D) with H % KV == 0;
// lse/delta (B, H, Tq) fp32. Under grouped-query heads a dkv block walks
// every query head of its KV head, so dk and dv are the group's sums.
//
// What bounds it on the H100: at the training path's shapes (GPT-2 medium:
// B=10, H=16, D=64, T=1024, bf16, causal) the dq kernel does 3 products
// of T^2/2 x D per head (s, dp, dq) and the dkv kernel 4 (s, dp, dv, dk),
// 2 x D flops per causal (query, key) pair each, against 5 and 6 bf16
// T x D tensors per head read or written (plus lse and delta): ~300 and
// ~340 flops per byte, just above the ~295 ridge of the bf16 tensor cores
// (989 TFLOP/s over 3.35 TB/s), so the card's bound is operations, bytes
// close behind (chip_smoke.py's bound()). So the products belong on the
// tensor cores.
//
// The dk/dv kernel has two designs; the entry point takes the one
// flash_attention.py's flash_design(dtype, D) names:
//  - "wgmma", bf16 and fp16 at D = 64 and 128: one block per (batch * KV
//    head, 128-key tile), two consumer warpgroups of 64 keys each holding
//    their K and V rows in shared memory for the whole walk (64-key blocks
//    with one warpgroup where 128-key blocks would leave SMs idle, and at
//    D = 128, as in the forward: block_rows), and one producer warp that
//    runs a ring of 64-row Q and dO tiles by TMA (3-D maps, so a ragged Tq
//    zero-fills) for every query head of the group, from the diagonal on
//    under causal masking; its lanes copy the tile's lse (times log2 e) and
//    delta into the stage with plain loads (their rows are not 16-byte
//    aligned for a ragged Tq). Each step a warpgroup runs every product
//    transposed, so that each A operand is a K-major tile or registers:
//    S^T = K Q^T and dP^T = V dO^T as SS wgmma (Q and dO K-major), then
//    P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) on the fp32
//    accumulators (flash_sm90.cuh), masked at the diagonal and the ragged
//    edges, and dV += P^T dO and dK += dS^T Q as RS wgmma with P^T and dS^T
//    packed to 16 bits straight from the accumulators and dO, Q read
//    MN-major through the transpose-B bit: neither P nor dS touches shared
//    memory. The four products are four commit groups, so P^T is formed
//    while dP^T is computed and dS^T while dV is. dk is scaled and both are
//    rounded once, at the end. The tensor cores sum in another order than
//    the plain version, so dk and dv are no longer bit-equal to it (held to
//    the same relative limits).
//  - "fma", fp32 and D = 32, and the dq kernel in every case: 256 threads
//    per block, 64-row tiles kept in shared memory as fp32, each thread
//    owning a 4 x 4 block of the 64 x 64 score tile and a 4 x D/16 block of
//    the accumulators, the products on the FMA units. The dq kernel takes one
//    block per (batch * head, 64-row query tile) and walks key tiles up to
//    the diagonal under causal; the dkv kernel one block per (batch * KV
//    head, 64-row key tile) and walks query tiles from the diagonal on.
#include "common.cuh"
#include "flash_sm90.cuh"
#include "wgmma.cuh"

namespace dstorch {
namespace {

constexpr int kTile = 64;  // rows of every q, k, v, dO tile
constexpr int kThreads = 256;
constexpr int kLdS = kTile + 1;

template <int D> constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(4 * kTile * (D + 1) + kTile * kLdS);
}

template <int D> constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (size_t)(4 * kTile * (D + 1) + 2 * kTile * kLdS + 2 * kTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int Tq, int Tk, int H,
                int KV, float scale, int causal) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kLd = D + 1;
  constexpr int kDJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * kLd;
  float* Ks = dOs + kTile * kLd;
  float* Vs = Ks + kTile * kLd;
  float* dSs = Vs + kTile * kLd;

  const int m0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  const size_t q_row = (size_t)H * D;
  const size_t kv_row = (size_t)KV * D;
  const T* qb = q + ((size_t)b * Tq * H + h) * D;
  const T* ob = dout + ((size_t)b * Tq * H + h) * D;
  const T* kb = k + ((size_t)b * Tk * KV + kvh) * D;
  const T* vb = v + ((size_t)b * Tk * KV + kvh) * D;

  load_tile_f32<T, D, kThreads>(Qs, qb, q_row, m0, kTile, Tq);
  load_tile_f32<T, D, kThreads>(dOs, ob, q_row, m0, kTile, Tq);
  float row_lse[4], row_delta[4], acc[4][kDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    row_lse[i] = row < Tq ? lse[(size_t)bh * Tq + row] : 0.f;
    row_delta[i] = row < Tq ? delta[(size_t)bh * Tq + row] : 0.f;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) acc[i][j] = 0.f;
  }

  const int n_end = causal ? min(Tk, m0 + kTile) : Tk;
  for (int n0 = 0; n0 < n_end; n0 += kTile) {
    __syncthreads();  // the previous tile's readers are done with Ks/Vs/dSs
    load_tile_f32<T, D, kThreads>(Ks, kb, kv_row, n0, kTile, Tk);
    load_tile_f32<T, D, kThreads>(Vs, vb, kv_row, n0, kTile, Tk);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_score_tiles<D>(Qs, Ks, dOs, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx + 16 * j;
        const bool masked = col >= Tk || row >= Tq || (causal && col > row);
        const float p = masked ? 0.f : expf(s[i][j] * scale - row_lse[i]);
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= Tq) continue;
    T* drow = dq + (((size_t)b * Tq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) drow[tx + 16 * j] = from_float<T>(acc[i][j] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                 int Tq, int Tk, int H, int KV, float scale, int causal) {
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

  const int n0 = blockIdx.x * kTile;  // this block's key rows
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int group = H / KV;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // key rows ty*4 .. ty*4+3 of the tile
  const int tx = tid & 15;  // query columns tx + 16 j; accumulator columns tx + 16 j

  const size_t q_row = (size_t)H * D;
  const size_t kv_row = (size_t)KV * D;
  load_tile_f32<T, D, kThreads>(Ks, k + ((size_t)b * Tk * KV + kvh) * D, kv_row, n0, kTile, Tk);
  load_tile_f32<T, D, kThreads>(Vs, v + ((size_t)b * Tk * KV + kvh) * D, kv_row, n0, kTile, Tk);

  float dk_acc[4][kDJ], dv_acc[4][kDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causal: query rows before this key tile never attend to it
  const int m_begin = causal ? n0 : 0;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const size_t bh = (size_t)b * H + h;
    const T* qb = q + ((size_t)b * Tq * H + h) * D;
    const T* ob = dout + ((size_t)b * Tq * H + h) * D;
    for (int m0 = m_begin; m0 < Tq; m0 += kTile) {
      __syncthreads();  // the previous tile's readers are done with Qs/dOs/Ps/dSs
      load_tile_f32<T, D, kThreads>(Qs, qb, q_row, m0, kTile, Tq);
      load_tile_f32<T, D, kThreads>(dOs, ob, q_row, m0, kTile, Tq);
      if (tid < kTile) {
        const int row = m0 + tid;
        lse_s[tid] = row < Tq ? lse[bh * Tq + row] : 0.f;
        delta_s[tid] = row < Tq ? delta[bh * Tq + row] : 0.f;
      }
      __syncthreads();

      // transposed tiles: rows are keys, columns queries
      float s[4][4], dp[4][4];
      two_score_tiles<D>(Ks, Qs, Vs, dOs, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = n0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = tx + 16 * j;
          const int row = m0 + qc;
          const bool masked = row >= Tq || key >= Tk || (causal && key > row);
          const float p = masked ? 0.f : expf(s[i][j] * scale - lse_s[qc]);
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
    if (key >= Tk) continue;
    const size_t off = (((size_t)b * Tk + key) * KV + kvh) * D;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) {
      dk[off + tx + 16 * j] = from_float<T>(dk_acc[i][j] * scale);
      dv[off + tx + 16 * j] = from_float<T>(dv_acc[i][j]);
    }
  }
}

// ------------------------------------------------------- bf16 / fp16: wgmma
// (bwd::DqCfg and bwd::DkvCfg, the blocks' shapes and shared memory: flash_sm90.cuh)

// One block per (batch * head, query tile), the longest (bottom) tiles first;
// the producer warp loads the block's Q and dO tiles once and runs a ring of
// (K, V) tiles from key 0 to the diagonal. Each consumer warpgroup, per key
// tile: S = Q K^T and dP = dO V^T (SS, two commit groups), P and dS = P (dP -
// delta) on the accumulators, dS packed to k's dtype, dQ += dS K (RS, K read
// MN-major through the transpose-B bit), S and dP of the next tile issued
// behind it. dS never touches shared memory; dq is scaled and rounded once.
template <typename T, int D, int kWG>
__global__ void __launch_bounds__(bwd::DqCfg<D, kWG>::kThreads, 1)
flash_dq_wgmma(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap do_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dq, int Tq, int Tk, int H,
               int KV, float scale, int causal) {
  using namespace sm90;
  using C = bwd::DqCfg<D, kWG>;
  constexpr int kS = C::kStages, kBM = C::kBM, kBN = C::kBN;
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  const uint32_t qs = (smem_u32(smem_tiles) + 1023) & ~1023u, dos = qs + C::kQBytes;
  const uint32_t ring = dos + C::kQBytes;  // stage s: the K tile, then the V tile
  const uint32_t bars = ring + kS * 2 * C::kKBytes;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kS + s); };

  const int bh = blockIdx.x, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int m0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // the longest tiles launch first
  const int n_tiles = ((causal ? min(Tk, m0 + kBM) : Tk) + kBN - 1) / kBN;
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
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kS;
        const uint32_t ks = ring + s * 2 * C::kKBytes, vs = ks + C::kKBytes;
        mbar_wait(empty(s), ((it / kS) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), 2 * C::kKBytes);
        for (int x = 0; x < C::kBoxes; ++x) {
          tma_load_3d(ks + x * C::kKBox, &k_map, full(s), kvh * D + 64 * x, it * kBN, b);
          tma_load_3d(vs + x * C::kKBox, &v_map, full(s), kvh * D + 64 * x, it * kBN, b);
        }
      }
    }
  } else {  // consumers: warpgroup wgi owns query rows m0 + 64 wgi .. + 63
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, t = lane & 3;
    const int row_lo = m0 + wgi * 64;
    const int row0 = row_lo + warp * 16 + (lane >> 2);  // this thread's rows row0, row0 + 8
    const float scale_log2 = scale * attn::kLog2e;
    const uint32_t qa = qs + wgi * 64 * 128, oa = dos + wgi * 64 * 128;  // this warpgroup's rows
    // each thread's two rows' lse (times log2 e) and delta, once
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      lse2[r] = row < Tq ? lse[(size_t)bh * Tq + row] * attn::kLog2e : 0.f;
      dl[r] = row < Tq ? delta[(size_t)bh * Tq + row] : 0.f;
    }
    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
    float st[kBN / 2], dpt[kBN / 2];  // S, then P; dP, then dS (rows queries, columns keys)
    uint32_t da[kBN / 16][4];         // dS rounded to k's dtype: the A operand of dQ += dS K

    // S = Q K^T and dP = dO V^T of key tile it: two commit groups
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
      const int n0 = it * kBN;
      wgmma_wait<1>();  // S (and dQ += dS K of the tile before) done; dP may still run
      fence_regs(st);
      fence_regs(dq_acc);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) fence_regs(da[kk]);  // read until here
      if (it > 0 && lane == 0) mbar_arrive(empty((it - 1) % kS));
      const bool edge = n0 + kBN > Tk || row_lo + 64 > Tq || (causal && n0 + kBN - 1 > row_lo);
#pragma unroll
      for (int e = 0; e < kBN / 2; ++e) {
        const int r = attn::acc_half(e);
        const bool msk =
            edge && attn::masked(row0 + 8 * r, n0 + attn::acc_col(e, t), Tq, Tk, causal);
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
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < Tq)
        attn::store_acc_row<T, D>(dq + (((size_t)b * Tq + row) * H + h) * D, dq_acc, r, t, scale);
    }
  }
}

template <typename T, int D, int kWG>
__global__ void __launch_bounds__(bwd::DkvCfg<D, kWG>::kThreads, 1)
flash_dkv_wgmma(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap do_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Tq,
                int Tk, int H, int KV, float scale, int causal) {
  using namespace sm90;
  using C = bwd::DkvCfg<D, kWG>;
  constexpr int kS = C::kStages, kBM = bwd::kBM, kBN = C::kBN;
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  const uint32_t raw = smem_u32(smem_tiles);
  const uint32_t ks = (raw + 1023) & ~1023u, vs = ks + C::kKBytes;
  const uint32_t ring = vs + C::kKBytes;
  unsigned char* ring_ptr = smem_tiles + (ring - raw);
  const uint32_t bars = ring + kS * C::kStageBytes;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kS + s); };

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV, group = H / KV;
  const int n0 = blockIdx.y * kBN;  // the first key tile walks the most query tiles: first
  const int m_begin = causal ? n0 : 0;  // causal: earlier query rows never see these keys
  const int m_tiles = (Tq - m_begin + kBM - 1) / kBM;
  const int steps = group * m_tiles;  // every query head of the group, each from m_begin
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
          tma_load_3d(ks + x * C::kKBox, &k_map, kv_full, kvh * D + 64 * x, n0, b);
          tma_load_3d(vs + x * C::kKBox, &v_map, kv_full, kvh * D + 64 * x, n0, b);
        }
      }
      for (int it = 0; it < steps; ++it) {
        const int h = kvh * group + it / m_tiles, m0 = m_begin + (it % m_tiles) * kBM;
        const int s = it % kS;
        const uint32_t st = ring + s * C::kStageBytes;
        float* stats = reinterpret_cast<float*>(ring_ptr + s * C::kStageBytes + 2 * C::kQBytes);
        const size_t at = ((size_t)b * H + h) * Tq;
        mbar_wait(empty(s), ((it / kS) & 1) ^ 1);
        for (int r = lane; r < kBM; r += 32) {
          const int row = m0 + r;
          stats[r] = row < Tq ? lse[at + row] * attn::kLog2e : 0.f;
          stats[kBM + r] = row < Tq ? delta[at + row] : 0.f;
        }
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
  } else {  // consumers: warpgroup wgi owns keys n0 + 64 wgi .. + 63
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, t = lane & 3;
    const int key_lo = n0 + wgi * 64;
    const int key0 = key_lo + warp * 16 + (lane >> 2);  // this thread's keys key0, key0 + 8
    const float scale_log2 = scale * attn::kLog2e;
    const uint32_t ka = ks + wgi * 64 * 128, va = vs + wgi * 64 * 128;  // this warpgroup's rows
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(kv_full, 0);
    for (int it = 0; it < steps; ++it) {
      const int m0 = m_begin + (it % m_tiles) * kBM, s = it % kS;
      const uint32_t qt = ring + s * C::kStageBytes, dot = qt + C::kQBytes;
      const float* stats =
          reinterpret_cast<const float*>(ring_ptr + s * C::kStageBytes + 2 * C::kQBytes);
      mbar_wait(full(s), (it / kS) & 1);
      // causal: a query tile wholly before this warpgroup's keys adds nothing
      if (!causal || m0 + kBM - 1 >= key_lo) {
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
        const bool edge = m0 + kBM > Tq || key_lo + 64 > Tk || (causal && key_lo + 63 > m0);
        wgmma_wait<1>();  // S^T is done; dP^T may still run
        fence_regs(st);
#pragma unroll
        for (int j = 0; j < kBM / 8; ++j) {  // query columns 8j + 2t, +1
          const float2 l2 = *reinterpret_cast<const float2*>(stats + 8 * j + 2 * t);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = 4 * j + i, qc = attn::acc_col(e, t);
            const bool msk =
                edge && attn::masked(m0 + qc, key0 + 8 * attn::acc_half(e), Tq, Tk, causal);
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
      const int key = key0 + 8 * r;
      if (key >= Tk) continue;
      const size_t off = (((size_t)b * Tk + key) * KV + kvh) * D;
      attn::store_acc_row<T, D>(dk + off, dk_acc, r, t, scale);
      attn::store_acc_row<T, D>(dv + off, dv_acc, r, t, 1.f);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool* configured) {
  if (*configured) return cudaSuccess;  // the attribute is per kernel, set once
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *configured = true;
  return err;
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, Tq, Tk, H, KV;
  float scale;
  int causal;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a, void* dq, cudaStream_t stream) {
  constexpr size_t kSmem = dq_smem_bytes<D>();
  static bool configured = false;
  cudaError_t err = allow_smem(flash_dq_kernel<T, D>, kSmem, &configured);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Tq + kTile - 1) / kTile, a.B * a.H);
  flash_dq_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(dq), a.Tq, a.Tk, a.H,
      a.KV, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv, cudaStream_t stream) {
  constexpr size_t kSmem = dkv_smem_bytes<D>();
  static bool configured = false;
  cudaError_t err = allow_smem(flash_dkv_kernel<T, D>, kSmem, &configured);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Tk + kTile - 1) / kTile, a.B * a.KV);
  flash_dkv_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(dk), static_cast<T*>(dv),
      a.Tq, a.Tk, a.H, a.KV, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D, int kWG>
cudaError_t launch_dkv_wgmma(const Args& a, void* dk, void* dv, cudaStream_t stream) {
  using C = bwd::DkvCfg<D, kWG>;
  constexpr bool kBf16 = sm90::WgmmaType<T>::kBf16;
  static bool configured = false;
  cudaError_t err = allow_smem(flash_dkv_wgmma<T, D, kWG>, C::kSmem, &configured);
  if (err != cudaSuccess) return err;
  CUtensorMap q_map, do_map, k_map, v_map;
  const uint64_t qw = (uint64_t)a.H * D, kw = (uint64_t)a.KV * D;
  err = encode_tma_3d(&q_map, kBf16, a.q, a.B, a.Tq, qw, bwd::kBM);
  if (err == cudaSuccess) err = encode_tma_3d(&do_map, kBf16, a.dout, a.B, a.Tq, qw, bwd::kBM);
  if (err == cudaSuccess) err = encode_tma_3d(&k_map, kBf16, a.k, a.B, a.Tk, kw, C::kBN);
  if (err == cudaSuccess) err = encode_tma_3d(&v_map, kBf16, a.v, a.B, a.Tk, kw, C::kBN);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.KV, (a.Tk + C::kBN - 1) / C::kBN);
  flash_dkv_wgmma<T, D, kWG><<<grid, C::kThreads, C::kSmem, stream>>>(
      q_map, do_map, k_map, v_map, a.lse, a.delta, static_cast<T*>(dk), static_cast<T*>(dv),
      a.Tq, a.Tk, a.H, a.KV, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D, int kWG>
cudaError_t launch_dq_wgmma(const Args& a, void* dq, cudaStream_t stream) {
  using C = bwd::DqCfg<D, kWG>;
  constexpr bool kBf16 = sm90::WgmmaType<T>::kBf16;
  static bool configured = false;
  cudaError_t err = allow_smem(flash_dq_wgmma<T, D, kWG>, C::kSmem, &configured);
  if (err != cudaSuccess) return err;
  CUtensorMap q_map, do_map, k_map, v_map;
  const uint64_t qw = (uint64_t)a.H * D, kw = (uint64_t)a.KV * D;
  err = encode_tma_3d(&q_map, kBf16, a.q, a.B, a.Tq, qw, C::kBM);
  if (err == cudaSuccess) err = encode_tma_3d(&do_map, kBf16, a.dout, a.B, a.Tq, qw, C::kBM);
  if (err == cudaSuccess) err = encode_tma_3d(&k_map, kBf16, a.k, a.B, a.Tk, kw, C::kBN);
  if (err == cudaSuccess) err = encode_tma_3d(&v_map, kBf16, a.v, a.B, a.Tk, kw, C::kBN);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.H, (a.Tq + C::kBM - 1) / C::kBM);
  flash_dq_wgmma<T, D, kWG><<<grid, C::kThreads, C::kSmem, stream>>>(
      q_map, do_map, k_map, v_map, a.lse, a.delta, static_cast<T*>(dq), a.Tq, a.Tk, a.H, a.KV,
      a.scale, a.causal);
  return cudaGetLastError();
}

// kWG: 2 (128-row blocks) or 1 (64-row blocks; flash_attention.py chooses)
template <typename T>
cudaError_t dq_wgmma_dim(int D, int kWG, const Args& a, void* dq, cudaStream_t st) {
  if (D == 64 && kWG == 2) return launch_dq_wgmma<T, 64, 2>(a, dq, st);
  if (D == 64 && kWG == 1) return launch_dq_wgmma<T, 64, 1>(a, dq, st);
  if (D == 128 && kWG == 2) return launch_dq_wgmma<T, 128, 2>(a, dq, st);
  if (D == 128 && kWG == 1) return launch_dq_wgmma<T, 128, 1>(a, dq, st);
  return cudaErrorInvalidValue;
}

// kWG: 2 (128-key blocks) or 1 (64-key blocks; flash_attention.py chooses)
template <typename T>
cudaError_t dkv_wgmma_dim(int D, int kWG, const Args& a, void* dk, void* dv, cudaStream_t st) {
  if (D == 64 && kWG == 2) return launch_dkv_wgmma<T, 64, 2>(a, dk, dv, st);
  if (D == 64 && kWG == 1) return launch_dkv_wgmma<T, 64, 1>(a, dk, dv, st);
  if (D == 128 && kWG == 2) return launch_dkv_wgmma<T, 128, 2>(a, dk, dv, st);
  if (D == 128 && kWG == 1) return launch_dkv_wgmma<T, 128, 1>(a, dk, dv, st);
  return cudaErrorInvalidValue;
}

// one of the two launches above, for a dtype code and head dim
template <typename T>
cudaError_t dispatch_dim(int D, bool dkv, const Args& a, void* o1, void* o2,
                         cudaStream_t st) {
  switch (D) {
    case 32: return dkv ? launch_dkv<T, 32>(a, o1, o2, st) : launch_dq<T, 32>(a, o1, st);
    case 64: return dkv ? launch_dkv<T, 64>(a, o1, o2, st) : launch_dq<T, 64>(a, o1, st);
    case 128: return dkv ? launch_dkv<T, 128>(a, o1, o2, st) : launch_dq<T, 128>(a, o1, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int dtype, int D, bool dkv, const Args& a, void* o1, void* o2,
                     cudaStream_t st) {
  if (a.B <= 0 || a.Tq <= 0 || a.Tk <= 0 || a.H <= 0 || a.KV <= 0 || a.H % a.KV != 0)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case kFloat32: return dispatch_dim<float>(D, dkv, a, o1, o2, st);
    case kBFloat16: return dispatch_dim<__nv_bfloat16>(D, dkv, a, o1, o2, st);
    case kFloat16: return dispatch_dim<__half>(D, dkv, a, o1, o2, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dstorch

// C entry points bound with ctypes. Each returns its launch's cudaGetLastError().
// design: 0 the FMA kernel (every dtype, D 32, 64, 128); 1 the wgmma kernel
// with 128-row blocks (query rows for dq, keys for dk/dv), 2 with 64-row
// blocks (bf16 and fp16, D 64 and 128); flash_attention.py's flash_design and
// block_rows choose. Any other design, or a wgmma design for another dtype or
// D, is refused.
extern "C" int dstorch_flash_attention_dq(int dtype, int design, const void* q, const void* k,
                                          const void* v, const void* dout, const void* lse,
                                          const void* delta, void* dq, int B, int Tq, int Tk,
                                          int H, int KV, int D, float scale, int causal,
                                          void* stream) {
  using namespace dstorch;
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), B, Tq, Tk, H, KV, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (design == 0) return (int)dispatch(dtype, D, false, a, dq, nullptr, st);
  if ((design != 1 && design != 2) || B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || KV <= 0 ||
      H % KV != 0)
    return (int)cudaErrorInvalidValue;
  const int wgs = design == 1 ? 2 : 1;
  switch (dtype) {
    case kBFloat16: return (int)dq_wgmma_dim<__nv_bfloat16>(D, wgs, a, dq, st);
    case kFloat16: return (int)dq_wgmma_dim<__half>(D, wgs, a, dq, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int dstorch_flash_attention_dkv(int dtype, int design, const void* q, const void* k,
                                           const void* v, const void* dout, const void* lse,
                                           const void* delta, void* dk, void* dv, int B,
                                           int Tq, int Tk, int H, int KV, int D, float scale,
                                           int causal, void* stream) {
  using namespace dstorch;
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), B, Tq, Tk, H, KV, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (design == 0) return (int)dispatch(dtype, D, true, a, dk, dv, st);
  if ((design != 1 && design != 2) || B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || KV <= 0 ||
      H % KV != 0)
    return (int)cudaErrorInvalidValue;
  const int wgs = design == 1 ? 2 : 1;
  switch (dtype) {
    case kBFloat16: return (int)dkv_wgmma_dim<__nv_bfloat16>(D, wgs, a, dk, dv, st);
    case kFloat16: return (int)dkv_wgmma_dim<__half>(D, wgs, a, dk, dv, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
