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
// close behind (chip_smoke.py's bound()). These kernels run their products
// on the fp32 FMA units, 15x below the tensor cores, so those bound them.
// They are deliberately simple and correct rather than fast, in the forward
// kernel's shape: 256 threads per block, 64-row tiles kept in shared memory
// as fp32, each thread owning a 4 x 4 block of the 64 x 64 score tile and a
// 4 x D/16 block of the accumulators. The dq kernel takes one block per
// (batch * head, 64-row query tile) and walks key tiles up to the diagonal
// under causal; the dkv kernel one block per (batch * KV head, 64-row key
// tile) and walks query tiles from the diagonal on. wgmma with TMA-fed
// tiles is later work; PERF.md records the gap to the bound.
#include "common.cuh"

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
extern "C" int dstorch_flash_attention_dq(int dtype, const void* q, const void* k,
                                          const void* v, const void* dout, const void* lse,
                                          const void* delta, void* dq, int B, int Tq, int Tk,
                                          int H, int KV, int D, float scale, int causal,
                                          void* stream) {
  const dstorch::Args a{q, k, v, dout, static_cast<const float*>(lse),
                        static_cast<const float*>(delta), B, Tq, Tk, H, KV, scale, causal};
  return (int)dstorch::dispatch(dtype, D, false, a, dq, nullptr,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int dstorch_flash_attention_dkv(int dtype, const void* q, const void* k,
                                           const void* v, const void* dout, const void* lse,
                                           const void* delta, void* dk, void* dv, int B,
                                           int Tq, int Tk, int H, int KV, int D, float scale,
                                           int causal, void* stream) {
  const dstorch::Args a{q, k, v, dout, static_cast<const float*>(lse),
                        static_cast<const float*>(delta), B, Tq, Tk, H, KV, scale, causal};
  return (int)dstorch::dispatch(dtype, D, true, a, dk, dv, static_cast<cudaStream_t>(stream));
}
