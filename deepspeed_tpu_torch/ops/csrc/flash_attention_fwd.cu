// Flash-attention forward (out and per-row log-sum-exp), for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/attention/flash_attention.py::
// _flash_fwd (:140), which holds two pallas_calls computing the same
// function: _fwd_single_kernel (:150, one KV block) and _fwd_kernel (:176,
// online softmax over KV blocks).
// It computes causal or non-causal softmax(q k^T * scale) v with fp32
// statistics; p is rounded to the input dtype before the PV product (the
// FA2 discipline the TPU kernel follows), and lse = m + log(max(l, 1e-30))
// keeps fully masked rows finite.
//
// Layout: q (B, Tq, H, D), k/v (B, Tk, KV, D) with H % KV == 0 (grouped-query
// heads are mapped in the kernel, h -> h / (H / KV), so the caller never
// repeats K/V); out (B, Tq, H, D); lse (B, H, Tq) fp32.
//
// What bounds it on the H100: at the serving path's prefill shapes (B=1,
// H=12, D=64, bf16, T up to 1024) the two products do 4 * T^2 * D / 2 flops
// per head causally against 4 * T * D * 2 bytes of input and output, T / 4
// flops per byte: 256 at T = 1024, just under the ~295 ridge of the bf16
// tensor cores, so the card's bound is bytes at every bucket width, with
// operations close behind at T = 1024. This version runs its products on
// the fp32 FMA units, whose peak is 15x below the tensor cores', so those
// bound it. It is deliberately simple and correct rather than fast: one
// block of 256 threads per (batch * head, 64-row query tile) walks 64-row
// key tiles kept in shared memory as fp32, computes S = Q K^T and P V with
// plain FMA (each thread owns a 4 x 4 block of S and a 4 x D/16 block of the
// accumulator), keeps the online softmax in registers and skips key tiles
// above the diagonal. wgmma with TMA-fed tiles is later work, and the gap to
// the bound is recorded in PERF.md.
#include "common.cuh"

namespace dstorch {
namespace {

constexpr int kBM = 64;       // query rows per block
constexpr int kBN = 64;       // key rows per tile
constexpr int kThreads = 256;
constexpr int kLdP = kBN + 1;

template <int D> constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(kBM * (D + 1) + 2 * kBN * (D + 1) + kBM * kLdP);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                 int Tq, int Tk, int H, int KV, float scale, int causal) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kLd = D + 1;
  constexpr int kDJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBM * kLd;
  float* Vs = Ks + kBN * kLd;
  float* Ps = Vs + kBN * kLd;

  const int m0 = blockIdx.x * kBM;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid & 15;  // S columns tx + 16 j; accumulator columns tx + 16 j

  const size_t q_row = (size_t)H * D;
  const size_t kv_row = (size_t)KV * D;
  const T* qb = q + ((size_t)b * Tq * H + h) * D;
  const T* kb = k + ((size_t)b * Tk * KV + kvh) * D;
  const T* vb = v + ((size_t)b * Tk * KV + kvh) * D;

  load_tile_f32<T, D, kThreads>(Qs, qb, q_row, m0, kBM, Tq);

  float m_i[4], l_i[4], acc[4][kDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) acc[i][j] = 0.f;
  }

  const int n_end = causal ? min(Tk, m0 + kBM) : Tk;
  for (int n0 = 0; n0 < n_end; n0 += kBN) {
    __syncthreads();  // the previous tile's readers are done with Ks/Vs/Ps
    load_tile_f32<T, D, kThreads>(Ks, kb, kv_row, n0, kBN, Tk);
    load_tile_f32<T, D, kThreads>(Vs, vb, kv_row, n0, kBN, Tk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * kLd + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = Ks[(tx + 16 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += a[i] * kk[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
      bool masked[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx + 16 * j;
        masked[j] = col >= Tk || (causal && col > row);
        s[i][j] = masked[j] ? kNegInf : s[i][j] * scale;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 lanes holding one row are one aligned half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = masked[j] ? 0.f : expf(s[i][j] - m_new);
        rs += p;
        Ps[(ty * 4 + i) * kLdP + tx + 16 * j] = round_through<T>(p);
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
    for (int n = 0; n < kBN; ++n) {
      float p[4], vv[kDJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * kLdP + n];
#pragma unroll
      for (int j = 0; j < kDJ; ++j) vv[j] = Vs[n * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDJ; ++j) acc[i][j] += p[i] * vv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= Tq) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
    T* orow = out + (((size_t)b * Tq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) orow[tx + 16 * j] = from_float<T>(acc[i][j] / l);
    if (tx == 0) lse[(size_t)bh * Tq + row] = m_i[i] + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   int B, int Tq, int Tk, int H, int KV, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t kSmem = smem_bytes<D>();
  static bool configured = false;  // the attribute is per kernel, set once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((Tq + kBM - 1) / kBM, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, Tq, Tk, H, KV, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int D, const void* q, const void* k, const void* v, void* out,
                       float* lse, int B, int Tq, int Tk, int H, int KV, float scale,
                       int causal, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, lse, B, Tq, Tk, H, KV, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, out, lse, B, Tq, Tk, H, KV, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, out, lse, B, Tq, Tk, H, KV, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dstorch

// C entry point bound with ctypes. Returns the launch's cudaGetLastError().
extern "C" int dstorch_flash_attention_fwd(int dtype, const void* q, const void* k,
                                           const void* v, void* out, void* lse, int B,
                                           int Tq, int Tk, int H, int KV, int D,
                                           float scale, int causal, void* stream) {
  using namespace dstorch;
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return (int)launch_dim<float>(D, q, k, v, out, l, B, Tq, Tk, H, KV, scale, causal, st);
    case kBFloat16:
      return (int)launch_dim<__nv_bfloat16>(D, q, k, v, out, l, B, Tq, Tk, H, KV, scale, causal, st);
    case kFloat16:
      return (int)launch_dim<__half>(D, q, k, v, out, l, B, Tq, Tk, H, KV, scale, causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
