// Fused LayerNorm -> Linear, forward and backward-dx, for Hopper (sm_90a).
//
// Replaces the TPU kernels deepspeed_tpu/ops/transformer/ln_linear.py::
// _fwd_kernel (:52, pallas_call at :121) and _bwd_dx_kernel (:75,
// pallas_call at :159).
//
// Forward: y = (LN(x) * gamma + beta) W^T + b for x (M, C), W (N, C) in the
// nn.Linear layout (the JAX kernel takes W as (C, N)), with fp32 row
// statistics mean and rstd (M,) written for the backward. A block owns 32
// rows: it computes their statistics (two passes over each row, as the TPU
// kernel: var = mean((x - mean)^2)), writes the normalized, gamma/beta-
// applied rows into shared memory rounded to x's dtype (the TPU kernel's
// scratch dtype), and then runs the product for 4 tiles of 128 output
// columns straight off that tile, so LN(x) never reaches device memory.
// Sums are fp32; y adds the bias in fp32 and rounds once.
//
// Backward-dx: dn = dy W accumulates in an fp32 (32, C) tile in shared
// memory, 128 columns at a time over 32-wide chunks of N; then the
// LayerNorm backward runs in-kernel from the saved statistics:
//   xh = (x - mean) * rstd,  dxh = dn * gamma,
//   dx = rstd * (dxh - mean_C(dxh) - xh * mean_C(dxh * xh))
// (the TPU kernel's formula, :96-99), and the block writes its rows' sums
// of dn * xh and of dn (one row of dgamma and dbeta partials per block,
// summed by the caller). dn never reaches device memory.
//
// What a block can tile is the shape gate: C a multiple of 32 (16-byte row
// loads, 32-wide chunks) and a (32, C) fp32 tile of dn within the 227 KB of
// shared memory, so C <= 1536; any M and N (ragged edges are masked).
//
// What bounds it on the H100: at GPT-2 medium's training shapes (M = 10240
// rows, C = 1024, N = 3072 for qkv and 4096 for fc, bf16) each kernel is a
// product of 2 M C N flops over (M C + N C + M N) elements: ~600 flops a
// byte, above the ~295 ridge of the bf16 tensor cores, so the card's bound
// is operations. These kernels run the product on the fp32 FMA units, 15x
// below the tensor cores (each thread owns a 4 x 4 output block and reads
// its A values as shared-memory broadcasts and its B values as one float4
// per k), which bounds them. wgmma with TMA-fed tiles is later work;
// PERF.md records the gap to the bound.
#include "common.cuh"

namespace dstorch {
namespace {

constexpr int kBM = 32;       // rows per block
constexpr int kBN = 128;      // output columns per tile
constexpr int kBK = 32;       // reduction chunk
constexpr int kLdW = kBN + 4; // padded row of the (kBK, kBN) fp32 B tile
constexpr int kLdD = kBK + 1;
constexpr int kFwdTiles = 4;  // output tiles per forward block
constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // the H100's opt-in limit a block

constexpr size_t kWBytes = sizeof(float) * kBK * kLdW;

template <typename T> size_t fwd_smem_bytes(int C) { return kWBytes + sizeof(T) * kBM * C; }
inline size_t bwd_smem_bytes(int C) {
  return kWBytes + sizeof(float) * ((size_t)kBM * C + kBM * kLdD + 4 * kBM);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// acc[i][j] += A[ty*4+i][k] * B[k][tx*4+j] over one kBK chunk: A rows are
// warp-uniform (broadcast reads), B one float4 per k per thread
template <typename LoadA>
__device__ __forceinline__ void mma_chunk(LoadA a_at, const float* Ws, int ty, int tx,
                                          float acc[4][4]) {
#pragma unroll 8
  for (int kk = 0; kk < kBK; ++kk) {
    const float4 bv = *reinterpret_cast<const float4*>(Ws + kk * kLdW + tx * 4);
    const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = a_at(ty * 4 + i, kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += a * b[j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_linear_fwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                     const T* __restrict__ beta, const T* __restrict__ w,
                     const T* __restrict__ bias, T* __restrict__ y, float* __restrict__ mean,
                     float* __restrict__ rstd, int M, int C, int N, float eps) {
  constexpr int kVec = Vec<T>::kN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ws = reinterpret_cast<float*>(smem_raw);
  T* As = reinterpret_cast<T*>(smem_raw + kWBytes);

  const int m0 = blockIdx.x * kBM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // statistics and the normalized rows: warp w owns rows 4w .. 4w+3
  for (int r = warp * 4; r < warp * 4 + 4; ++r) {
    const int row = m0 + r;
    T* arow = As + (size_t)r * C;
    if (row >= M) {
      for (int c = lane; c < C; c += 32) arow[c] = from_float<T>(0.f);
      continue;
    }
    const T* xrow = x + (size_t)row * C;
    float s = 0.f;
    for (int c = lane * kVec; c < C; c += 32 * kVec) {
      float v[kVec];
      load_vec(xrow + c, v);
#pragma unroll
      for (int i = 0; i < kVec; ++i) s += v[i];
    }
    const float mu = warp_sum(s) / C;
    float ss = 0.f;
    for (int c = lane * kVec; c < C; c += 32 * kVec) {
      float v[kVec];
      load_vec(xrow + c, v);
#pragma unroll
      for (int i = 0; i < kVec; ++i) ss += (v[i] - mu) * (v[i] - mu);
    }
    const float rs = rsqrtf(warp_sum(ss) / C + eps);
    for (int c = lane * kVec; c < C; c += 32 * kVec) {
      float v[kVec], g[kVec], b[kVec];
      load_vec(xrow + c, v);
      load_vec(gamma + c, g);
      load_vec(beta + c, b);
#pragma unroll
      for (int i = 0; i < kVec; ++i) arow[c + i] = from_float<T>((v[i] - mu) * rs * g[i] + b[i]);
    }
    if (blockIdx.y == 0 && lane == 0) {
      mean[row] = mu;
      rstd[row] = rs;
    }
  }
  __syncthreads();

  const int ty = tid >> 5, tx = tid & 31;  // rows ty*4 .. +3, columns tx*4 .. +3
  auto a_at = [&](int r, int kk) { return to_float(As[(size_t)r * C + kk]); };
  for (int t = 0; t < kFwdTiles; ++t) {
    const int n0 = (blockIdx.y * kFwdTiles + t) * kBN;
    if (n0 >= N) break;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < C; k0 += kBK) {
      // W rows n0 .. n0+127, columns k0 .. k0+31, transposed into Ws[k][n]
      for (int v = tid; v < kBN * kBK / kVec; v += kThreads) {
        const int nr = v / (kBK / kVec), kc = (v % (kBK / kVec)) * kVec;
        float vals[kVec];
        if (n0 + nr < N) {
          load_vec(w + (size_t)(n0 + nr) * C + k0 + kc, vals);
        } else {
#pragma unroll
          for (int i = 0; i < kVec; ++i) vals[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < kVec; ++i) Ws[(kc + i) * kLdW + nr] = vals[i];
      }
      __syncthreads();
      mma_chunk([&](int r, int kk) { return a_at(r, k0 + kk); }, Ws, ty, tx, acc);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx * 4 + j;
        if (col < N)
          y[(size_t)row * N + col] = from_float<T>(acc[i][j] + to_float(bias[col]));
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_linear_bwd_dx_kernel(const T* __restrict__ dy, const T* __restrict__ w,
                        const T* __restrict__ x, const T* __restrict__ gamma,
                        const float* __restrict__ mean, const float* __restrict__ rstd,
                        T* __restrict__ dx, float* __restrict__ dg_parts,
                        float* __restrict__ db_parts, int M, int C, int N) {
  constexpr int kVec = Vec<T>::kN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ws = reinterpret_cast<float*>(smem_raw);
  float* dn = Ws + kBK * kLdW;     // (kBM, C)
  float* Ds = dn + (size_t)kBM * C;  // (kBM, kBK + 1) chunk of dy
  float* mean_s = Ds + kBM * kLdD;
  float* rstd_s = mean_s + kBM;
  float* m1_s = rstd_s + kBM;
  float* m2_s = m1_s + kBM;

  const int m0 = blockIdx.x * kBM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 5, tx = tid & 31;

  // dn = dy W, 128 columns at a time
  for (int c0 = 0; c0 < C; c0 += kBN) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < N; k0 += kBK) {
      for (int idx = tid; idx < kBM * kBK; idx += kThreads) {
        const int r = idx / kBK, kk = idx % kBK;
        const int row = m0 + r, col = k0 + kk;
        Ds[r * kLdD + kk] = (row < M && col < N) ? to_float(dy[(size_t)row * N + col]) : 0.f;
      }
      for (int v = tid; v < kBK * kBN / kVec; v += kThreads) {
        const int kr = v / (kBN / kVec), cc = (v % (kBN / kVec)) * kVec;
        float vals[kVec];
        if (k0 + kr < N && c0 + cc < C) {
          load_vec(w + (size_t)(k0 + kr) * C + c0 + cc, vals);
        } else {
#pragma unroll
          for (int i = 0; i < kVec; ++i) vals[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < kVec; ++i) Ws[kr * kLdW + cc + i] = vals[i];
      }
      __syncthreads();
      mma_chunk([&](int r, int kk) { return Ds[r * kLdD + kk]; }, Ws, ty, tx, acc);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx * 4 + j;
        if (c < C) dn[(ty * 4 + i) * C + c] = acc[i][j];
      }
  }
  __syncthreads();

  // per-row means of dxh and dxh * xh: warp w owns rows 4w .. 4w+3
  for (int r = warp * 4; r < warp * 4 + 4; ++r) {
    const int row = m0 + r;
    if (row >= M) {
      if (lane == 0) mean_s[r] = rstd_s[r] = m1_s[r] = m2_s[r] = 0.f;
      continue;
    }
    const float mu = mean[row], rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float xh = (to_float(x[(size_t)row * C + c]) - mu) * rs;
      const float dxh = dn[r * C + c] * to_float(gamma[c]);
      s1 += dxh;
      s2 += dxh * xh;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      mean_s[r] = mu;
      rstd_s[r] = rs;
      m1_s[r] = s1 / C;
      m2_s[r] = s2 / C;
    }
  }
  __syncthreads();

  // dx, and this block's rows of the dgamma / dbeta partial sums
  for (int c = tid; c < C; c += kThreads) {
    const float g = to_float(gamma[c]);
    float dg = 0.f, db = 0.f;
    for (int r = 0; r < kBM; ++r) {
      const int row = m0 + r;
      if (row >= M) break;
      const float xh = (to_float(x[(size_t)row * C + c]) - mean_s[r]) * rstd_s[r];
      const float d = dn[r * C + c];
      dg += d * xh;
      db += d;
      dx[(size_t)row * C + c] = from_float<T>(rstd_s[r] * (d * g - m1_s[r] - xh * m2_s[r]));
    }
    dg_parts[(size_t)blockIdx.x * C + c] = dg;
    db_parts[(size_t)blockIdx.x * C + c] = db;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool* configured) {
  if (*configured) return cudaSuccess;  // the attribute is per kernel, set once
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) *configured = true;
  return err;
}

bool shape_ok(int M, int C, int N) { return M > 0 && N > 0 && C > 0 && C % kBK == 0; }

template <typename T>
cudaError_t launch_fwd(const void* x, const void* g, const void* b, const void* w,
                       const void* bias, void* y, float* mean, float* rstd, int M, int C,
                       int N, float eps, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<T>(C);
  if (!shape_ok(M, C, N) || smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  static bool configured = false;
  cudaError_t err = allow_smem(ln_linear_fwd_kernel<T>, &configured);
  if (err != cudaSuccess) return err;
  dim3 grid((M + kBM - 1) / kBM, (N + kBN * kFwdTiles - 1) / (kBN * kFwdTiles));
  ln_linear_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(b),
      static_cast<const T*>(w), static_cast<const T*>(bias), static_cast<T*>(y), mean, rstd,
      M, C, N, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* dy, const void* w, const void* x, const void* g,
                       const float* mean, const float* rstd, void* dx, float* dg_parts,
                       float* db_parts, int M, int C, int N, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(C);
  if (!shape_ok(M, C, N) || smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  static bool configured = false;
  cudaError_t err = allow_smem(ln_linear_bwd_dx_kernel<T>, &configured);
  if (err != cudaSuccess) return err;
  ln_linear_bwd_dx_kernel<T><<<(M + kBM - 1) / kBM, kThreads, smem, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(w), static_cast<const T*>(x),
      static_cast<const T*>(g), mean, rstd, static_cast<T*>(dx), dg_parts, db_parts, M, C, N);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dstorch

// C entry points bound with ctypes. Each returns its launch's cudaGetLastError().
extern "C" int dstorch_ln_linear_fwd(int dtype, const void* x, const void* gamma,
                                     const void* beta, const void* w, const void* bias,
                                     void* y, void* mean, void* rstd, int M, int C, int N,
                                     float eps, void* stream) {
  using namespace dstorch;
  float *mu = static_cast<float*>(mean), *rs = static_cast<float*>(rstd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return (int)launch_fwd<float>(x, gamma, beta, w, bias, y, mu, rs, M, C, N, eps, st);
    case kBFloat16:
      return (int)launch_fwd<__nv_bfloat16>(x, gamma, beta, w, bias, y, mu, rs, M, C, N, eps,
                                            st);
    case kFloat16:
      return (int)launch_fwd<__half>(x, gamma, beta, w, bias, y, mu, rs, M, C, N, eps, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int dstorch_ln_linear_bwd_dx(int dtype, const void* dy, const void* w,
                                        const void* x, const void* gamma, const void* mean,
                                        const void* rstd, void* dx, void* dg_parts,
                                        void* db_parts, int M, int C, int N, void* stream) {
  using namespace dstorch;
  const float *mu = static_cast<const float*>(mean), *rs = static_cast<const float*>(rstd);
  float *dg = static_cast<float*>(dg_parts), *db = static_cast<float*>(db_parts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return (int)launch_bwd<float>(dy, w, x, gamma, mu, rs, dx, dg, db, M, C, N, st);
    case kBFloat16:
      return (int)launch_bwd<__nv_bfloat16>(dy, w, x, gamma, mu, rs, dx, dg, db, M, C, N, st);
    case kFloat16:
      return (int)launch_bwd<__half>(dy, w, x, gamma, mu, rs, dx, dg, db, M, C, N, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
