// Int8-weight matmul with the dequantization fused in, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/quantization/int8_matmul.py::
// _int8_matmul_2d (pallas_call at :152, kernel body _kernel at :114). It computes
//
//   y[m, n] = cast(scale[n] * sum_k bf16(x[m, k]) * w[n, k])
//
// with an fp32 accumulator and the per-output-channel scale applied once, at the
// end, as the TPU kernel applies it at flush. x is rounded to bf16 first (the JAX
// contract); an int8 weight is exact in bf16 and a bf16 x int8 product is exact in
// fp32, so only the order of the fp32 sums differs from the plain version.
//
// Layout: x (M, K) fp32, bf16 or fp16 (code in xdtype); w (N, K) int8, row-major
// like nn.Linear.weight, so one output channel's K weights are contiguous; scale
// (N,) fp32; y (M, N) in the dtype of ydtype. The TPU kernel stored w as (K, N)
// with N on the lanes; here a row of w is what a warp streams.
//
// What bounds it on the H100:
//   * decode (M <= 16, a GEMV in practice): bytes. Every weight is read once and
//     used for M products, so the weights' N * K bytes are the traffic. The kernel
//     streams each weight row once with 16-byte loads (16 int8 a lane), issues all
//     of a sweep's loads before unpacking any (a load whose conversion sits in its
//     own branch waits for the one before it, see paged_decode_attention.cu), and
//     converts int8 -> fp32 with a byte permute and one add instead of I2F. The x
//     rows sit in shared memory as bf16-rounded floats, laid out so that a warp's
//     reads hit 32 distinct banks (xs_offset), read once per 16 weights and
//     shared by the 4 output channels a warp computes; 8 warps share each tile.
//     What holds it above its bound: at M = 8 the CUDA cores issue ~12
//     operations per weight byte (8 FMAs, the unpacking, the x reads), and each
//     1024-deep tile waits for its x and then its weight loads with one block on
//     an SM. Tensor cores (mma.sync with int8 -> bf16 B fragments) and a deeper
//     load pipeline are the levers, later work.
//   * prefill chunks and admissions (M > 16): against the tensor cores' peak
//     still bytes at M = 64, operations from a few hundred rows. A plain 32 x 64
//     tiled shared-memory product on the CUDA cores in fp32 with
//     register-prefetched 16-byte loads, so its own limit is that arithmetic;
//     mma.sync / wgmma is later work.
// Any M, K and N: ragged tiles are masked; a K that is not a multiple of 16 (or an
// unaligned x or w) takes a scalar-load tiled kernel.
#include "common.cuh"

namespace dstorch {
namespace {

// ---------------------------------------------------------------- helpers
__device__ __forceinline__ void store_as(void* y, int code, size_t i, float v) {
  switch (code) {
    case kBFloat16: static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16(v); break;
    case kFloat16: static_cast<__half*>(y)[i] = __float2half(v); break;
    default: static_cast<float*>(y)[i] = v;
  }
}

// The Vec<T>::kN elements of x in a 16-byte word, rounded to bf16 (the JAX
// contract casts x to bf16 before the product), as floats; zero when !ok.
template <typename T>
__device__ __forceinline__ void unpack_x(uint4 raw, bool ok, float* dst) {
  unpack_vec<T>(raw, dst);
#pragma unroll
  for (int i = 0; i < Vec<T>::kN; ++i) dst[i] = ok ? round_through<__nv_bfloat16>(dst[i]) : 0.f;
}

// ------------------------------------------------------------ decode GEMV
constexpr int kGemvThreads = 256;                 // 8 warps share one x tile
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kColsPerWarp = 4;                   // output channels a warp owns
constexpr int kColsPerBlock = kGemvWarps * kColsPerWarp;
constexpr int kSweep = 32 * 16;                   // k a warp covers per sweep
constexpr int kSweepsPerTile = 2;
constexpr int kTileK = kSweep * kSweepsPerTile;   // k per shared-memory tile

// Where x element k of a tile row sits in shared memory. Lane l of a warp
// multiplies k in [sweep * 512 + 16 l, + 16) and reads them as 4 float4; stored
// plainly, the 32 lanes' float4 reads would be 64 bytes apart and collide 4 ways
// in the banks. Each (sweep, float4 j) group of the 32 lanes is therefore stored
// contiguously: lane l's j-th float4 of a sweep is float4 number (sweep * 4 + j)
// * 32 + l of the row, and a warp's read is 512 consecutive bytes.
__device__ __forceinline__ int xs_offset(int k) {
  return (((k / kSweep) * 4 + (k % 16) / 4) * 32 + (k % kSweep) / 16) * 4 + k % 4;
}

// TX: x's dtype. MT: x rows the kernel is compiled for (M <= MT); rows past M
// are zero in shared memory and never stored. Needs K % 16 == 0 and 16-byte
// aligned x and w.
template <typename TX, int MT>
__global__ void __launch_bounds__(kGemvThreads)
int8_gemv_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, void* __restrict__ y, int ycode, int M,
                 int K, int N) {
  constexpr int kXVec = Vec<TX>::kN;                       // x per 16-byte load
  constexpr int kXChunks = MT * kTileK / kXVec;            // 16-byte loads per tile
  constexpr int kXPerThread = (kXChunks + kGemvThreads - 1) / kGemvThreads;
  // [MT][kTileK] in the xs_offset order: bf16-rounded x, zero past M and K
  extern __shared__ float4 xs4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kColsPerBlock + warp * kColsPerWarp;
  // rows past N re-read the last row (a valid address) and are never stored
  const int8_t* wrow[kColsPerWarp];
#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c) {
    const int n = n0 + c < N ? n0 + c : N - 1;
    wrow[c] = w + (size_t)n * K;
  }

  float acc[kColsPerWarp][MT];
#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[c][m] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
    // the x tile: every 16-byte load goes out before any is stored; a chunk
    // past M or K reads x[0] (valid) and stores zeros
    uint4 xr[kXPerThread];
    bool xok[kXPerThread];
#pragma unroll
    for (int j = 0; j < kXPerThread; ++j) {
      const int c = threadIdx.x + j * kGemvThreads;
      const int m = c * kXVec / kTileK, k = k0 + c * kXVec % kTileK;
      xok[j] = c < kXChunks && m < M && k < K;
      xr[j] = __ldg(reinterpret_cast<const uint4*>(x + (xok[j] ? (size_t)m * K + k : 0)));
    }
    __syncthreads();  // the previous tile's readers are done
#pragma unroll
    for (int j = 0; j < kXPerThread; ++j) {
      const int c = threadIdx.x + j * kGemvThreads;
      if (c >= kXChunks) continue;
      float v[kXVec];
      unpack_x<TX>(xr[j], xok[j], v);
      const int m = c * kXVec / kTileK, k = c * kXVec % kTileK;
#pragma unroll
      for (int g = 0; g < kXVec; g += 4)
        xs4[(m * kTileK + xs_offset(k + g)) / 4] =
            make_float4(v[g], v[g + 1], v[g + 2], v[g + 3]);
    }
    __syncthreads();

    // all weight loads of the tile go out before any is unpacked; a chunk
    // past K reads chunk 0 of the row (valid) and meets zeros in xs. (Issued
    // before the x staging instead, they stay live across it and the gate/up
    // shape ran 1.4x slower.)
    uint4 raw[kSweepsPerTile][kColsPerWarp];
#pragma unroll
    for (int s = 0; s < kSweepsPerTile; ++s) {
      const int kc = k0 + s * kSweep + lane * 16;
      const int kk = kc < K ? kc : 0;
#pragma unroll
      for (int c = 0; c < kColsPerWarp; ++c)
        raw[s][c] = __ldg(reinterpret_cast<const uint4*>(wrow[c] + kk));
    }
#pragma unroll
    for (int s = 0; s < kSweepsPerTile; ++s) {
      float wf[kColsPerWarp][16];
#pragma unroll
      for (int c = 0; c < kColsPerWarp; ++c) unpack_i8x16(raw[s][c], wf[c]);
      // lane's float4 j of this sweep: xs_offset(s * kSweep + 16 lane + 4 j)
      const float4* xrow = xs4 + s * 4 * 32 + lane;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float xf[16];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 v = xrow[m * kTileK / 4 + j * 32];
          xf[4 * j] = v.x; xf[4 * j + 1] = v.y; xf[4 * j + 2] = v.z; xf[4 * j + 3] = v.w;
        }
#pragma unroll
        for (int c = 0; c < kColsPerWarp; ++c)
#pragma unroll
          for (int i = 0; i < 16; ++i) acc[c][m] = fmaf(xf[i], wf[c][i], acc[c][m]);
      }
    }
  }

  // reduce each (column, row) sum over the warp's 32 lanes; lane (c * MT + m)
  // % 32 keeps the total and writes it
#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float v = acc[c][m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      const int n = n0 + c;
      if (lane == (c * MT + m) % 32 && m < M && n < N)
        store_as(y, ycode, (size_t)m * N + n, v * scale[n]);
    }
  }
}

template <typename TX, int MT>
cudaError_t launch_gemv(const void* x, const int8_t* w, const float* scale, void* y,
                        int ycode, int M, int K, int N, cudaStream_t stream) {
  const size_t smem = (size_t)MT * kTileK * sizeof(float);
  static bool configured = false;  // above 48 KB needs the opt-in, once
  if (smem > 48 * 1024 && !configured) {
    cudaError_t e = cudaFuncSetAttribute(int8_gemv_kernel<TX, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int blocks = (N + kColsPerBlock - 1) / kColsPerBlock;
  int8_gemv_kernel<TX, MT><<<blocks, kGemvThreads, smem, stream>>>(
      static_cast<const TX*>(x), w, scale, y, ycode, M, K, N);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch_gemv_rows(const void* x, const int8_t* w, const float* scale, void* y,
                             int ycode, int M, int K, int N, cudaStream_t st) {
  if (M == 1) return launch_gemv<TX, 1>(x, w, scale, y, ycode, M, K, N, st);
  if (M <= 4) return launch_gemv<TX, 4>(x, w, scale, y, ycode, M, K, N, st);
  if (M <= 8) return launch_gemv<TX, 8>(x, w, scale, y, ycode, M, K, N, st);
  return launch_gemv<TX, 16>(x, w, scale, y, ycode, M, K, N, st);
}

// ------------------------------------------------------------- tiled GEMM
// 32 x 64 output tiles (small, so a 64-row chunk still spreads over the SMs),
// 32-deep k steps, 128 threads with 4 x 4 outputs each. The next k step's
// 16-byte loads are issued into registers before the current step's
// products, so the loads overlap the arithmetic. Needs K % 16 == 0 and
// 16-byte aligned x and w.
constexpr int kBM = 32, kBN = 64, kBK = 32;
constexpr int kGemmThreads = 128;

template <typename TX>
__global__ void __launch_bounds__(kGemmThreads)
int8_gemm_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, void* __restrict__ y, int ycode, int M,
                 int K, int N) {
  constexpr int kXVec = Vec<TX>::kN;
  constexpr int kXLoads = kBM * kBK / kXVec / kGemmThreads;  // 1 (bf16/fp16), 2 (fp32)
  static_assert(kBM * kBK % (kXVec * kGemmThreads) == 0, "whole x loads per thread");
  constexpr int kXPerRow = kBK / kXVec;
  static_assert(kBN * kBK / 16 == kGemmThreads, "one weight load per thread");
  __shared__ __align__(16) float as[kBK][kBM + 4];  // x tile, k-major
  __shared__ __align__(16) float bs[kBK][kBN + 4];  // w tile, k-major
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  uint4 xr[kXLoads], wr;
  bool xok[kXLoads], wok;
  auto issue = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kXLoads; ++j) {
      const int c = tid + j * kGemmThreads;
      const int m = m0 + c / kXPerRow, k = k0 + c % kXPerRow * kXVec;
      xok[j] = m < M && k < K;
      xr[j] = __ldg(reinterpret_cast<const uint4*>(x + (xok[j] ? (size_t)m * K + k : 0)));
    }
    const int n = n0 + tid / 2, k = k0 + tid % 2 * 16;
    wok = n < N && k < K;
    wr = __ldg(reinterpret_cast<const uint4*>(w + (wok ? (size_t)n * K + k : 0)));
  };
  auto stash = [&]() {
#pragma unroll
    for (int j = 0; j < kXLoads; ++j) {
      const int c = tid + j * kGemmThreads;
      float v[kXVec];
      unpack_x<TX>(xr[j], xok[j], v);
#pragma unroll
      for (int i = 0; i < kXVec; ++i) as[c % kXPerRow * kXVec + i][c / kXPerRow] = v[i];
    }
    float v[16];
    unpack_i8x16(wr, v);
#pragma unroll
    for (int i = 0; i < 16; ++i) bs[tid % 2 * 16 + i][tid / 2] = wok ? v[i] : 0.f;
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  issue(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the previous step's readers are done
    stash();
    __syncthreads();
    if (k0 + kBK < K) issue(k0 + kBK);
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (m < M && n < N) store_as(y, ycode, (size_t)m * N + n, acc[i][j] * scale[n]);
    }
  }
}

template <typename TX>
cudaError_t launch_gemm(const void* x, const int8_t* w, const float* scale, void* y,
                        int ycode, int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_gemm_kernel<TX><<<grid, kGemmThreads, 0, stream>>>(static_cast<const TX*>(x), w,
                                                          scale, y, ycode, M, K, N);
  return cudaGetLastError();
}

// Any K or alignment: scalar loads, 64 x 64 tiles (not on the serving path,
// whose K is a multiple of 16).
__device__ __forceinline__ float load_as_bf16_float(const void* x, int code, size_t i) {
  switch (code) {
    case kBFloat16: return __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
    case kFloat16: return round_through<__nv_bfloat16>(__half2float(static_cast<const __half*>(x)[i]));
    default: return round_through<__nv_bfloat16>(static_cast<const float*>(x)[i]);
  }
}

constexpr int kSM = 64, kSN = 64, kSK = 32;

__global__ void __launch_bounds__(256)
int8_gemm_scalar_kernel(const void* __restrict__ x, int xcode, const int8_t* __restrict__ w,
                        const float* __restrict__ scale, void* __restrict__ y, int ycode,
                        int M, int K, int N) {
  __shared__ float as[kSK][kSM + 4];
  __shared__ float bs[kSK][kSN + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kSM, n0 = blockIdx.x * kSN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kSK) {
    for (int i = threadIdx.x; i < kSM * kSK; i += 256) {
      const int r = i / kSK, kk = i % kSK;
      const int m = m0 + r, n = n0 + r, k = k0 + kk;
      as[kk][r] = (m < M && k < K) ? load_as_bf16_float(x, xcode, (size_t)m * K + k) : 0.f;
      bs[kk][r] = (n < N && k < K) ? (float)w[(size_t)n * K + k] : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kSK; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(as[kk][ty * 4 + i], bs[kk][tx * 4 + j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (m < M && n < N) store_as(y, ycode, (size_t)m * N + n, acc[i][j] * scale[n]);
    }
  }
}

template <typename TX>
cudaError_t launch_vec(const void* x, const int8_t* w, const float* scale, void* y,
                       int ycode, int M, int K, int N, cudaStream_t st) {
  return M <= 16 ? launch_gemv_rows<TX>(x, w, scale, y, ycode, M, K, N, st)
                 : launch_gemm<TX>(x, w, scale, y, ycode, M, K, N, st);
}

}  // namespace
}  // namespace dstorch

// C entry point bound with ctypes. Returns the launch's cudaGetLastError().
extern "C" int dstorch_int8_matmul(int xdtype, const void* x, const void* w,
                                   const void* scale, int ydtype, void* y, int M, int K,
                                   int N, void* stream) {
  using namespace dstorch;
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const auto known = [](int code) {
    return code == kFloat32 || code == kBFloat16 || code == kFloat16;
  };
  if (!known(xdtype) || !known(ydtype)) return (int)cudaErrorInvalidValue;
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec_ok = K % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (vec_ok) {
    switch (xdtype) {
      case kBFloat16: return (int)launch_vec<__nv_bfloat16>(x, wq, sc, y, ydtype, M, K, N, st);
      case kFloat16: return (int)launch_vec<__half>(x, wq, sc, y, ydtype, M, K, N, st);
      default: return (int)launch_vec<float>(x, wq, sc, y, ydtype, M, K, N, st);
    }
  }
  const dim3 grid((N + kSN - 1) / kSN, (M + kSM - 1) / kSM);
  int8_gemm_scalar_kernel<<<grid, 256, 0, st>>>(x, xdtype, wq, sc, y, ydtype, M, K, N);
  return (int)cudaGetLastError();
}
