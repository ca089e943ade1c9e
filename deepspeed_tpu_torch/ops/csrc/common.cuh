// Shared helpers for the hand-written attention kernels: dtype codes that the
// Python wrappers pass across the C interface, float conversions, and the
// rounding of a float through the storage dtype (the FA2 cast of the
// probabilities to the value dtype before the PV product).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dstorch {

// Dtype codes shared with deepspeed_tpu_torch/ops/op_builder (DTYPE_CODES).
enum DtypeCode : int { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };

// Large finite negative, as the TPU kernels use: a masked score never turns
// a row into NaN through inf - inf.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) { return __float2half(x); }

// x rounded to T and back (round to nearest even): a no-op for float.
template <typename T> __device__ __forceinline__ float round_through(float x) {
  return to_float(from_float<T>(x));
}

// Elements of T in one 16-byte load.
template <typename T> struct Vec { static constexpr int kN = 16 / sizeof(T); };

// Load kN = 16 / sizeof(T) contiguous elements of T (16-byte aligned) as floats.
template <typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ src, float* dst) {
  constexpr int kN = Vec<T>::kN;
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kN; ++i) dst[i] = to_float(vals[i]);
}

// The kN elements of T in a 16-byte word loaded earlier, as floats.
template <typename T>
__device__ __forceinline__ void unpack_vec(uint4 raw, float* dst) {
  const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::kN; ++i) dst[i] = to_float(vals[i]);
}

// The 16 int8 values of a 16-byte word loaded earlier, as floats. Each byte,
// offset to unsigned (b + 128), becomes the low mantissa byte of 2^23 through
// one byte permute, and one subtraction of 2^23 + 128 leaves b: exact, and
// cheaper than the int-to-float conversion unit.
__device__ __forceinline__ void unpack_i8x16(uint4 raw, float* dst) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t u = words[j] ^ 0x80808080u;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      dst[4 * j + b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + b)) - 8388736.f;
  }
}

// The int8 KV-cache kernels round the V-scaled probabilities to the compute
// dtype before the PV product, as the TPU kernel does: bf16 for bf16 queries,
// fp32 (no rounding) for fp32 and fp16 queries.
template <typename T> __device__ __forceinline__ float round_p_int8(float p) { return p; }
template <> __device__ __forceinline__ float round_p_int8<__nv_bfloat16>(float p) {
  return round_through<__nv_bfloat16>(p);
}

// Load 16 contiguous elements of T (16-byte aligned) as floats.
template <typename T>
__device__ __forceinline__ void load_16(const T* __restrict__ src, float* dst) {
#pragma unroll
  for (int j = 0; j < 16 / Vec<T>::kN; ++j) load_vec(src + j * Vec<T>::kN, dst + j * Vec<T>::kN);
}

// Rows [row0, row0 + nrows) of one attention head (D elements each, rows
// row_stride elements apart), zero past `limit`, into a padded fp32 tile
// (row stride D + 1 avoids shared-memory bank conflicts), by a block of
// kThreads threads with 16-byte loads.
template <typename T, int D, int kThreads>
__device__ __forceinline__ void load_tile_f32(float* tile, const T* __restrict__ base,
                                              size_t row_stride, int row0, int nrows,
                                              int limit) {
  constexpr int kVec = Vec<T>::kN;
  constexpr int kPerRow = D / kVec;
  for (int idx = threadIdx.x; idx < nrows * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * kVec;
    const int t = row0 + r;
    float vals[kVec];
    if (t < limit) {
      load_vec(base + (size_t)t * row_stride + c, vals);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) vals[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) tile[r * (D + 1) + c + i] = vals[i];
  }
}

// s[i][j] += a[row i] . b[col j] and t[i][j] += c[row i] . e[col j] over D,
// for the thread's rows ty*4+i and columns tx+16j of two padded 64-row tiles
// each (row stride D + 1, as load_tile_f32 writes them): the score and dO V^T
// tiles of the attention backward kernels, 256 threads as 16 x 16
template <int D>
__device__ __forceinline__ void two_score_tiles(const float* a, const float* b, const float* c,
                                                const float* e, int ty, int tx, float s[4][4],
                                                float t[4][4]) {
  constexpr int kLd = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4], cv[4], ev[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a[(ty * 4 + i) * kLd + d];
      cv[i] = c[(ty * 4 + i) * kLd + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[j] = b[(tx + 16 * j) * kLd + d];
      ev[j] = e[(tx + 16 * j) * kLd + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += av[i] * bv[j];
        t[i][j] += cv[i] * ev[j];
      }
  }
}

}  // namespace dstorch
