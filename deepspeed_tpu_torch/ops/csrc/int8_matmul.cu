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
// with N on the lanes; here a row of w is what the tensor cores take as A.
//
// What bounds it on the H100: bytes at decode (M <= 16: every weight is read
// once and used for M products, so the weights' N * K bytes are the traffic)
// and still at a 64-row prefill chunk; operations from a few hundred rows
// (M = 512 through TinyLlama's gate: 11.8 GFLOP against 11.5 MB). So the
// products run on the tensor cores and the weights stream through a deep ring.
//
// Design: the products on the tensor cores in bf16 with the operands
// swapped, y^T = W x^T. The (N, K) weight tile is A, converted int8 -> bf16
// in registers: its output channels fill the 16- or 64-row side, and the
// tokens fill the narrow N side, so a decode step's 8 rows waste nothing.
// One weight stream, two routes by the token tile:
//  - decode (tiles 1 and 2: 64 channels x 8 or 16 tokens, 4 warps of 16
//    channels, 128-deep k slices in a 4-stage cp.async ring):
//    mma.sync.m16n8k16. The k order inside each 64-deep half slice is
//    permuted (the sum over k does not care; A and B use the same
//    permutation), so that every fragment is one 16-byte shared-memory load
//    (int8_mma_kernel). The same tiles fed by TMA ran 15% slower.
//  - prefill (tiles 3 and 4: 128 channels x 64 or 128 tokens, two
//    warpgroups of 64 channels, 64-deep k slices in a 4-stage TMA ring): RS
//    wgmma m64nNk16, N = the token tile; x (B) is read by the tensor cores
//    from shared memory as TMA lays it, the weights are A from registers in
//    wgmma's k order (int8_wgmma_kernel). Both tiles' versions with mma.sync
//    spent their time re-reading x fragments through shared memory, one copy
//    for each warp along the channels (PERF.md).
//  - int8 -> bf16 without the fp32 detour: for a byte b, (b & 0x7f) + 128 and
//    128 + 128 * sign(b) are bf16 numbers built by bit operations on the byte
//    pair (0x4300 | ...), and one bf16x2 fused multiply-add takes their
//    difference, which is b exactly (i8x4_to_bf16x2).
//  - split K: where the output tiles would leave most of the card idle (the
//    k and v projections at N = 256, q, o and down at decode, a 64-row
//    prefill chunk), the K range is split across the blocks of a
//    thread-block cluster (up to 8). Each block leaves its fp32 partial tile
//    in shared memory; after a cluster barrier each block sums a slice of the
//    tile over the cluster's blocks in rank order 0, 1, ... through
//    distributed shared memory, so the result is the same from run to run (no
//    atomics) and needs no workspace.
//  - the epilogue goes through shared memory either way, so y is written in
//    rows, consecutive threads on consecutive groups of 4 output channels.
// int8_matmul.py's int8_plan picks the tile by M and the split by the grid.
// The tensor-core kernels take bf16 x (the wrapper rounds fp32 and fp16 x to
// bf16 first, as the contract does; serving's x is bf16 already), K % 16 ==
// 0 and 16-byte aligned x and w; tile 0, the scalar kernel, takes any x
// dtype, K and alignment.
#include <cooperative_groups.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace dstorch {
namespace {

namespace cg = cooperative_groups;

// ---------------------------------------------------------------- helpers
__device__ __forceinline__ void store_as(void* y, int code, size_t i, float v) {
  switch (code) {
    case kBFloat16: static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16(v); break;
    case kFloat16: static_cast<__half*>(y)[i] = __float2half(v); break;
    default: static_cast<float*>(y)[i] = v;
  }
}

// The 4 int8 values of w (byte 0 first) as two bf16x2 words: lo = (b0, b1),
// hi = (b2, b3), each byte pair spread to the low bytes of two 16-bit halves
// and converted exactly (wgmma.cuh's i8x2_to).
__device__ __forceinline__ void i8x4_to_bf16x2(uint32_t w, uint32_t& lo, uint32_t& hi) {
  lo = i8x2_to<__nv_bfloat16>(__byte_perm(w, 0, 0x4140));
  hi = i8x2_to<__nv_bfloat16>(__byte_perm(w, 0, 0x4342));
}

// y[m, n .. n + 3] = v * scale[n .. n + 3] (columns past N dropped), one
// vector store where the row and the pointers allow it
__device__ __forceinline__ void store4(void* y, int code, int N, int m, int n, float4 v,
                                       const float* __restrict__ scale) {
  float o[4] = {v.x, v.y, v.z, v.w};
  const size_t at = (size_t)m * N + n;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(scale)) & 15) == 0;
  if (aligned && N % 4 == 0 && n + 3 < N) {
    const float4 s = *reinterpret_cast<const float4*>(scale + n);
    o[0] *= s.x; o[1] *= s.y; o[2] *= s.z; o[3] *= s.w;
    if (code == kFloat32) {
      *reinterpret_cast<float4*>(static_cast<float*>(y) + at) = make_float4(o[0], o[1], o[2], o[3]);
    } else if (code == kBFloat16) {
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(y) + at) =
          make_uint2(pack2<__nv_bfloat16>(o[0], o[1]), pack2<__nv_bfloat16>(o[2], o[3]));
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) store_as(y, code, at + c, o[c]);
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (n + c < N) store_as(y, code, at + c, o[c] * scale[n + c]);
}

// The block's fp32 partial tile ys (kBT tokens x kBW channels, rows kLdY
// apart) to y: the tile's valid rows in groups of 4 channels, token-major;
// with a split each block of the cluster sums its share of the groups over
// every block's partial, in rank order, all ranks' loads issued before the
// sum. Ends with every block of the cluster past its partial's last reader.
template <int kBW, int kBT, int kLdY, int kThreads>
__device__ __forceinline__ void reduce_store(const float* ys, void* y, int ycode, int M, int N,
                                             int m0, int n0, int split, int splits,
                                             const float* __restrict__ scale) {
  constexpr int kG = kBW / 4;
  const int total = min(kBT, M - m0) * kG;
  int q0 = 0, q1 = total;
  cg::cluster_group cluster = cg::this_cluster();
  if (splits > 1) {
    cluster.sync();  // every block's partial is in its shared memory
    q0 = split * total / splits;
    q1 = (split + 1) * total / splits;
  } else {
    __syncthreads();
  }
  for (int q = q0 + (int)threadIdx.x; q < q1; q += kThreads) {
    const int r = q / kG, col = 4 * (q % kG), at = r * kLdY + col;
    float4 part[8];
#pragma unroll
    for (int b = 0; b < 8; ++b)
      if (b < splits)
        part[b] = *reinterpret_cast<const float4*>(
            (splits > 1 ? cluster.map_shared_rank(const_cast<float*>(ys), b) : ys) + at);
    float4 v = part[0];
#pragma unroll
    for (int b = 1; b < 8; ++b)
      if (b < splits) {
        v.x += part[b].x; v.y += part[b].y; v.z += part[b].z; v.w += part[b].w;
      }
    store4(y, ycode, N, m0 + r, n0 + col, v, scale);
  }
  if (splits > 1) cluster.sync();  // no block leaves while its partial is read
}

// ---------------------------------------------- decode tiles: mma.sync
// 64 channels x 8 WN tokens a block: 4 warps, one 16-channel tile each;
// 128-deep k slices, 4 of them in a cp.async ring. The k order inside each
// 64-deep half of a slice is permuted (the sum over k does not care, and A and
// B use the same permutation): thread t of a quad owns physical k 16t .. 16t
// + 15 of the half, and in k-step s (0..3) its logical columns 2t, 2t+1,
// 2t+8, 2t+9 are physical 16t + 4s + 0..3. So each fragment is one 16-byte
// shared-memory load: 16 weight bytes of each of its two rows, 16 x values
// of its token.
template <int WN>
struct DecodeTile {
  static constexpr int kThreads = 128, kStages = 4, kBK = 128;
  static constexpr int kBW = 64, kBT = 8 * WN;
  static constexpr int kWBytes = kBW * kBK;        // int8 weight slice, rows 128 bytes
  static constexpr int kXBytes = kBT * kBK * 2;    // bf16 x slice, rows 256 bytes
  static constexpr int kStage = kWBytes + kXBytes;
  static constexpr int kLdY = kBW + 4;             // fp32 partial tile, token-major
  static constexpr int kSmem =
      kStages * kStage > kBT * kLdY * 4 ? kStages * kStage : kBT * kLdY * 4;
};

// 16-byte chunk j of weight row r: a quad reads chunks 4c .. 4c + 3 of rows
// g and g + 1 in one phase; the odd rows' halves swap, so the two rows hit
// different banks. Chunk j (8 values) of x row r: a thread reads chunks 2t,
// 2t + 1 of its token; odd tokens swap the pair.
__device__ __forceinline__ int w_chunk(int r, int j) { return j ^ ((r & 1) << 2); }
__device__ __forceinline__ int x_chunk(int r, int j) { return j ^ (r & 1); }

template <int WN>
__global__ void __launch_bounds__(128, 2)
int8_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, void* __restrict__ y, int ycode, int M, int K,
                int N) {
  using C = DecodeTile<WN>;
  constexpr int BK = C::kBK, kS = C::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * C::kBW, m0 = blockIdx.y * C::kBT;
  const int units = (K + BK - 1) / BK, split = blockIdx.z, splits = gridDim.z;
  const int u0 = split * units / splits, nu = (split + 1) * units / splits - u0;

  auto load_stage = [&](int slot, int u) {
    unsigned char* ws = smem + slot * C::kStage;
    unsigned char* xs = ws + C::kWBytes;
    const int k0 = u * BK;
#pragma unroll
    for (int i = 0; i < C::kWBytes / 16 / C::kThreads; ++i) {
      const int c = tid + i * C::kThreads, r = c / (BK / 16), j = c % (BK / 16);
      const int n = n0 + r, k = k0 + 16 * j;
      const bool ok = n < N && k < K;
      cp_async16(sm90::smem_u32(ws + r * BK + w_chunk(r, j) * 16),
                 w + (ok ? (size_t)n * K + k : 0), ok);
    }
#pragma unroll
    for (int i = 0; i < C::kXBytes / 16 / C::kThreads; ++i) {
      const int c = tid + i * C::kThreads, r = c / (BK / 8), j = c % (BK / 8);
      const int m = m0 + r, k = k0 + 8 * j;
      const bool ok = m < M && k < K;
      cp_async16(sm90::smem_u32(xs + r * 2 * BK + x_chunk(r, j) * 16),
                 x + (ok ? (size_t)m * K + k : 0), ok);
    }
  };

  float acc[WN][4];
#pragma unroll
  for (int j = 0; j < WN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kS - 1; ++s) {
    if (s < nu) load_stage(s, u0 + s);
    cp_async_commit();
  }
  for (int it = 0; it < nu; ++it) {
    cp_async_wait<kS - 2>();
    __syncthreads();  // slice it has landed; every warp is done with slice it - 1
    if (it + kS - 1 < nu) load_stage((it + kS - 1) % kS, u0 + it + kS - 1);
    cp_async_commit();
    const unsigned char* ws = smem + (it % kS) * C::kStage;
    const unsigned char* xs = ws + C::kWBytes;
#pragma unroll
    for (int c = 0; c < BK / 64; ++c) {
      uint4 wv[2];  // rows g and g + 8: byte 4s + j feeds k-step s
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        wv[h] = *reinterpret_cast<const uint4*>(ws + r * BK + w_chunk(r, 4 * c + t) * 16);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // x values 8h .. 8h + 7 of the thread's 16: k-steps 2h, 2h + 1
        uint4 xv[WN];
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          const int r = 8 * j + g;
          xv[j] = *reinterpret_cast<const uint4*>(xs + r * 2 * BK +
                                                  x_chunk(r, 8 * c + 2 * t + h) * 16);
        }
#pragma unroll
        for (int s = 2 * h; s < 2 * h + 2; ++s) {
          uint32_t a[4];
          i8x4_to_bf16x2((&wv[0].x)[s], a[0], a[2]);  // row g
          i8x4_to_bf16x2((&wv[1].x)[s], a[1], a[3]);  // row g + 8
#pragma unroll
          for (int j = 0; j < WN; ++j) {
            const uint32_t* xw = &xv[j].x + 2 * (s & 1);
            mma_16816<__nv_bfloat16>(acc[j], a, xw[0], xw[1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the partial tile takes its place

  // acc[j][e]: channel 16 warp + g + 8 (e >> 1), token 8 j + 2 t + (e & 1)
  float* ys = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < WN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ys[(8 * j + 2 * t + (e & 1)) * C::kLdY + warp * 16 + g + 8 * (e >> 1)] = acc[j][e];
  reduce_store<C::kBW, C::kBT, C::kLdY, C::kThreads>(ys, y, ycode, M, N, m0, n0, split, splits,
                                                      scale);
}

// ------------------------------------------------ prefill tiles: wgmma
// Two consumer warpgroups of 64 channels x BT tokens (64 or 128); 64-deep k
// slices in a ring of 4 stages filled by TMA: the x slice as one box of BT
// rows x 64 bf16 (128-byte swizzle, K-major: wgmma's B as it lies), the
// weight slice as 128 rows of 64 bytes (64-byte swizzle). Thread 0 issues the
// loads; a slot is refilled once every warp is past it.
template <int BT>
struct PrefillTile {
  static constexpr int kThreads = 256, kStages = 4, kBK = 64;
  static constexpr int kBW = 128, kBT = BT;
  static constexpr int kXBytes = BT * 128;
  static constexpr int kWBytes = kBW * 64;
  static constexpr int kStage = kXBytes + kWBytes;
  static constexpr int kLdY = kBW + 4;
  static constexpr int kData = kStages * kStage > BT * kLdY * 4 ? kStages * kStage : BT * kLdY * 4;
  static constexpr int kSmem = 1024 + kData + 8 * kStages;  // + the full barriers
  static_assert(kXBytes % 1024 == 0 && kWBytes % 1024 == 0, "stages on swizzle atoms");
};

// The A fragment of k16 step kk for weight rows r and r + 8 of a slice whose
// rows are 64 bytes, TMA's 64-byte swizzle (chunk c of row r at c ^ ((r >> 1)
// & 3)), in wgmma's layout: a[0] / a[1] = rows r / r + 8, columns 2t, 2t+1;
// a[2] / a[3] = the same rows, columns 2t+8, 2t+9. The quad's four threads
// read the same 16 bytes of a row (a broadcast; the swizzle puts a warp's 8
// rows on distinct banks) and each keeps its two byte pairs: two selects and
// a byte permute, then the conversion.
__device__ __forceinline__ void load_afrag(const unsigned char* ws, int r, int kk, int t,
                                           uint32_t (&a)[4]) {
  const uint32_t sel = (t & 1) ? 0x7632 : 0x5410;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    const uint4 v =
        *reinterpret_cast<const uint4*>(ws + row * 64 + ((kk ^ ((row >> 1) & 3)) << 4));
    const uint32_t lo = (t & 2) ? v.y : v.x, hi = (t & 2) ? v.w : v.z;
    i8x4_to_bf16x2(__byte_perm(lo, hi, sel), a[h], a[2 + h]);
  }
}

template <typename C>
__global__ void __launch_bounds__(C::kThreads, 2)
int8_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap w_map, const float* __restrict__ scale,
                  void* __restrict__ y, int ycode, int M, int K, int N) {
  using namespace sm90;
  constexpr int kS = C::kStages, BT = C::kBT;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bars = base + C::kData;
  auto full = [&](int s) { return bars + 8 * s; };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * C::kBW, m0 = blockIdx.y * BT;
  const int units = (K + 63) / 64, split = blockIdx.z, splits = gridDim.z;
  const int u0 = split * units / splits, nu = (split + 1) * units / splits - u0;
  const int wrow = (warp >> 2) * 64 + (warp & 3) * 16 + g;  // channels wrow, wrow + 8

  if (tid == 0) {
    for (int s = 0; s < kS; ++s) mbar_init(full(s), 1);
    fence_barrier_init();
  }
  __syncthreads();
  auto issue = [&](int it) {  // slice it into its slot (one thread)
    const int s = it % kS, k0 = (u0 + it) * 64;
    const uint32_t st = base + s * C::kStage;
    mbar_arrive_expect_tx(full(s), C::kStage);
    tma_load_2d(st, &x_map, full(s), k0, m0);
    tma_load_2d(st + C::kXBytes, &w_map, full(s), k0, n0);
  };
  if (tid == 0)
    for (int it = 0; it < kS - 1 && it < nu; ++it) issue(it);

  float acc[BT / 2];
#pragma unroll
  for (int e = 0; e < BT / 2; ++e) acc[e] = 0.f;
  for (int it = 0; it < nu; ++it) {
    fence_proxy_async();  // this thread's reads of slice it - 1 precede its refill
    __syncthreads();      // every warp is past slice it - 1: its slot is free
    if (tid == 0 && it + kS - 1 < nu) issue(it + kS - 1);
    const int s = it % kS;
    mbar_wait(full(s), (it / kS) & 1);
    const uint32_t xs = base + s * C::kStage;
    const unsigned char* ws = smem + s * C::kStage + C::kXBytes;
    uint32_t a[4][4];  // k16 steps 0..3
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) load_afrag(ws, wrow, kk, t, a[kk]);
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(a[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<__nv_bfloat16, BT, 0>(acc, a[kk], sw128_desc(xs + kk * 32, 16, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(a[kk]);
  }
  __syncthreads();  // every slice consumed: the ring takes the partial tile

  // acc[e]: channel wrow + 8 ((e >> 1) & 1), token 8 (e >> 2) + 2 t + (e & 1)
  float* ys = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int e = 0; e < BT / 2; ++e)
    ys[(8 * (e >> 2) + 2 * t + (e & 1)) * C::kLdY + wrow + 8 * ((e >> 1) & 1)] = acc[e];
  reduce_store<C::kBW, BT, C::kLdY, C::kThreads>(ys, y, ycode, M, N, m0, n0, split, splits, scale);
}

// A 2-D tensor map over the (N, K) int8 weights for boxes of (box_rows, 64
// bytes), 64-byte swizzle, zero fill out of bounds.
inline cudaError_t encode_weights(CUtensorMap* map, const void* w, int N, int K, int box_rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims, strides, box,
                  elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a kernel over (N / channels, M / tokens, splits) blocks, each split's
// blocks one cluster along z
template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, int smem, int threads, int bw, int bt, int M, int N,
                           int splits, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + bw - 1) / bw, (M + bt - 1) / bt, splits);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool* configured) {
  if (*configured) return cudaSuccess;  // the attribute is per kernel, set once (eagerly)
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *configured = true;
  return e;
}

template <int WN>
cudaError_t launch_decode(const void* x, const int8_t* w, const float* scale, void* y, int ycode,
                          int M, int K, int N, int splits, cudaStream_t st) {
  using C = DecodeTile<WN>;
  static bool configured = false;
  cudaError_t e = allow_smem(int8_mma_kernel<WN>, C::kSmem, &configured);
  if (e != cudaSuccess) return e;
  return launch_cluster(int8_mma_kernel<WN>, C::kSmem, C::kThreads, C::kBW, C::kBT, M, N, splits,
                        st, static_cast<const __nv_bfloat16*>(x), w, scale, y, ycode, M, K, N);
}

template <typename C>
cudaError_t launch_prefill(const void* x, const int8_t* w, const float* scale, void* y,
                           int ycode, int M, int K, int N, int splits, cudaStream_t st) {
  static bool configured = false;
  cudaError_t e = allow_smem(int8_wgmma_kernel<C>, C::kSmem, &configured);
  if (e != cudaSuccess) return e;
  CUtensorMap x_map, w_map;
  e = encode_tma_2d(&x_map, true, x, M, K, K, C::kBT, 64);
  if (e == cudaSuccess) e = encode_weights(&w_map, w, N, K, C::kBW);
  if (e != cudaSuccess) return e;
  return launch_cluster(int8_wgmma_kernel<C>, C::kSmem, C::kThreads, C::kBW, C::kBT, M, N, splits,
                        st, x_map, w_map, scale, y, ycode, M, K, N);
}

// the tile shapes of the header, by code
cudaError_t launch_tile(int tile, const void* x, const int8_t* w, const float* scale, void* y,
                        int ycode, int M, int K, int N, int splits, cudaStream_t st) {
  switch (tile) {
    case 1: return launch_decode<1>(x, w, scale, y, ycode, M, K, N, splits, st);
    case 2: return launch_decode<2>(x, w, scale, y, ycode, M, K, N, splits, st);
    case 3: return launch_prefill<PrefillTile<64>>(x, w, scale, y, ycode, M, K, N, splits, st);
    case 4: return launch_prefill<PrefillTile<128>>(x, w, scale, y, ycode, M, K, N, splits, st);
    default: return cudaErrorInvalidValue;
  }
}

// Any K or alignment: scalar loads, 64 x 64 tiles on the FMA units (not on
// the serving path, whose K is a multiple of 16).
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

}  // namespace
}  // namespace dstorch

// C entry point bound with ctypes. Returns the launch's cudaGetLastError().
// tile: 0 the scalar kernel (any x dtype, K and alignment), 1..4 the
// tensor-core kernel's tile shapes (bf16 x, K % 16 == 0, x and w 16-byte
// aligned; refused otherwise); splits: 1..8 blocks of a cluster sharing each
// output tile's K range (tile 0: 1). int8_matmul.py's int8_plan chooses both.
extern "C" int dstorch_int8_matmul(int xdtype, const void* x, const void* w,
                                   const void* scale, int ydtype, void* y, int M, int K,
                                   int N, int tile, int splits, void* stream) {
  using namespace dstorch;
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const auto known = [](int code) {
    return code == kFloat32 || code == kBFloat16 || code == kFloat16;
  };
  if (!known(xdtype) || !known(ydtype)) return (int)cudaErrorInvalidValue;
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile == 0) {
    if (splits != 1) return (int)cudaErrorInvalidValue;
    const dim3 grid((N + kSN - 1) / kSN, (M + kSM - 1) / kSM);
    int8_gemm_scalar_kernel<<<grid, 256, 0, st>>>(x, xdtype, wq, sc, y, ydtype, M, K, N);
    return (int)cudaGetLastError();
  }
  const bool vec_ok = xdtype == kBFloat16 && K % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int slices = (K + 63) / 64;  // 64-deep slices; the decode tiles' 128-deep: half
  if (!vec_ok || splits < 1 || splits > 8 || (tile <= 2 ? (slices + 1) / 2 : slices) < splits)
    return (int)cudaErrorInvalidValue;
  return (int)launch_tile(tile, x, wq, sc, y, ydtype, M, K, N, splits, st);
}
