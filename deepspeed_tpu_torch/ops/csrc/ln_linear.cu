// Fused LayerNorm -> Linear, forward and backward-dx, for Hopper (sm_90a).
//
// Replaces the TPU kernels deepspeed_tpu/ops/transformer/ln_linear.py::
// _fwd_kernel (:52, pallas_call at :121) and _bwd_dx_kernel (:75,
// pallas_call at :159).
//
// Forward: y = (LN(x) * gamma + beta) W^T + b for x (M, C), W (N, C) in the
// nn.Linear layout (the JAX kernel takes W as (C, N)), with fp32 row
// statistics mean and rstd (M,) written for the backward. Backward-dx: dn =
// dy W, then the LayerNorm backward from the saved statistics,
//   xh = (x - mean) * rstd,  dxh = dn * gamma,
//   dx = rstd * (dxh - mean_C(dxh) - xh * mean_C(dxh * xh))
// (the TPU kernel's formula, :96-99), and per-128-row partials of
// sum(dn * xh) and sum(dn) over rows (dgamma, dbeta; summed by the caller).
// Rounding points are the TPU kernel's: fp32 statistics with var = mean((x -
// mean)^2); the normalized rows rounded to x's dtype before the product; fp32
// sums, the bias added in fp32 and y rounded once; dn and dxh fp32 up to dx,
// rounded once.
//
// What bounds it on the H100: at GPT-2 medium's training shapes (M = 10240
// rows, C = 1024, N = 3072 for qkv and 4096 for fc, bf16) each kernel is a
// product of 2 M C N flops over (M C + N C + M N) elements, about 600 flops
// a byte, above the ~295 ridge of the bf16 tensor cores: the bound is
// operations, so the products must run on the tensor cores.
//
// bf16 and fp16 (wgmma.mma_async, operands by TMA into an mbarrier ring;
// both GEMMs are persistent, one block an SM walking the output tiles, so
// the producer loads the next tile while the consumers finish this one):
//  - forward: a row-statistics pass (one warp per row) writes mean and rstd
//    (and gamma, beta in fp32); then a warp-specialised GEMM: one producer
//    thread keeps a ring of three stages full with TMA loads of a 128 x 64
//    x tile and a 256 x 64 W tile (128-byte swizzle; W (N, C) is already
//    K-major for B) and bulk copies of the slice's fp32 gamma and beta, and
//    two consumer warpgroups of 64 rows each read their x fragment with
//    ldmatrix, normalize it in fp32 with two FMAs an element (fma(x, rstd,
//    -mean * rstd), then fma(., gamma, beta)), round it to x's dtype and
//    issue wgmma with A from registers, so the normalized tile never reaches
//    shared or device memory. setmaxnreg moves registers from the producer
//    to the consumers (a 64 x 256 fp32 accumulator is 128 a thread). The
//    epilogue adds the bias in fp32, rounds once, stages the tile in the
//    swizzled layout and writes it with TMA stores, which skip rows >= M and
//    columns >= N. The normalization is redone by each of the N / 256
//    column blocks, and its fp32 work, on the SM sub-partitions that feed
//    the tensor cores, is what keeps the forward off its bound (PERF.md).
//  - backward-dx: a GEMM dn = dy W over K = N with 128 x 128 output tiles:
//    A = dy (K-major), B = W as it lies, (N, C) MN-major, read with wgmma's
//    transpose-B bit from two TMA boxes of 64 x 64 a K slice (W is never
//    transposed in memory). Its epilogue forms xh (from the tile's x block,
//    which the producer loads by TMA during the mainloop) and dxh in
//    registers, writes dxh in fp32 to a scratch (M, C), the row partials
//    sum(dxh) and sum(dxh * xh) over its columns to a (C / 128, M, 2)
//    scratch, and the tile's column sums of dn * xh and dn as its row of the
//    dgamma / dbeta partials. A finishing pass sums the row partials and
//    forms dx. The fp32 round trip of dxh (8 M C bytes) adds no rounding
//    point. Nothing here is bounded by shared memory in C, so the gate is C
//    a multiple of 64 (whole K slices) and N a multiple of 8 (16-byte TMA
//    strides for dy and y); any M.
//
// fp32 keeps the FMA units (TF32 wgmma would miss the fp32 tolerance), in
// the 16-bit kernels' structure so that shared memory does not grow with C:
// the forward takes its statistics from the same row-statistics pass and
// walks C in 32-column slices, normalizing each slice of x as it is loaded
// (a block 32 rows x 128 columns of y, each thread a 4 x 4 block); the
// backward computes dn for 128 rows x 128 columns of C in four passes of 32
// rows, writes dxh and the row partials to the same scratch as the 16-bit
// backward and its column sums as one row of the partials, and the same
// finishing pass forms dx. So the fp32 gate is C a multiple of 32, any M
// and N, which takes every shape the JAX gate takes (C <= 4096).
#include "common.cuh"
#include "wgmma.cuh"

namespace dstorch {
namespace {

// ---------------------------------------------------------------- fp32: FMA
constexpr int kBM = 32;       // rows per pass of a block
constexpr int kBN = 128;      // output columns per tile (forward: of N; backward: of C)
constexpr int kBK = 32;       // reduction chunk: C (forward) or N (backward) walks in these
constexpr int kLdW = kBN + 4; // padded row of the (kBK, kBN) fp32 B tile
constexpr int kLdD = kBK + 1;
constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // the H100's opt-in limit a block
constexpr int kPartRows = 128;    // rows per dgamma / dbeta partial (all dtypes)

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

// y tile of kBM rows x kBN columns. C is walked in kBK slices and each
// slice of x is normalized as it is loaded, from the statistics that
// ln_stats_kernel wrote first, so shared memory does not grow with C.
__global__ void __launch_bounds__(kThreads)
ln_linear_fwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ y,
                     const float* __restrict__ mean, const float* __restrict__ rstd, int M,
                     int C, int N) {
  __shared__ __align__(16) float Ws[kBK * kLdW];
  __shared__ float As[kBM * kLdD];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int ty = tid >> 5, tx = tid & 31;  // rows ty*4 .. +3, columns tx*4 .. +3
  float acc[4][4] = {};
  for (int k0 = 0; k0 < C; k0 += kBK) {
    // x rows m0 .. m0+31, columns k0 .. k0+31, normalized
    for (int v = tid; v < kBM * kBK / 4; v += kThreads) {
      const int r = v / (kBK / 4), kc = (v % (kBK / 4)) * 4;
      const int row = m0 + r;
      float xv[4] = {0.f, 0.f, 0.f, 0.f}, g[4], b[4];
      float mu = 0.f, rs = 0.f;
      if (row < M) {
        mu = mean[row];
        rs = rstd[row];
        load_vec(x + (size_t)row * C + k0 + kc, xv);
      }
      load_vec(gamma + k0 + kc, g);
      load_vec(beta + k0 + kc, b);
#pragma unroll
      for (int i = 0; i < 4; ++i) As[r * kLdD + kc + i] = row < M ? (xv[i] - mu) * rs * g[i] + b[i] : 0.f;
    }
    // W rows n0 .. n0+127, columns k0 .. k0+31, transposed into Ws[k][n]
    for (int v = tid; v < kBN * kBK / 4; v += kThreads) {
      const int nr = v / (kBK / 4), kc = (v % (kBK / 4)) * 4;
      float vals[4] = {0.f, 0.f, 0.f, 0.f};
      if (n0 + nr < N) load_vec(w + (size_t)(n0 + nr) * C + k0 + kc, vals);
#pragma unroll
      for (int i = 0; i < 4; ++i) Ws[(kc + i) * kLdW + nr] = vals[i];
    }
    __syncthreads();
    mma_chunk([&](int r, int kk) { return As[r * kLdD + kk]; }, Ws, ty, tx, acc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) y[(size_t)row * N + col] = acc[i][j] + bias[col];
    }
  }
}

// dn = dy W for kPartRows rows (four passes of kBM) x kBN columns of C, and
// its LayerNorm-backward epilogue as the 16-bit backward's: dxh = dn * gamma
// in fp32 to the (M, C) scratch, the row partials sum(dxh) and sum(dxh * xh)
// over the tile's columns to the (C / kBN, M, 2) scratch, and the tile's
// column sums of dn * xh and dn as its row of the dgamma / dbeta partials;
// ln_bwd_finish_kernel forms dx. Shared memory does not grow with C.
__global__ void __launch_bounds__(kThreads)
ln_linear_bwd_dx_kernel(const float* __restrict__ dy, const float* __restrict__ w,
                        const float* __restrict__ x, const float* __restrict__ gamma,
                        const float* __restrict__ mean, const float* __restrict__ rstd,
                        float* __restrict__ dxh, float* __restrict__ row_parts,
                        float* __restrict__ dg_parts, float* __restrict__ db_parts, int M, int C,
                        int N) {
  __shared__ __align__(16) float Ws[kBK * kLdW];
  __shared__ float Ds[kBM * kLdD];  // a kBK chunk of dy's rows
  __shared__ float red[8 * kBN * 2];
  const int tid = threadIdx.x, lane = tid & 31;
  const int ty = tid >> 5, tx = tid & 31;
  const int c0 = blockIdx.y * kBN, cl = tx * 4;  // this thread's columns c0 + cl .. + 3
  const bool col_ok = c0 + cl < C;               // C % 32 == 0: all four or none
  float g[4] = {0.f, 0.f, 0.f, 0.f}, cs_g[4] = {0.f, 0.f, 0.f, 0.f}, cs_b[4] = {0.f, 0.f, 0.f, 0.f};
  if (col_ok) load_vec(gamma + c0 + cl, g);
  for (int pass = 0; pass < kPartRows / kBM; ++pass) {
    const int m0 = blockIdx.x * kPartRows + pass * kBM;
    if (m0 >= M) break;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < N; k0 += kBK) {
      for (int idx = tid; idx < kBM * kBK; idx += kThreads) {
        const int r = idx / kBK, kk = idx % kBK;
        const int row = m0 + r, col = k0 + kk;
        Ds[r * kLdD + kk] = (row < M && col < N) ? dy[(size_t)row * N + col] : 0.f;
      }
      for (int v = tid; v < kBK * kBN / 4; v += kThreads) {
        const int kr = v / (kBN / 4), cc = (v % (kBN / 4)) * 4;
        float vals[4] = {0.f, 0.f, 0.f, 0.f};
        if (k0 + kr < N && c0 + cc < C) load_vec(w + (size_t)(k0 + kr) * C + c0 + cc, vals);
#pragma unroll
        for (int i = 0; i < 4; ++i) Ws[kr * kLdW + cc + i] = vals[i];
      }
      __syncthreads();
      mma_chunk([&](int r, int kk) { return Ds[r * kLdD + kk]; }, Ws, ty, tx, acc);
      __syncthreads();
    }
    // rows ty*4 + i of the pass (warp-uniform), columns cl .. cl+3
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
      if (row >= M) continue;
      float s1 = 0.f, s2 = 0.f;
      if (col_ok) {
        const float mu = mean[row], rs = rstd[row];
        float xv[4], d[4];
        load_vec(x + (size_t)row * C + c0 + cl, xv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float xh = (xv[j] - mu) * rs, dn = acc[i][j];
          d[j] = dn * g[j];
          s1 += d[j];
          s2 += d[j] * xh;
          cs_g[j] += dn * xh;
          cs_b[j] += dn;
        }
        *reinterpret_cast<float4*>(dxh + (size_t)row * C + c0 + cl) =
            make_float4(d[0], d[1], d[2], d[3]);
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0)
        *reinterpret_cast<float2*>(row_parts + ((size_t)blockIdx.y * M + row) * 2) =
            make_float2(s1, s2);
    }
  }
  // column partials: the 8 warps, in a fixed order
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[(ty * kBN + cl + j) * 2] = cs_g[j];
    red[(ty * kBN + cl + j) * 2 + 1] = cs_b[j];
  }
  __syncthreads();
  for (int idx = tid; idx < 2 * kBN; idx += kThreads) {
    const int c = idx >> 1, q = idx & 1;
    float sum = 0.f;
#pragma unroll
    for (int wi = 0; wi < 8; ++wi) sum += red[(wi * kBN + c) * 2 + q];
    if (c0 + c < C) (q == 0 ? dg_parts : db_parts)[(size_t)blockIdx.x * C + c0 + c] = sum;
  }
}


// ------------------------------------------------------- bf16 / fp16: wgmma
constexpr int kTileM = 128;          // rows of a GEMM tile (two warpgroups of 64)
constexpr int kTileK = 64;           // K slice: 128 bytes of 16-bit values
constexpr int kStages = 4;           // TMA ring depth
constexpr int kGemmThreads = 384;    // consumer warpgroups 0, 1; producer warpgroup 2
constexpr int kTileBytes = kTileM * kTileK * 2;  // a 128 x 64 tile of x or dy
constexpr int kBoxBytes = 64 * kTileK * 2;       // a 64 x 64 box of W
constexpr int kBwdBC = 128;          // columns of C per backward tile
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// (x - mu) * rs * g + b for a pair of x's dtype, in fp32 as two FMAs an
// element: fma(x, rs, -mu * rs), then fma(., g, b); rounded back to T.
template <typename T>
__device__ __forceinline__ uint32_t ln_pair(uint32_t xv, float rs, float nmr, float2 g, float2 b) {
  const float2 v = unpack2<T>(xv);
  return pack2<T>(fmaf(fmaf(v.x, rs, nmr), g.x, b.x), fmaf(fmaf(v.y, rs, nmr), g.y, b.y));
}

__device__ __forceinline__ void consumer_bar_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(2 * 128) : "memory");
}

// mean and rstd (M,) fp32, one warp per row: two passes over the row (the
// second from L1/L2), var = mean((x - mean)^2) as the TPU kernel. For the
// 16-bit GEMM, threads 0 .. C-1 of the grid also write gamma and beta as
// fp32 into gb (2C), its per-slice copy source; the fp32 GEMM passes none.
template <typename T>
__global__ void __launch_bounds__(256)
ln_stats_kernel(const T* __restrict__ x, const T* __restrict__ gamma, const T* __restrict__ beta,
                float* __restrict__ gb, float* __restrict__ mean, float* __restrict__ rstd,
                int M, int C, float eps) {
  constexpr int kVec = Vec<T>::kN;
  const int gi = blockIdx.x * 256 + threadIdx.x;
  if (gb != nullptr && gi < C) {
    gb[gi] = to_float(gamma[gi]);
    gb[C + gi] = to_float(beta[gi]);
  }
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= M) return;
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
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

// The forward's output tile is 128 x kFwdBN: at 256 half as many column
// blocks normalize the same x rows as at 128, and it was the faster width
// when both were timed on the H100. A stage holds the x tile, the W tile,
// then the slice's fp32 gamma and beta (64 each), padded to the 1024-byte
// swizzle atom; three stages leave room for the y tile's staging buffer.
constexpr int kFwdBN = 256;
constexpr int kFwdStages = 3;
constexpr int kFwdStageBytes =
    (kTileBytes + kFwdBN * kTileK * 2 + 2 * kTileK * 4 + 1023) / 1024 * 1024;
constexpr int kFwdSmem =
    1024 + kFwdStages * kFwdStageBytes + kTileM * kFwdBN * 2 + 16 * kFwdStages;

// Persistent: block b computes the y tiles b, b + gridDim.x, ... of 128
// rows x kFwdBN columns (column tiles fastest, so the blocks in flight share
// their x rows), so the producer loads the next tile while the consumers
// write this one.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads, 1)
ln_linear_fwd_wgmma(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap w_map,
                    const __grid_constant__ CUtensorMap y_map, const float* __restrict__ gb,
                    const T* __restrict__ bias, const float* __restrict__ mean,
                    const float* __restrict__ rstd, int M, int C, int N) {
  using namespace sm90;
  constexpr int BN = kFwdBN, kS = kFwdStages, kStageBytes = kFwdStageBytes;
  constexpr int kGbOffset = kTileBytes + BN * kTileK * 2;  // gamma, beta in a stage
  extern __shared__ __align__(1024) unsigned char smem_ring[];
  const uint32_t raw = smem_u32(smem_ring);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* ring = smem_ring + (base - raw);
  const uint32_t stg = base + kS * kStageBytes;  // the y tile: BN / 64 swizzled boxes
  const uint32_t bars = stg + kTileM * BN * 2;   // full[kS], empty[kS]
  const int tiles_n = (N + BN - 1) / BN, tiles = tiles_n * ((M + kTileM - 1) / kTileM);
  const int nk = C / kTileK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(bars + 8 * s, 1);             // the producer's expect-tx
      mbar_init(bars + 8 * (kS + s), 8);      // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread issues every load
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      int it = 0;  // slices issued so far: stage it % kS, round it / kS
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * kTileM, n0 = (tile % tiles_n) * BN;
        for (int k = 0; k < nk; ++k, ++it) {
          const int s = it % kS;
          const uint32_t stage = base + s * kStageBytes, full = bars + 8 * s;
          mbar_wait(bars + 8 * (kS + s), ((it / kS) & 1) ^ 1);
          mbar_arrive_expect_tx(full, kGbOffset + 2 * kTileK * 4);
          tma_load_2d(stage, &x_map, full, k * kTileK, m0);
          tma_load_2d(stage + kTileBytes, &w_map, full, k * kTileK, n0);
          bulk_load(stage + kGbOffset, gb + k * kTileK, kTileK * 4, full);
          bulk_load(stage + kGbOffset + kTileK * 4, gb + C + k * kTileK, kTileK * 4, full);
        }
      }
    }
  } else {  // consumers: warpgroup wg owns tile rows 64 wg .. 64 wg + 63
    setmaxnreg_inc<kConsumerRegs>();
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = wg * 64 + warp * 16 + g;  // this thread's tile rows: r0, r0 + 8
    // ldmatrix: this lane addresses row (lane % 8) of matrix lane / 8, i.e.
    // tile row lrow and 16-byte chunk 2 kk + (lane / 16) of the K slice,
    // stored at chunk ^ (row % 8) by the 128-byte swizzle
    const int lrow = wg * 64 + warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
    const int chunk_hi = lane >> 4;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * kTileM, n0 = (tile % tiles_n) * BN;
      float rs[2], nmr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = m0 + r0 + 8 * i;  // rows past M: zeros from TMA, never stored
        rs[i] = row < M ? rstd[row] : 0.f;
        nmr[i] = row < M ? -mean[row] * rs[i] : 0.f;
      }
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int k = 0; k < nk; ++k, ++it) {
        const int s = it % kS;
        const uint32_t xs = base + s * kStageBytes, ws = xs + kTileBytes;
        const float* gs = reinterpret_cast<const float*>(ring + s * kStageBytes + kGbOffset);
        mbar_wait(bars + 8 * s, (it / kS) & 1);
        // the slice's A fragments: x through ldmatrix, normalized, rounded to T
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          ldmatrix_x4(a[kk], xs + lrow * 128 + (((2 * kk + chunk_hi) ^ (lane & 7)) << 4));
          const int c = kk * 16 + 2 * t;
          const float2 g01 = *reinterpret_cast<const float2*>(gs + c);
          const float2 g89 = *reinterpret_cast<const float2*>(gs + c + 8);
          const float2 b01 = *reinterpret_cast<const float2*>(gs + kTileK + c);
          const float2 b89 = *reinterpret_cast<const float2*>(gs + kTileK + c + 8);
          a[kk][0] = ln_pair<T>(a[kk][0], rs[0], nmr[0], g01, b01);
          a[kk][1] = ln_pair<T>(a[kk][1], rs[1], nmr[1], g01, b01);
          a[kk][2] = ln_pair<T>(a[kk][2], rs[0], nmr[0], g89, b89);
          a[kk][3] = ln_pair<T>(a[kk][3], rs[1], nmr[1], g89, b89);
        }
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<T, BN>(acc, a[kk], sw128_desc(ws + kk * 32, 16, 1024), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(a[kk]);  // the wgmma read them until here
        if (lane == 0) mbar_arrive(bars + 8 * (kS + s));
      }

      // epilogue: bias in fp32, rounded once, staged as BN / 64 swizzled
      // boxes of 128 rows x 64 columns and written by TMA, which skips rows
      // >= M and columns >= N; the staging buffer is free again once the
      // previous tile's stores have read it
      if (threadIdx.x == 0) tma_store_wait_read();
      consumer_bar_sync();
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int cl = 8 * j + 2 * t;
        const float2 bb = n0 + cl < N ? load2(bias + n0 + cl) : make_float2(0.f, 0.f);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<uint32_t*>(ring + (stg - base) + (j / 8) * kTileBytes +
                                       sw128_offset(r0 + 8 * i, cl & 63)) =
              pack2<T>(acc[4 * j + 2 * i] + bb.x, acc[4 * j + 2 * i + 1] + bb.y);
      }
      fence_proxy_async();
      consumer_bar_sync();
      if (threadIdx.x == 0) {
        for (int box = 0; box < BN / 64 && n0 + 64 * box < N; ++box)
          tma_store_2d(&y_map, stg + box * kTileBytes, n0 + 64 * box, m0);
        tma_store_commit();
      }
    }
    if (threadIdx.x == 0) tma_store_wait_all();
  }
}

// Shared memory of the backward: the ring (a dy tile and kBwdBC / 64 W
// boxes a stage), the x tile of the epilogue (kBwdBC / 64 swizzled boxes of
// 128 rows x 64 columns), the column sums of the 8 consumer warps, the
// barriers.
constexpr int kBwdStageBytes = kTileBytes + (kBwdBC / 64) * kBoxBytes;
constexpr int kBwdSmem = 1024 + kStages * kBwdStageBytes + (kBwdBC / 64) * kTileBytes +
                         8 * kBwdBC * 2 * 4 + 8 * (2 * kStages + 2);

// dn tiles of 128 rows x kBwdBC columns of C and their LayerNorm-backward
// epilogue (see the header). Persistent, as the forward: block b takes tiles
// b, b + gridDim.x, ... (column tiles fastest). The producer also loads each
// tile's x block for the epilogue once the tile's slices are issued.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads, 1)
ln_linear_bwd_wgmma(const __grid_constant__ CUtensorMap dy_map,
                    const __grid_constant__ CUtensorMap w_map,
                    const __grid_constant__ CUtensorMap x_map, const T* __restrict__ gamma,
                    const float* __restrict__ mean, const float* __restrict__ rstd,
                    float* __restrict__ dxh,
                    float* __restrict__ row_parts, float* __restrict__ dg_parts,
                    float* __restrict__ db_parts, int M, int C, int N) {
  using namespace sm90;
  constexpr int BC = kBwdBC;
  constexpr int kStageBytes = kBwdStageBytes;
  constexpr int kXBytes = (BC / 64) * kTileBytes;
  constexpr int kRedBytes = 8 * BC * 2 * 4;
  extern __shared__ __align__(1024) unsigned char smem_ring[];
  const uint32_t raw = smem_u32(smem_ring);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t xbuf = base + kStages * kStageBytes;
  const unsigned char* xs = smem_ring + (xbuf - raw);
  float* red = reinterpret_cast<float*>(smem_ring + (xbuf - raw) + kXBytes);
  // full[kStages], empty[kStages], then the x tile's full and empty
  const uint32_t bars = xbuf + kXBytes + kRedBytes;
  const uint32_t xfull = bars + 16 * kStages, xempty = xfull + 8;
  const int tiles_c = (C + BC - 1) / BC, tiles = tiles_c * ((M + kTileM - 1) / kTileM);
  const int nk = (N + kTileK - 1) / kTileK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), 8);
    }
    mbar_init(xfull, 1);
    mbar_init(xempty, 8);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      int it = 0, round = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++round) {
        const int c0 = (tile % tiles_c) * BC, m0 = (tile / tiles_c) * kTileM;
        // W boxes wholly past C (the last tile of a C that is no multiple
        // of BC) are not loaded: their columns of dn are never used
        const int boxes = min(BC, C - c0) / 64;
        for (int k = 0; k < nk; ++k, ++it) {
          const int s = it % kStages;
          const uint32_t stage = base + s * kStageBytes, full = bars + 8 * s;
          mbar_wait(bars + 8 * (kStages + s), ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(full, kTileBytes + boxes * kBoxBytes);
          tma_load_2d(stage, &dy_map, full, k * kTileK, m0);
          for (int b = 0; b < boxes; ++b)
            tma_load_2d(stage + kTileBytes + b * kBoxBytes, &w_map, full, c0 + 64 * b,
                        k * kTileK);
        }
        mbar_wait(xempty, (round & 1) ^ 1);  // the previous tile's epilogue is done with it
        mbar_arrive_expect_tx(xfull, boxes * kTileBytes);
        for (int b = 0; b < boxes; ++b)
          tma_load_2d(xbuf + b * kTileBytes, &x_map, xfull, c0 + 64 * b, m0);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int wi = wg * 4 + warp;
    const int r0 = wg * 64 + warp * 16 + g;  // this thread's tile rows: r0, r0 + 8
    int it = 0, round = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++round) {
      const int c0 = (tile % tiles_c) * BC, m0 = (tile / tiles_c) * kTileM;
      float acc[BC / 2];
#pragma unroll
      for (int i = 0; i < BC / 2; ++i) acc[i] = 0.f;
      for (int k = 0; k < nk; ++k, ++it) {
        const int s = it % kStages;
        const uint32_t ds = base + s * kStageBytes + wg * 64 * 128;
        const uint32_t ws = base + s * kStageBytes + kTileBytes;
        mbar_wait(bars + 8 * s, (it / kStages) & 1);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<T, BC, 1>(acc, sw128_desc(ds + kk * 32, 16, 1024),
                             sw128_desc(ws + kk * 16 * 128, kBoxBytes, 1024), 1);
        wgmma_commit();
        wgmma_wait<1>();  // the previous slice's products are done: release its stage
        if (k > 0 && lane == 0) mbar_arrive(bars + 8 * (kStages + (it - 1) % kStages));
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(bars + 8 * (kStages + (it - 1) % kStages));

      const int row0 = m0 + r0;
      bool ok[2];
      float mu[2], rs[2], s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ok[i] = row0 + 8 * i < M;  // rows past M (zeros from TMA): neither stored nor summed
        mu[i] = ok[i] ? mean[row0 + 8 * i] : 0.f;
        rs[i] = ok[i] ? rstd[row0 + 8 * i] : 0.f;
      }
      consumer_bar_sync();  // the previous tile's column sums have been read from red
      mbar_wait(xfull, round & 1);
#pragma unroll
      for (int j = 0; j < BC / 8; ++j) {
        const int col = c0 + 8 * j + 2 * t;  // C % 64 == 0: warp-uniform test
        float cs[4] = {0.f, 0.f, 0.f, 0.f};  // sums of dn * xh and dn, columns col, col + 1
        if (col < C) {
          const float2 gm = load2(gamma + col);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (!ok[i]) continue;
            const size_t at = (size_t)(row0 + 8 * i) * C + col;
            const float2 xv = unpack2<T>(*reinterpret_cast<const uint32_t*>(
                xs + j / 8 * kTileBytes + sw128_offset(r0 + 8 * i, (8 * j + 2 * t) & 63)));
            const float dn0 = acc[4 * j + 2 * i], dn1 = acc[4 * j + 2 * i + 1];
            const float xh0 = __fmul_rn(__fsub_rn(xv.x, mu[i]), rs[i]);
            const float xh1 = __fmul_rn(__fsub_rn(xv.y, mu[i]), rs[i]);
            const float d0 = __fmul_rn(dn0, gm.x), d1 = __fmul_rn(dn1, gm.y);
            *reinterpret_cast<float2*>(dxh + at) = make_float2(d0, d1);
            s1[i] += d0 + d1;
            s2[i] += d0 * xh0 + d1 * xh1;
            cs[0] += dn0 * xh0;
            cs[1] += dn1 * xh1;
            cs[2] += dn0;
            cs[3] += dn1;
          }
        }
        // the 8 lanes g of a column, then one write a warp
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            cs[q] += __shfl_xor_sync(0xffffffffu, cs[q], off);
        if (g == 0) {
          float* r = red + ((size_t)wi * BC + 8 * j + 2 * t) * 2;
          *reinterpret_cast<float4*>(r) = make_float4(cs[0], cs[2], cs[1], cs[3]);
        }
      }
      if (lane == 0) mbar_arrive(xempty);
      // row partials: the 4 lanes t of a row
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], off);
          s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], off);
        }
        if (t == 0 && ok[i])
          *reinterpret_cast<float2*>(row_parts +
                                     ((size_t)(c0 / BC) * M + row0 + 8 * i) * 2) =
              make_float2(s1[i], s2[i]);
      }
      // column partials: the 8 warps, in a fixed order
      consumer_bar_sync();
      for (int idx = threadIdx.x; idx < 2 * BC; idx += 256) {
        const int cl = idx >> 1, q = idx & 1;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) sum += red[(w * BC + cl) * 2 + q];
        if (c0 + cl < C) (q == 0 ? dg_parts : db_parts)[(size_t)(m0 / kTileM) * C + c0 + cl] = sum;
      }
    }
  }
}

// Four elements of T as fp32, and back (rounded once): 16-byte aligned.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
}
template <typename T> __device__ __forceinline__ void load4(const T* p, float (&v)[4]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const float2 lo = unpack2<T>(r.x), hi = unpack2<T>(r.y);
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <typename T> __device__ __forceinline__ void store4(T* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2<T>(v[0], v[1]), pack2<T>(v[2], v[3]));
}

// dx = rstd * (dxh - s1 / C - xh * s2 / C), one warp per row, with s1, s2
// the sums of the row partials over the column tiles (every dtype).
template <typename T>
__global__ void __launch_bounds__(256)
ln_bwd_finish_kernel(const float* __restrict__ dxh, const float* __restrict__ row_parts,
                     const T* __restrict__ x, const float* __restrict__ mean,
                     const float* __restrict__ rstd, T* __restrict__ dx, int M, int C,
                     int tiles) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= M) return;
  float s1 = 0.f, s2 = 0.f;
  for (int tc = lane; tc < tiles; tc += 32) {
    const float2 p = *reinterpret_cast<const float2*>(row_parts + ((size_t)tc * M + row) * 2);
    s1 += p.x;
    s2 += p.y;
  }
  const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
  const float mu = mean[row], rs = rstd[row];
  const size_t off = (size_t)row * C;
  for (int c = lane * 4; c < C; c += 128) {
    float dv[4], xv[4], o[4];
    load4(dxh + off + c, dv);
    load4(x + off + c, xv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float xh = __fmul_rn(__fsub_rn(xv[i], mu), rs);
      o[i] = __fmul_rn(rs, __fsub_rn(__fsub_rn(dv[i], m1), __fmul_rn(xh, m2)));
    }
    store4(dx + off + c, o);
  }
}

// The card's SM count: the persistent GEMMs' grid (read on the first call).
int sm_count() {
  static int count = 0;
  int dev = 0;
  if (count == 0 && cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  return count;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool* configured) {
  if (*configured) return cudaSuccess;  // the attribute is per kernel, set once
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) *configured = true;
  return err;
}

bool fma_shape_ok(int M, int C, int N) { return M > 0 && N > 0 && C > 0 && C % kBK == 0; }
bool wgmma_shape_ok(int M, int C, int N) {
  return M > 0 && N > 0 && N % 8 == 0 && C > 0 && C % kTileK == 0;
}

cudaError_t launch_fwd_fp32(const void* x, const void* g, const void* b, const void* w,
                            const void* bias, void* y, float* mean, float* rstd, int M, int C,
                            int N, float eps, cudaStream_t stream) {
  if (!fma_shape_ok(M, C, N)) return cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float *gf = static_cast<const float*>(g), *bf = static_cast<const float*>(b);
  ln_stats_kernel<float><<<(M + 7) / 8, 256, 0, stream>>>(xf, gf, bf, nullptr, mean, rstd, M, C,
                                                         eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  ln_linear_fwd_kernel<<<grid, kThreads, 0, stream>>>(
      xf, gf, bf, static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(y), mean, rstd, M, C, N);
  return cudaGetLastError();
}

cudaError_t launch_bwd_fp32(const void* dy, const void* w, const void* x, const void* g,
                            const float* mean, const float* rstd, void* dx, float* dg_parts,
                            float* db_parts, float* scratch, int M, int C, int N,
                            cudaStream_t stream) {
  if (!fma_shape_ok(M, C, N)) return cudaErrorInvalidValue;
  static_assert(kBN == kBwdBC, "the fp32 and 16-bit backward share the scratch layout");
  const int tiles_c = (C + kBN - 1) / kBN;
  float* dxh = scratch;                        // (M, C)
  float* row_parts = scratch + (size_t)M * C;  // (tiles_c, M, 2)
  const float* xf = static_cast<const float*>(x);
  ln_linear_bwd_dx_kernel<<<dim3((M + kPartRows - 1) / kPartRows, tiles_c), kThreads, 0,
                            stream>>>(static_cast<const float*>(dy), static_cast<const float*>(w),
                                      xf, static_cast<const float*>(g), mean, rstd, dxh,
                                      row_parts, dg_parts, db_parts, M, C, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_bwd_finish_kernel<float><<<(M + 7) / 8, 256, 0, stream>>>(
      dxh, row_parts, xf, mean, rstd, static_cast<float*>(dx), M, C, tiles_c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd_wgmma(const void* x, const void* g, const void* b, const void* w,
                             const void* bias, void* y, float* mean, float* rstd, float* gb,
                             int M, int C, int N, float eps, cudaStream_t stream) {
  if (!wgmma_shape_ok(M, C, N)) return cudaErrorInvalidValue;
  constexpr bool kBf16 = sm90::WgmmaType<T>::kBf16;
  static_assert(kFwdSmem <= kMaxSmem, "forward ring exceeds shared memory");
  static bool configured = false;
  cudaError_t err = allow_smem(ln_linear_fwd_wgmma<T>, &configured);
  if (err != cudaSuccess) return err;
  CUtensorMap x_map, w_map, y_map;
  err = encode_tma_2d(&x_map, kBf16, x, M, C, C, kTileM, kTileK);
  if (err == cudaSuccess) err = encode_tma_2d(&w_map, kBf16, w, N, C, C, kFwdBN, kTileK);
  if (err == cudaSuccess) err = encode_tma_2d(&y_map, kBf16, y, M, N, N, kTileM, 64);
  if (err != cudaSuccess) return err;
  const int stat_blocks = max((M + 7) / 8, (C + 255) / 256);
  ln_stats_kernel<T><<<stat_blocks, 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(b), gb, mean,
      rstd, M, C, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int tiles = ((N + kFwdBN - 1) / kFwdBN) * ((M + kTileM - 1) / kTileM), sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  ln_linear_fwd_wgmma<T><<<min(tiles, sms), kGemmThreads, kFwdSmem, stream>>>(
      x_map, w_map, y_map, gb, static_cast<const T*>(bias), mean, rstd, M, C, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_wgmma(const void* dy, const void* w, const void* x, const void* g,
                             const float* mean, const float* rstd, void* dx, float* dg_parts,
                             float* db_parts, float* scratch, int M, int C, int N,
                             cudaStream_t stream) {
  if (!wgmma_shape_ok(M, C, N)) return cudaErrorInvalidValue;
  constexpr bool kBf16 = sm90::WgmmaType<T>::kBf16;
  static_assert(kBwdSmem <= kMaxSmem, "backward ring exceeds shared memory");
  static bool configured = false;
  cudaError_t err = allow_smem(ln_linear_bwd_wgmma<T>, &configured);
  if (err != cudaSuccess) return err;
  CUtensorMap dy_map, w_map, x_map;
  err = encode_tma_2d(&dy_map, kBf16, dy, M, N, N, kTileM, kTileK);
  if (err == cudaSuccess) err = encode_tma_2d(&w_map, kBf16, w, N, C, C, kTileK, 64);
  if (err == cudaSuccess) err = encode_tma_2d(&x_map, kBf16, x, M, C, C, kTileM, 64);
  if (err != cudaSuccess) return err;
  const int tiles_c = (C + kBwdBC - 1) / kBwdBC, sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  float* dxh = scratch;                        // (M, C)
  float* row_parts = scratch + (size_t)M * C;  // (tiles_c, M, 2)
  ln_linear_bwd_wgmma<T><<<min(tiles_c * ((M + kTileM - 1) / kTileM), sms), kGemmThreads,
                           kBwdSmem, stream>>>(dy_map, w_map, x_map, static_cast<const T*>(g),
                                               mean, rstd, dxh, row_parts, dg_parts, db_parts,
                                               M, C, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_bwd_finish_kernel<T><<<(M + 7) / 8, 256, 0, stream>>>(
      dxh, row_parts, static_cast<const T*>(x), mean, rstd, static_cast<T*>(dx), M, C, tiles_c);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dstorch

// C entry points bound with ctypes. Each returns its launches' cudaGetLastError().
// Forward scratch: 2 C floats (gamma and beta in fp32) for bf16 / fp16,
// unused (null) for fp32.
extern "C" int dstorch_ln_linear_fwd(int dtype, const void* x, const void* gamma,
                                     const void* beta, const void* w, const void* bias,
                                     void* y, void* mean, void* rstd, void* scratch, int M,
                                     int C, int N, float eps, void* stream) {
  using namespace dstorch;
  float *mu = static_cast<float*>(mean), *rs = static_cast<float*>(rstd);
  float* gb = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return (int)launch_fwd_fp32(x, gamma, beta, w, bias, y, mu, rs, M, C, N, eps, st);
    case kBFloat16:
      return (int)launch_fwd_wgmma<__nv_bfloat16>(x, gamma, beta, w, bias, y, mu, rs, gb, M, C,
                                                  N, eps, st);
    case kFloat16:
      return (int)launch_fwd_wgmma<__half>(x, gamma, beta, w, bias, y, mu, rs, gb, M, C, N, eps,
                                           st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Backward-dx scratch: (M * C + 2 * M * ceil(C / 128)) floats for every
// dtype (dxh and the row partials).
extern "C" int dstorch_ln_linear_bwd_dx(int dtype, const void* dy, const void* w,
                                        const void* x, const void* gamma, const void* mean,
                                        const void* rstd, void* dx, void* dg_parts,
                                        void* db_parts, void* scratch, int M, int C, int N,
                                        void* stream) {
  using namespace dstorch;
  const float *mu = static_cast<const float*>(mean), *rs = static_cast<const float*>(rstd);
  float *dg = static_cast<float*>(dg_parts), *db = static_cast<float*>(db_parts);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return (int)launch_bwd_fp32(dy, w, x, gamma, mu, rs, dx, dg, db, sc, M, C, N, st);
    case kBFloat16:
      return (int)launch_bwd_wgmma<__nv_bfloat16>(dy, w, x, gamma, mu, rs, dx, dg, db, sc, M, C,
                                                  N, st);
    case kFloat16:
      return (int)launch_bwd_wgmma<__half>(dy, w, x, gamma, mu, rs, dx, dg, db, sc, M, C, N, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
