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
// What bounds it on the H100: the two products do 4 T^2 D / 2 flops per
// head causally against 4 T D * 2 bytes of input and output, T / 4 flops a
// byte, under the ~295 of the bf16 tensor cores' ridge up to T ~ 1024: the
// bound is bytes at the serving prefill widths (B=1, H=12, T up to 1024)
// and at the training shape (B=10, H=16, D=64, T=1024: 0.0252 ms, with
// operations at 0.0217 close behind), operations at T=8192. Either way the
// products must run on the tensor cores to come near it.
//
// Two designs; the entry point takes the one flash_attention.py's
// flash_design(dtype, D) names, and neither falls back to the other:
//  - "wgmma", bf16 and fp16 at D = 64 and 128: a warp-specialised kernel on
//    wgmma.cuh. A block takes 128 query rows of one (batch, head) with two
//    consumer warpgroups of 64 rows, or 64 rows with one where 128-row
//    blocks would leave SMs idle (serving prefill: B=1, H=12) and at D =
//    128, whose two-warpgroup kernel spills at the 168 registers a thread
//    that 384 threads leave (flash_attention.py's block_rows; both sizes
//    were timed on the H100, PERF.md). The longest query tiles under causal
//    masking are launched first. One producer thread loads the Q tile once
//    and a ring of K and V tiles (128 keys, a barrier each, so S = Q K^T
//    starts while V lands) by TMA over 3-D tensor maps (H D, T, B), whose T
//    bound zero-fills ragged tiles without reading the next batch's rows.
//    Each consumer warpgroup runs S = Q K^T as an SS wgmma (Q and K
//    K-major: D is contiguous), masks and runs the online softmax on the
//    fp32 accumulator in registers (base 2, the scale folded into one FMA,
//    ex2.approx), packs P to 16-bit A fragments straight from the
//    accumulator (wgmma.cuh's pack_afrags: no shuffle, P never touches
//    shared memory) and runs O += P V as an RS wgmma with V read as it lies,
//    MN-major, through the transpose-B bit; tile j's softmax runs while the
//    tensor cores compute tile j-1's P V. Keys above the diagonal are never
//    loaded. out is written with plain stores masked at Tq, lse by one lane
//    a row.
//  - "fma", fp32 (whose 1e-4 tolerance TF32 misses) and D = 32 (64-byte
//    rows, below the 128-byte swizzle atom): one block of 256 threads per
//    (batch * head, 64-row query tile) walks 64-row key tiles kept in shared
//    memory as fp32 and runs both products on the FMA units (each thread a
//    4 x 4 block of S and a 4 x D/16 block of the accumulator).
#include "common.cuh"
#include "flash_sm90.cuh"
#include "wgmma.cuh"

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

// ------------------------------------------------------- bf16 / fp16: wgmma
namespace wg {

constexpr int kBN = 128;  // keys a K or V tile

// kWG consumer warpgroups of 64 query rows each (1 or 2), then the producer
template <int D, int kWG> struct Cfg {
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kBM = 64 * kWG;     // query rows a block
  static constexpr int kBoxes = D / 64;    // 128-byte swizzled boxes across D
  static constexpr int kQBox = kBM * 128;  // bytes of one box of the Q tile
  static constexpr int kKBox = kBN * 128;  // of one box of a K or V tile
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKBytes = kBoxes * kKBox;
  static constexpr int kStages = D == 64 ? 3 : 2;
  // the Q tile, kStages (K tile, V tile) pairs, then the barriers: q, k[kS], v[kS], empty[kS]
  static constexpr int kSmem = 1024 + kQBytes + kStages * 2 * kKBytes + 8 * (1 + 3 * kStages);
};

}  // namespace wg

// Each consumer warpgroup runs the key tiles as a two-deep software pipeline:
// while the tensor cores compute O += P_{j-1} V_{j-1}, its threads run tile
// j's softmax (S_j = Q K_j^T issued just before it); O is rescaled and P_j
// packed once that product has completed.
template <typename T, int D, int kWG>
__global__ void __launch_bounds__(wg::Cfg<D, kWG>::kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map, T* __restrict__ out,
                float* __restrict__ lse, int Tq, int Tk, int H, int KV, float scale,
                int causal) {
  using namespace sm90;
  using C = wg::Cfg<D, kWG>;
  constexpr int kS = C::kStages, kBM = C::kBM, kBN = wg::kBN;
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  const uint32_t qs = (smem_u32(smem_tiles) + 1023) & ~1023u;
  const uint32_t ring = qs + C::kQBytes;  // stage s: the K tile, then the V tile
  const uint32_t bars = ring + kS * 2 * C::kKBytes;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kS + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kS + s); };

  const int bh = blockIdx.x, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int m0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // the longest tiles launch first
  const int n_tiles = ((causal ? min(Tk, m0 + kBM) : Tk) + kBN - 1) / kBN;
  const int wgi = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 4 * kWG);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wgi == kWG) {  // producer: one thread issues every load
    if (threadIdx.x == 128 * kWG) {
      mbar_arrive_expect_tx(q_full, C::kQBytes);
      for (int x = 0; x < C::kBoxes; ++x)
        tma_load_3d(qs + x * C::kQBox, &q_map, q_full, h * D + 64 * x, m0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kS;
        const uint32_t ks = ring + s * 2 * C::kKBytes, vs = ks + C::kKBytes;
        mbar_wait(empty(s), ((it / kS) & 1) ^ 1);
        mbar_arrive_expect_tx(k_full(s), C::kKBytes);
        for (int x = 0; x < C::kBoxes; ++x)
          tma_load_3d(ks + x * C::kKBox, &k_map, k_full(s), kvh * D + 64 * x, it * kBN, b);
        mbar_arrive_expect_tx(v_full(s), C::kKBytes);
        for (int x = 0; x < C::kBoxes; ++x)
          tma_load_3d(vs + x * C::kKBox, &v_map, v_full(s), kvh * D + 64 * x, it * kBN, b);
      }
    }
  } else {  // consumers: warpgroup wgi owns query rows m0 + 64 wgi .. + 63
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, t = lane & 3;
    const int row0 = m0 + wgi * 64 + warp * 16 + (lane >> 2);  // rows row0, row0 + 8
    const float scale_log2 = scale * attn::kLog2e;
    const uint32_t qa = qs + wgi * 64 * 128;  // this warpgroup's rows of each Q box
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    // running max of the raw scores, this thread's part of the row sums
    float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
    float sc[kBN / 2];          // S_j, then P_j in fp32
    uint32_t pa[kBN / 16][4];  // P_j rounded to T: the A operand of O += P_j V_j

    // S_j = Q K_j^T into sc: one commit group
    auto issue_s = [&](int it) {
      const uint32_t ks = ring + (it % kS) * 2 * C::kKBytes;
      mbar_wait(k_full(it % kS), (it / kS) & 1);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<T, kBN, 0>(sc, sw128_desc(qa + (kk >> 2) * C::kQBox + (kk & 3) * 32, 16, 1024),
                            sw128_desc(ks + (kk >> 2) * C::kKBox + (kk & 3) * 32, 16, 1024),
                            kk > 0);
      wgmma_commit();
    };
    // O += P_j V_j (V read MN-major through the transpose-B bit): one commit group
    auto issue_pv = [&](int it) {
      const uint32_t vs = ring + (it % kS) * 2 * C::kKBytes + C::kKBytes;
      mbar_wait(v_full(it % kS), (it / kS) & 1);
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) fence_regs(pa[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs<T, D, 1>(o, pa[kk], sw128_desc(vs + kk * 16 * 128, C::kKBox, 1024), 1);
      wgmma_commit();
    };
    // tile j's online softmax on sc (masked past Tk and above the diagonal;
    // tiles that reach neither are not tested): p = exp2(s * scale log2(e) -
    // m * scale log2(e)) in one FMA, the row sums, and the factor alpha that
    // rescales what O and the sums hold so far
    auto softmax = [&](int it, float (&alpha)[2]) {
      const int n0 = it * kBN;
      const bool edge = n0 + kBN > Tk || (causal && n0 + kBN - 1 > m0 + wgi * 64);
      float mx[2] = {m_run[0], m_run[1]}, rowsum[2] = {0.f, 0.f}, ms[2];
#pragma unroll
      for (int e = 0; e < kBN / 2; ++e) {
        const int r = attn::acc_half(e), col = n0 + attn::acc_col(e, t);
        // rows past Tq are never stored, so only keys are tested (testing
        // the row as well, through attn::masked, measured slower on the H100)
        if (edge && (col >= Tk || (causal && col > row0 + 8 * r))) sc[e] = kNegInf;
        mx[r] = fmaxf(mx[r], sc[e]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the 4 lanes t of a row
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // a row with no key yet subtracts 0, so its masked scores give p = 0
        ms[r] = mx[r] == kNegInf ? 0.f : mx[r] * scale_log2;
        alpha[r] = attn::exp2_approx(fmaf(m_run[r], scale_log2, -ms[r]));
        m_run[r] = mx[r];
      }
#pragma unroll
      for (int e = 0; e < kBN / 2; ++e) {
        const int r = attn::acc_half(e);
        sc[e] = attn::exp2_approx(fmaf(sc[e], scale_log2, -ms[r]));
        rowsum[r] += sc[e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rowsum[r];
    };

    float alpha[2];
    mbar_wait(q_full, 0);
    issue_s(0);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(0, alpha);  // O is still 0: nothing to rescale
    pack_afrags<T, kBN>(sc, pa);
    for (int it = 1; it < n_tiles; ++it) {
      issue_s(it);
      issue_pv(it - 1);
      wgmma_wait<1>();  // S_j is done; O += P_{j-1} V_{j-1} may still run
      fence_regs(sc);
      softmax(it, alpha);
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) fence_regs(pa[kk]);  // read until here
      if (lane == 0) mbar_arrive(empty((it - 1) % kS));
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] *= alpha[attn::acc_half(e)];
      pack_afrags<T, kBN>(sc, pa);
    }
    issue_pv(n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) fence_regs(pa[kk]);
    if (lane == 0) mbar_arrive(empty((n_tiles - 1) % kS));

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = row0 + 8 * r;
      if (row >= Tq) continue;
      l = fmaxf(l, 1e-30f);
      attn::store_acc_row<T, D>(out + (((size_t)b * Tq + row) * H + h) * D, o, r, t, 1.f / l);
      if (t == 0)
        lse[(size_t)bh * Tq + row] = (m_run[r] == kNegInf ? kNegInf : m_run[r] * scale) + logf(l);
    }
  }
}

template <typename T, int D, int kWG>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse,
                         int B, int Tq, int Tk, int H, int KV, float scale, int causal,
                         cudaStream_t stream) {
  using C = wg::Cfg<D, kWG>;
  constexpr bool kBf16 = sm90::WgmmaType<T>::kBf16;
  static bool configured = false;  // the attribute is per kernel, set once (eagerly)
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma<T, D, kWG>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = encode_tma_3d(&q_map, kBf16, q, B, Tq, (uint64_t)H * D, C::kBM);
  if (err == cudaSuccess) err = encode_tma_3d(&k_map, kBf16, k, B, Tk, (uint64_t)KV * D, wg::kBN);
  if (err == cudaSuccess) err = encode_tma_3d(&v_map, kBf16, v, B, Tk, (uint64_t)KV * D, wg::kBN);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Tq + C::kBM - 1) / C::kBM);
  flash_fwd_wgmma<T, D, kWG><<<grid, C::kThreads, C::kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<T*>(out), lse, Tq, Tk, H, KV, scale, causal);
  return cudaGetLastError();
}

// kWG: 2 (128-row blocks) or 1 (64-row blocks: grids that would leave SMs
// idle, and D = 128; flash_attention.py's block_rows chooses)
template <typename T>
cudaError_t launch_wgmma_dim(int D, int kWG, const void* q, const void* k, const void* v,
                             void* out, float* lse, int B, int Tq, int Tk, int H, int KV,
                             float scale, int causal, cudaStream_t stream) {
  if (D == 64 && kWG == 2)
    return launch_wgmma<T, 64, 2>(q, k, v, out, lse, B, Tq, Tk, H, KV, scale, causal, stream);
  if (D == 64 && kWG == 1)
    return launch_wgmma<T, 64, 1>(q, k, v, out, lse, B, Tq, Tk, H, KV, scale, causal, stream);
  if (D == 128 && kWG == 2)
    return launch_wgmma<T, 128, 2>(q, k, v, out, lse, B, Tq, Tk, H, KV, scale, causal, stream);
  if (D == 128 && kWG == 1)
    return launch_wgmma<T, 128, 1>(q, k, v, out, lse, B, Tq, Tk, H, KV, scale, causal, stream);
  return cudaErrorInvalidValue;
}

// The accumulator -> A-fragment packing alone, on one 64 x 64 tile, for a
// card test: o = round_T(a b^T) c for row-major (64, 64) a, b, c, with S =
// a b^T an SS wgmma (both K-major), pack_afrags, and o += P c an RS wgmma
// reading c MN-major through the transpose-B bit, as the attention kernels
// run them; o (64, 64) fp32.
template <typename T>
__global__ void __launch_bounds__(128)
wgmma_pack_probe(const __grid_constant__ CUtensorMap a_map,
                 const __grid_constant__ CUtensorMap b_map,
                 const __grid_constant__ CUtensorMap c_map, float* __restrict__ o) {
  using namespace sm90;
  constexpr int kTile = 64 * 128;
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  const uint32_t as = (smem_u32(smem_tiles) + 1023) & ~1023u, bs = as + kTile, cs = bs + kTile;
  const uint32_t bar = cs + kTile;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, 3 * kTile);
    tma_load_2d(as, &a_map, bar, 0, 0);
    tma_load_2d(bs, &b_map, bar, 0, 0);
    tma_load_2d(cs, &c_map, bar, 0, 0);
  }
  mbar_wait(bar, 0);
  float sc[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = acc[i] = 0.f;
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<T, 64, 0>(sc, sw128_desc(as + kk * 32, 16, 1024), sw128_desc(bs + kk * 32, 16, 1024), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  uint32_t pa[4][4];
  pack_afrags<T, 64>(sc, pa);
  fence_regs(acc);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<T, 64, 1>(acc, pa[kk], sw128_desc(cs + kk * 16 * 128, kTile, 1024), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
#pragma unroll
  for (int e = 0; e < 32; ++e)
    o[(warp * 16 + (lane >> 2) + 8 * attn::acc_half(e)) * 64 + attn::acc_col(e, t)] = acc[e];
}

template <typename T>
cudaError_t launch_pack_probe(const void* a, const void* b, const void* c, float* o,
                              cudaStream_t stream) {
  constexpr bool kBf16 = sm90::WgmmaType<T>::kBf16;
  constexpr int kSmem = 1024 + 3 * 64 * 128 + 8;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(wgmma_pack_probe<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap maps[3];
  const void* src[3] = {a, b, c};
  for (int i = 0; i < 3; ++i) {
    cudaError_t err = encode_tma_2d(&maps[i], kBf16, src[i], 64, 64, 64, 64, 64);
    if (err != cudaSuccess) return err;
  }
  wgmma_pack_probe<T><<<1, 128, kSmem, stream>>>(maps[0], maps[1], maps[2], o);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dstorch

// C entry points bound with ctypes. Each returns its launch's cudaGetLastError().
// design: 0 the FMA kernel (every dtype, D 32, 64, 128); 1 the wgmma kernel
// with 128-row blocks, 2 with 64-row blocks (bf16 and fp16, D 64 and 128);
// flash_attention.py's flash_design and fwd_block_rows choose.
extern "C" int dstorch_flash_attention_fwd(int dtype, int design, const void* q, const void* k,
                                           const void* v, void* out, void* lse, int B,
                                           int Tq, int Tk, int H, int KV, int D,
                                           float scale, int causal, void* stream) {
  using namespace dstorch;
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (design == 1 || design == 2) {
    const int wgs = design == 1 ? 2 : 1;
    switch (dtype) {
      case kBFloat16:
        return (int)launch_wgmma_dim<__nv_bfloat16>(D, wgs, q, k, v, out, l, B, Tq, Tk, H, KV,
                                                    scale, causal, st);
      case kFloat16:
        return (int)launch_wgmma_dim<__half>(D, wgs, q, k, v, out, l, B, Tq, Tk, H, KV, scale,
                                             causal, st);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (design != 0) return (int)cudaErrorInvalidValue;
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

// o (64, 64) fp32 = round(a b^T) c for (64, 64) 16-bit a, b, c (wgmma_pack_probe).
extern "C" int dstorch_wgmma_pack_probe(int dtype, const void* a, const void* b, const void* c,
                                        void* o, void* stream) {
  using namespace dstorch;
  float* out = static_cast<float*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBFloat16: return (int)launch_pack_probe<__nv_bfloat16>(a, b, c, out, st);
    case kFloat16: return (int)launch_pack_probe<__half>(a, b, c, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
