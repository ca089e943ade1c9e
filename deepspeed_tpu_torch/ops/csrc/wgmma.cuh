// Hopper (sm_90a) building blocks for the hand-written GEMM and attention
// kernels, as inline PTX: mbarriers, TMA 2-D and 3-D tile loads and their
// host-side descriptors, wgmma shared-memory matrix descriptors, the wgmma
// fence / commit / wait, and wgmma.mma_async for bf16 and fp16 with fp32
// accumulators, A from
// registers (RS) or shared memory (SS) and B from shared memory, B K-major
// or MN-major (transpose-B); and the packing of an fp32 accumulator into
// 16-bit A fragments (pack_afrags), by which the attention kernels feed P
// to the next product without leaving registers. Also the warp-level path
// that the small-tile kernels (int8_matmul's decode tiles, decode
// attention) take: cp.async copies, mma.sync m16n8k16 and the exact
// conversion of int8 pairs to 16-bit pairs.
//
// Tiles are 16-bit, 64 elements (128 bytes) along their contiguous dimension
// and loaded by TMA with the 128-byte swizzle, which is what the descriptors
// here describe. Each tile starts on a 1024-byte boundary (one swizzle atom
// of 8 rows x 128 bytes).
//
// Host side: the tensor maps are encoded with cuTensorMapEncodeTiled, fetched
// from the driver through cudaGetDriverEntryPoint, so a library built from
// this header links cudart only.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dstorch {
// Two 16-bit values in one 32-bit register (the low half first), to and
// from fp32; packing rounds to nearest even.
template <typename T> __device__ __forceinline__ float2 unpack2(uint32_t v);
template <> __device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}
template <> __device__ __forceinline__ float2 unpack2<__half>(uint32_t v) {
  return __half22float2(*reinterpret_cast<__half2*>(&v));
}
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
template <typename T> __device__ __forceinline__ float2 load2(const T* p) {
  return unpack2<T>(*reinterpret_cast<const uint32_t*>(p));
}

namespace sm90 {

// ---------------------------------------------------------------- device
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One arrival that also tells the barrier to expect `bytes` from TMA.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase differs from `parity`. A wait that lasts
// more than about 2^34 cycles (seconds) traps: a protocol fault ends the
// launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// TMA: the box at (c0 along the contiguous dimension, c1 along rows) of the
// tensor map into shared memory at `dst`, completing on barrier `bar`. Parts
// of the box outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// TMA: the box at (c0, c1, c2) of a 3-D tensor map, as tma_load_2d. The
// attention kernels map (B, T, heads * D) as (heads * D, T, B), so a box
// never crosses into the next batch's rows: rows past T arrive as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from global memory into shared memory, completing on barrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// TMA: shared memory at `src` into the box at (c0, c1) of the tensor map;
// the parts of the box outside the tensor are not written. Completion is
// tracked by bulk groups (tma_store_commit, tma_store_wait_read).
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until the committed stores have read their shared memory.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Waits until the committed stores are complete.
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Makes this thread's shared-memory writes visible to the async proxy (a
// TMA store or wgmma that reads them after a barrier).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-bit element (row, col) in a tile of rows of 64 elements
// (128 bytes) stored with the 128-byte swizzle (tile 1024-byte aligned).
__device__ __forceinline__ uint32_t sw128_offset(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// wgmma matrix descriptor of a 128-byte-swizzled tile in shared memory:
// start address, leading and stride byte offsets (16-byte units), layout
// type 1 (128-byte swizzle) in bits 62-63.
//  - K-major (rows of 64 K values, 128 bytes each): lbo unused (16), sbo =
//    1024, the stride between groups of 8 rows; step K by 16 values by
//    adding 32 bytes to the start address.
//  - MN-major (rows of 64 MN values for one K each): lbo = the stride between
//    64-wide MN blocks, sbo = 1024, the stride between groups of 8 K rows;
//    step K by 16 by adding 16 rows (2048 bytes).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Tells the compiler that registers are read and written here, so that it
// neither reads an accumulator before the wgmma that writes it has been
// waited for nor reuses an A-fragment register while a wgmma may read it.
template <int kN>
__device__ __forceinline__ void fence_regs(float (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int kN>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Register budget of a warpgroup (all 128 threads execute it).
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// Four 8x8 16-bit matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 and receives, in r[j], the pair of elements
// (row l / 4, columns 2 (l % 4), +1) of matrix j.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// wgmma.mma_async m64nNk16, fp32 accumulators d (N / 2 a thread) in the
// layout: d[4j + 0, 1] = (row g, columns 8j + 2t, +1), d[4j + 2, 3] = (row
// g + 8, the same columns), rows 16 w + ... for warp w of the warpgroup, with
// g = lane / 4 and t = lane % 4. scale_d = 0 overwrites d, 1 accumulates.
// RS: the A fragment a[4] of warp w holds rows 16w .. 16w + 15 of the 64 x
// 16 slice in the ldmatrix_x4 layout (matrices: rows 0-7 / 8-15 x columns
// 0-7, then the same for columns 8-15). SS: A is a K-major tile in shared
// memory. B is in shared memory: K-major (kTransB = 0) or MN-major (1).
// So an accumulator is already an A operand: its registers 8s .. 8s + 7
// (columns 16s .. 16s + 15) pack pairwise, (0, 1), (2, 3), (4, 5), (6, 7),
// into a[0 .. 3] of k-slice s, with no shuffle (pack_afrags).
#define DSTORCH_WGMMA_SS_N64(TY) \
  asm volatile( \
        "{\n.reg .pred p;\n" \
        "setp.ne.b32 p, %34, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32" TY TY " {" \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n" \
        : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB))

#define DSTORCH_WGMMA_SS_N128(TY) \
  asm volatile( \
        "{\n.reg .pred p;\n" \
        "setp.ne.b32 p, %66, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32" TY TY " {" \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n" \
        : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB))

#define DSTORCH_WGMMA_RS_N64(TY) \
  asm volatile( \
        "{\n.reg .pred p;\n" \
        "setp.ne.b32 p, %37, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32" TY TY " {" \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n" \
        : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(kTransB))

#define DSTORCH_WGMMA_RS_N128(TY) \
  asm volatile( \
        "{\n.reg .pred p;\n" \
        "setp.ne.b32 p, %69, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32" TY TY " {" \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n" \
        : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(kTransB))

#define DSTORCH_WGMMA_RS_N256(TY) \
  asm volatile( \
        "{\n.reg .pred p;\n" \
        "setp.ne.b32 p, %133, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n256k16.f32" TY TY " {" \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127" \
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n" \
        : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(kTransB))

template <typename T> struct WgmmaType;
template <> struct WgmmaType<__nv_bfloat16> { static constexpr bool kBf16 = true; };
template <> struct WgmmaType<__half> { static constexpr bool kBf16 = false; };

template <typename T, int N, int kTransB = 0>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  static_assert(N == 64 || N == 128 || N == 256, "wgmma_rs: add the m64nNk16 form for N");
  if constexpr (N == 64) {
    if constexpr (WgmmaType<T>::kBf16) { DSTORCH_WGMMA_RS_N64(".bf16"); }
    else { DSTORCH_WGMMA_RS_N64(".f16"); }
  } else if constexpr (N == 128) {
    if constexpr (WgmmaType<T>::kBf16) { DSTORCH_WGMMA_RS_N128(".bf16"); }
    else { DSTORCH_WGMMA_RS_N128(".f16"); }
  } else {
    if constexpr (WgmmaType<T>::kBf16) { DSTORCH_WGMMA_RS_N256(".bf16"); }
    else { DSTORCH_WGMMA_RS_N256(".f16"); }
  }
}

template <typename T, int N, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_ss: add the m64nNk16 form for N");
  if constexpr (N == 64) {
    if constexpr (WgmmaType<T>::kBf16) { DSTORCH_WGMMA_SS_N64(".bf16"); }
    else { DSTORCH_WGMMA_SS_N64(".f16"); }
  } else {
    if constexpr (WgmmaType<T>::kBf16) { DSTORCH_WGMMA_SS_N128(".bf16"); }
    else { DSTORCH_WGMMA_SS_N128(".f16"); }
  }
}

// The m64nN fp32 accumulator d, rounded to T, as the A fragments of its N
// / 16 k-slices (see the layout above): a[s][i] = (d[8s + 2i], d[8s + 2i + 1]).
template <typename T, int N>
__device__ __forceinline__ void pack_afrags(const float (&d)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int s = 0; s < N / 16; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[s][i] = pack2<T>(d[8 * s + 2 * i], d[8 * s + 2 * i + 1]);
}

#undef DSTORCH_WGMMA_SS_N64
#undef DSTORCH_WGMMA_SS_N128
#undef DSTORCH_WGMMA_RS_N64
#undef DSTORCH_WGMMA_RS_N128
#undef DSTORCH_WGMMA_RS_N256

}  // namespace sm90

// ------------------------------------------------------ warp-level (mma.sync)
// 16 (or 4) bytes global -> shared, asynchronously; zeros when !ok (src not
// read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// d += a b: mma.sync m16n8k16, row.col, 16-bit T inputs (bf16 or fp16), fp32
// accumulators
template <typename T>
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  if constexpr (sm90::WgmmaType<T>::kBf16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// The int8 values in bytes 0 and 2 of `pair` (bytes 1 and 3 ignored) as a
// 16-bit pair of type T, exactly (every int8 value is a bf16 and an fp16
// number). bf16: a = 0x4300 | (b & 0x7f) is 128 + (b & 0x7f), c = 0x4300 | (b
// & 0x80) is 128 (b >= 0) or 256 (b < 0), and one FMA takes a - c = b. fp16:
// 0x6400 | (b + 128) is 1024 + b + 128, and one FMA takes 1152 off it. Exact
// over all 256 values (card tests).
template <typename T> __device__ __forceinline__ uint32_t i8x2_to(uint32_t pair);
template <> __device__ __forceinline__ uint32_t i8x2_to<__nv_bfloat16>(uint32_t pair) {
  const uint32_t a = (pair & 0x007F007Fu) | 0x43004300u;
  const uint32_t c = (pair & 0x00800080u) | 0x43004300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(c), "r"(0xBF80BF80u), "r"(a));
  return d;
}
template <> __device__ __forceinline__ uint32_t i8x2_to<__half>(uint32_t pair) {
  const uint32_t a = ((pair ^ 0x00800080u) & 0x00FF00FFu) | 0x64006400u;
  uint32_t d;
  asm("fma.rn.f16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(0x64806480u), "r"(0xBC00BC00u), "r"(a));
  return d;
}

// ---------------------------------------------------------------- host
// cuTensorMapEncodeTiled's signature (cuda.h), reached through the runtime.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled; fetched once, on the first (eager)
// call, never during a graph capture that follows it.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 2-D tensor map over a row-major (rows, cols) matrix of 16-bit elements
// (row stride `ld` elements) for boxes of (box_rows, box_cols), 128-byte
// swizzle (box_cols = 64), zero fill out of bounds. Encoded on the host at
// every call: the caching allocator reuses addresses for other shapes, so a
// map is never cached by pointer.
inline cudaError_t encode_tma_2d(CUtensorMap* map, bool bf16, const void* base, uint64_t rows,
                                 uint64_t cols, uint64_t ld, uint32_t box_rows,
                                 uint32_t box_cols) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld * 2};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  CUresult r = fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 2,
                  const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 3-D tensor map over a (B, T, width) array of 16-bit elements (width
// contiguous, a multiple of 8) for boxes of (1, box_rows, 64), 128-byte
// swizzle: an attention operand (B, T, heads, D) seen as (B, T, heads * D),
// a box one head's 64 columns of box_rows rows of one batch. Rows past T
// load as zeros and never reach the next batch.
inline cudaError_t encode_tma_3d(CUtensorMap* map, bool bf16, const void* base, uint64_t batch,
                                 uint64_t rows, uint64_t width, uint32_t box_rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {width, rows, batch};
  const cuuint64_t strides[2] = {width * 2, rows * width * 2};
  const cuuint32_t box[3] = {64, box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 3,
                  const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace dstorch
