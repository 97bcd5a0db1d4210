// Hopper (sm_90a) building blocks of the warpgroup kernels: shared-memory
// matrix descriptors, wgmma issue and synchronisation, mbarriers and TMA
// tile copies, and the async-proxy fence that makes generic shared-memory
// writes visible to wgmma; on the host, the tensor-map encoder, the tile
// map of a strided [B, H, L, D] view, the 1-D map of per-row values, and
// `prepare`, which sets a kernel's attributes once per card.
//
// Every operand tile of the flash kernels uses wgmma's no-swizzle
// ("interleave") canonical layout, built from core matrices of 8 rows x 16 bytes (8 bf16) stored as
// 128 contiguous bytes. It takes any width that is a multiple of 8 elements,
// which the 80-byte rows of head dim 40 need (they fit no 32/64/128-byte
// swizzle atom). A descriptor gives two strides between core matrices:
//   LBO, between neighbours along K (the contracted dimension);
//   SBO, between neighbours along M or N.
// For a K-major operand (K contiguous in a row: q and k against the head
// dim), element (row r, k) of a tile lies at
//   (r / 8) * SBO + (k / 8) * LBO + (r % 8) * 16 + (k % 8) * 2   bytes;
// for an MN-major operand (N contiguous: v, whose rows are the contracted
// keys), element (key, n) lies at
//   (n / 8) * SBO + (key / 8) * LBO + (key % 8) * 16 + (n % 8) * 2.
// One k16 step of either is two core matrices along K, LBO * 2 bytes on.
//
// Accumulators and register A operands use the mma.sync m16n8 fragment
// layout per warp: warp w of the warpgroup holds rows 16w + lane/4 and
// 16w + lane/4 + 8; for each 8-column block j, d[4j], d[4j+1] are columns
// 8j + 2(lane%4) + {0, 1} of the first row and d[4j+2], d[4j+3] of the
// second. So an fp32 accumulator of 16 columns re-packs in registers, as
// bf16, into the A operand of the next product (flash_common.cuh pack_a).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// No-swizzle shared-memory matrix descriptor (layout type 0, base offset 0).
__device__ __forceinline__ uint64_t make_desc(const void* smem, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  return static_cast<uint64_t>((smem_u32(smem) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo_bytes & 0x3FFFF) >> 4) << 32);
}

// The same for a 128-byte-swizzled tile (layout type 1): rows of 128 bytes
// whose 16-byte chunks are XOR-ed with the row's index within each 8-row,
// 1024-byte atom, as the TMA unit writes them with CU_TENSOR_MAP_SWIZZLE_128B
// (gn_act_proj.cu). The atoms must start on 1024-byte boundaries; a k16 step
// inside a K-major atom moves the start address by 32 bytes.
__device__ __forceinline__ uint64_t make_desc_sw128(const void* smem, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  return make_desc(smem, lbo_bytes, sbo_bytes) | (1ull << 62);
}

// A descriptor moved on by `bytes` (a multiple of 16) in shared memory.
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) { return desc + (bytes >> 4); }

// Orders this thread's earlier generic-proxy shared-memory writes (plain
// stores, cp.async once waited for) before later async-proxy reads (wgmma).
// Each writing thread runs it before the barrier that publishes the tile.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers in place around an asynchronous wgmma: the compiler may not
// move a read or write of them across this point (the wgmma's outputs exist
// only after wgmma_wait, its register inputs must hold until then).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// mbarriers and TMA. A full barrier of a stage counts one arrival (the
// thread that issues the stage's copies, with the bytes it expects) and
// completes when those bytes have landed; waits go by phase parity.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_mbar_init() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// One arrival on `bar` (release at block scope: this thread's earlier
// accesses happen before a waiter's later ones).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}
// A 5-D tile copy from device memory into shared memory by the TMA unit,
// reported to `bar` (complete_tx). Coordinates innermost first.
__device__ __forceinline__ void tma_load_5d(void* dst, const void* map, uint64_t* bar, int c0, int c1, int c2, int c3,
                                            int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6, "
      "%7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// 4-D, 3-D and 2-D tile copies, as tma_load_5d.
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map, uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const void* map, uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A 1-D tile copy (a row of fp32 values) from device memory into shared
// memory by the TMA unit, reported to `bar` (complete_tx).
__device__ __forceinline__ void tma_load_1d(void* dst, const void* map, uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%3}], [%2];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

// The operand lists below are spelled out: wgmma names every accumulator
// register of the warpgroup's thread.
// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A K-major in shared memory, B
// K-major (TB = 0) or MN-major (TB = 1: the keys of a sequence-contiguous k).
template <int TB = 0>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TB));
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 48] (+)= A[64 x 16] . B[16 x 48], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n48k16_ss(float (&d)[24], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23},"
      " %24, %25, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 32] (+)= A[64 x 16] . B[16 x 32], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// S[64 x N] (+)= A[64 x 16] . B[16 x N] for the tile widths the kernels take.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b, int scale_d);
template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  wgmma_m64n32k16_ss(d, desc_a, desc_b, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_ss<48>(float (&d)[24], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  wgmma_m64n48k16_ss(d, desc_a, desc_b, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  wgmma_m64n64k16_ss(d, desc_a, desc_b, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  wgmma_m64n128k16_ss(d, desc_a, desc_b, scale_d);
}

// D[64 x 40] += A[64 x 16] . B[16 x 40], A in registers, B in shared memory
// MN-major (TB = 1) or K-major (TB = 0).
template <int TB>
__device__ __forceinline__ void wgmma_m64n40k16_rs(float (&d)[20], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19},"
      " {%20, %21, %22, %23}, %24, p, 1, 1, %26;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TB));
}

// D[64 x 80] += A[64 x 16] . B[16 x 80], A in registers, B in shared memory
// MN-major (TB = 1) or K-major (TB = 0).
template <int TB>
__device__ __forceinline__ void wgmma_m64n80k16_rs(float (&d)[40], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39},"
      " {%40, %41, %42, %43}, %44, p, 1, 1, %46;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TB));
}

// D[64 x 160] += A[64 x 16] . B[16 x 160], A in registers, B in shared memory
// MN-major (TB = 1) or K-major (TB = 0).
template <int TB>
__device__ __forceinline__ void wgmma_m64n160k16_rs(float (&d)[80], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79},"
      " {%80, %81, %82, %83}, %84, p, 1, 1, %86;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TB));
}

// O[64 x D] += P[64 x 16] . V[16 x D] for the head dims the kernels take,
// V MN-major (TB = 1, a head-dim-contiguous v) or K-major (TB = 0, a
// sequence-contiguous v).
template <int D, int TB = 1>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t desc_b) {
  static_assert(D == 40 || D == 80 || D == 160, "head dims 40, 80 and 160");
  if constexpr (D == 40)
    wgmma_m64n40k16_rs<TB>(d, a, desc_b);
  else if constexpr (D == 80)
    wgmma_m64n80k16_rs<TB>(d, a, desc_b);
  else
    wgmma_m64n160k16_rs<TB>(d, a, desc_b);
}

// Host side: the tensor-map encoder, the 5-D tile map of a [B, H, L, D]
// view, and the kernels' attributes.

// cuTensorMapEncodeTiled from the driver, through the runtime: the library
// links no -lcuda.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// The 5-D map (8 elements, L, D/8 chunks, H, B) of a [B, H, L, D] view with
// element strides (sb, sh, sl), cut in boxes of (8, rows, D/8, 1, 1); rows
// past L read as zeros.
template <int D>
cudaError_t bhld_map(CUtensorMap* map, const void* base, int B, int H, int L, long long sb, long long sh,
                     long long sl, int rows) {
  const auto encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[5] = {8, (cuuint64_t)L, D / 8, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[4] = {(cuuint64_t)sl * 2, 16, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[5] = {8, (cuuint32_t)rows, D / 8, 1, 1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The 5-D map (8 elements, D, ceil(L/8) chunks, H, B) of a channel-major
// [B, H, L, D] view: L contiguous, element strides sb, sh and sd (each a
// multiple of 8), cut in boxes of (8, drows, rows/8, 1, 1), so a tile lands
// as [rows/8][drows][8 keys] of 16-byte cells. Rows past D (drows > D: the
// pad of the k16 steps) and chunks past the last read as zeros; the caller
// makes the last chunk's elements past L readable (L a multiple of 8, or a
// padded buffer), and masks them.
template <int D>
cudaError_t bdl_map(CUtensorMap* map, const void* base, int B, int H, int L, long long sb, long long sh,
                    long long sd, int rows, int drows) {
  const auto encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[5] = {8, D, (cuuint64_t)(L + 7) / 8, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[4] = {(cuuint64_t)sd * 2, 16, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[5] = {8, (cuuint32_t)drows, (cuuint32_t)rows / 8, 1, 1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The 1-D map of n contiguous fp32 values, cut in boxes of `rows`: the
// per-q-row lse or delta of all heads end to end (a 2-D map would need the
// row length to be a multiple of 4). A box must start on a 16-byte
// boundary, a multiple of 4 rows: the caller rounds the start down and
// reads past the rows it rounded over.
inline cudaError_t flat_map(CUtensorMap* map, const float* base, long long n, int rows) {
  const auto encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {4};  // not read for one dimension
  const cuuint32_t box[1] = {(cuuint32_t)rows};
  const cuuint32_t elem[1] = {1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(base), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

constexpr int MAX_DEVICES = 64;

// Raise a kernel's dynamic shared-memory limit once per card.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem, bool (&ready)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace hopper
