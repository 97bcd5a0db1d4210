// The flash backward shared by flash_bwd_dq.cu (K5, q-outer) and
// flash_bwd_dkv.cu (K6, k-outer). Written for Hopper (sm_90a): warpgroup
// wgmma for every product, fed by TMA.
//
// Arithmetic, matching the TPU kernels step by step (flash_attention.py
// :583-606 for K5, :620-650 for K6):
//   qs    = bf16(q * bf16(scale*log2e))   formed once a backward by the
//                                          wrapper, as _bwd_pallas does (:673)
//   lse2  = lse * log2e                   (per q row, fp32)
//   s     = qs . k^T in fp32;  p = exp2(s - lse2)   (no max: lse normalises)
//   dp    = dO . v^T in fp32
//   ds    = bf16(p * (dp - delta))        (delta = sum(dO * o) per q row)
//   dq    = bf16((ds . k) * scale)                              (K5)
//   dv    = bf16(bf16(p)^T . dO),  dk = bf16((ds^T . qs) * ln2)  (K6; ln2
//                                          undoes the log2e in qs)
// Keys past Lk and q rows past Lq get p = 0.
//
// What bounds them on an H100 SXM: at B4 H8 L4096 D40, K5 is 1.3e11 tensor
// FLOP (6 L^2 D a head) and K6 1.7e11 (8 L^2 D), 0.130 and 0.174 ms at 989
// TFLOP/s; each of their 5.4e8 logits takes an exp2 on the special-function
// units (~0.13 ms at 16 a clock per SM, 132 SMs, 1.98 GHz) and two
// subtractions, a multiplication and two bf16 roundings on the fp32 pipes;
// their operands are 64 and 63 MB (K5 also reads o and writes delta), ~0.02
// ms at 3.35 TB/s. As in the forward, the per-logit work sets the pace at
// D=40 and the products at D=160.
//
// Shared design:
//   * one block of two warpgroups (256 threads); each warpgroup owns 64 rows
//     of the outer operand (keys in K6, q rows in K5), which stay in shared
//     memory for the whole loop, and runs every product of its rows on
//     wgmma: the two logit-shaped products with both operands in shared
//     memory, the accumulating product with the bf16 p^T, ds^T or ds
//     re-packed in registers as its A operand (hopper.cuh's fragment layout);
//   * every tile comes from a 5-D tensor map (8 elements, L, D/8, H, B) of
//     the strided [B, H, L, D] view, which cuts it as [16-byte chunk][row]
//     cells: with LBO = rows * 16 and SBO = 128 that is the K-major layout of
//     an operand whose rows lie along M or N (contracted over the head dim),
//     and with LBO = 128 and SBO = rows * 16 the MN-major layout of a B whose
//     rows are contracted. Each tile contracted over the head dim is padded
//     with zero chunks to a multiple of 16 (40 -> 48), written once;
//   * the inner operand streams through a ring of stages that the TMA unit
//     fills; the last of the block's 8 warps to finish a stage refills it,
//     so the warpgroups wait only for data and meet at no barrier in the
//     loop (the forward's scheme, flash_fwd_online.cuh);
//   * no producer warpgroup and no setmaxnreg: at D=40 two blocks share an
//     SM at 128 registers a thread.
// Layout: qs, k, v, dO and the outputs are [B, H, L, D] with arbitrary
// 16-byte-aligned element strides for B, H and L (head dim contiguous); lse
// and delta are contiguous [B, H, Lq] fp32.
#pragma once

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int NUM_THREADS = 256;  // two warpgroups
constexpr int WARPS = NUM_THREADS / 32;

template <int D>
struct BwdDims {
  static constexpr int DP = (D + 15) / 16 * 16;  // head dim padded to the k16 step
  static constexpr int CH = D / 8;               // 16-byte chunks of a row in device memory
  static constexpr int DPC = DP / 8;             // ... of a padded row in shared memory
  static constexpr int QK = DP / 16;             // k16 steps of a product over the head dim
};

// Descriptors of a [chunk][rows] tile: as a K-major operand whose rows lie
// along M or N, and as an MN-major B whose rows are the contracted dim.
__device__ __forceinline__ uint64_t desc_rows(const void* tile, int rows) {
  return make_desc(tile, rows * 16, 128);
}
__device__ __forceinline__ uint64_t desc_cols(const void* tile, int rows) {
  return make_desc(tile, 128, rows * 16);
}

// Zero the pad chunks [CH, DPC) of `count` [chunk][rows] tiles, `stride`
// bytes apart; the TMA unit writes only chunks [0, CH).
template <int D>
__device__ __forceinline__ void zero_pad_chunks(unsigned char* tile, int rows, int count, int stride, int tid) {
  using Dm = BwdDims<D>;
  if constexpr (Dm::DPC > Dm::CH) {
    const int pad = (Dm::DPC - Dm::CH) * rows;  // 16-byte cells a tile
    for (int i = tid; i < count * pad; i += NUM_THREADS)
      *reinterpret_cast<uint4*>(tile + (i / pad) * stride + Dm::CH * rows * 16 + (i % pad) * 16) =
          make_uint4(0, 0, 0, 0);
  }
}

// Called by lane 0 of each warp once the warp is done reading a stage: the
// last of the block's warps resets the stage's count and returns true, and
// then has the TMA unit refill the stage.
__device__ __forceinline__ bool last_warp_done(int* done) {
  __threadfence_block();
  if (atomicAdd(done, 1) == WARPS - 1) {
    *done = 0;
    __threadfence_block();
    return true;
  }
  return false;
}

// acc + the dot product of 8 bf16 values with 8 others, in fp32.
__device__ __forceinline__ float dot8_bf16(const uint4& x, const uint4& y, float acc) {
  const uint32_t* a = reinterpret_cast<const uint32_t*>(&x);
  const uint32_t* b = reinterpret_cast<const uint32_t*>(&y);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 u = unpack_bf16x2(a[e]), w = unpack_bf16x2(b[e]);
    acc = fmaf(u.x, w.x, acc);
    acc = fmaf(u.y, w.y, acc);
  }
  return acc;
}

// Rows r_lo and r_lo + 8 (those below L) of a warpgroup's 64 x D fp32
// accumulator, times `mul`, stored as bf16.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], __nv_bfloat16* base, long long sl, int r_lo,
                                           int L, int tig, float mul) {
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + tig * 2;
    if (r_lo < L)
      *reinterpret_cast<uint32_t*>(base + (long long)r_lo * sl + col) =
          pack_bf16x2(acc[dt * 4] * mul, acc[dt * 4 + 1] * mul);
    if (r_hi < L)
      *reinterpret_cast<uint32_t*>(base + (long long)r_hi * sl + col) =
          pack_bf16x2(acc[dt * 4 + 2] * mul, acc[dt * 4 + 3] * mul);
  }
}

}  // namespace
