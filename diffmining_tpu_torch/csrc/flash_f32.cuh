// flash_f32.cuh: what the float32 attention kernels share
// (flash_fwd_f32.cu, flash_bwd_dq_f32.cu, flash_bwd_dkv_f32.cu). Float32
// throughout: fp32 FMA only, no TF32, no bf16, no tensor-core instruction.
// The forward takes the constants (TILE, its 64-key tile), exp2_ftz and
// Strides from here and has register tiles of its own; the tile helpers
// below are the backward kernels'.
//
// The backward kernels work on 64-row tiles with 256 threads as a 16 x 16
// grid (ty = tid / 16, tx = tid % 16):
//   * a "row product" S = A . B^T of two [64 x D] tiles gives each thread a
//     4 x 4 block of S: rows 4ty + i of A against rows tx + 16j of B;
//   * a "tile product" acc += P . M of a [64 x 64] tile P (rows 4ty + i)
//     and a [64 x D] tile M gives each thread rows 4ty + i and the head-dim
//     columns DPT tx + j.
// The 16 threads of a half-warp share their rows, so a reduction over a
// row's 64 columns of S is four shuffles.
//
// Head dims that are no multiple of 16 (SD-v1.5's 40) are padded to the
// next multiple in shared memory only: the tile product reads DP = 48
// columns of M, whose columns past D are zeros written once before the
// loop (the cp.async copies never touch them), so the columns a thread
// holds past D sum exact zeros and are never stored. The row products read
// the D columns alone. Every tile has a row stride of DP + 4 floats, which
// keeps the 16-byte reads of the row products free of bank conflicts.
//
// Tiles stream in with cp.async (16 bytes a copy, rows past the matrix's
// end zero-filled by a source size of 0), so the next tile's copy runs
// beside the current tile's products without holding registers.
#pragma once

#include <cuda_runtime.h>
#include <float.h>

namespace f32attn {

constexpr int TILE = 64;           // rows of every tile: q rows or keys
constexpr int THREADS = 256;       // 16 x 16
constexpr int SP = TILE + 4;       // row stride of a [64 x 64] tile (p, ds)
constexpr float NEG_INF = -1e30f;  // the TPU kernels' mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Dims {
  static_assert(D % 4 == 0, "rows are copied 16 bytes at a time");
  static constexpr int DP = (D + 15) / 16 * 16;  // the padded head dim (48 at D=40)
  static constexpr int S = DP + 4;               // row stride of a [64 x D] tile
  static constexpr int V4 = D / 4;               // 16-byte chunks of a row
  static constexpr int DPT = DP / 16;            // head-dim columns a thread holds
  static constexpr int TILE_FLOATS = TILE * S;
};

__device__ __forceinline__ float exp2_ftz(float x) {
  const float y = exp2f(x);
  return y < FLT_MIN ? 0.f : y;  // subnormal results flush to zero, as on the TPU
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async rows r0 .. r0 + 63 of a [n x D] matrix (row stride rs floats, the
// head dim contiguous) into a tile; rows at n and past it are zeros. The
// caller commits the group.
template <int D>
__device__ __forceinline__ void load_tile(float* tile, const float* base, long long rs, int r0, int n) {
  using Dm = Dims<D>;
  for (int f = threadIdx.x; f < TILE * Dm::V4; f += THREADS) {
    const int r = f / Dm::V4, c = f % Dm::V4;
    const bool in = r0 + r < n;
    cp_async16(tile + r * Dm::S + 4 * c, in ? base + (r0 + r) * rs + 4 * c : base, in);
  }
}

// zeros in the padded columns D .. DP - 1 of a tile (none where D % 16 == 0)
template <int D>
__device__ __forceinline__ void zero_pad(float* tile) {
  using Dm = Dims<D>;
  if constexpr (Dm::DP > D) {
    constexpr int W = Dm::DP - D;
    for (int f = threadIdx.x; f < TILE * W; f += THREADS) tile[(f / W) * Dm::S + D + f % W] = 0.f;
  }
}

// s[i][j] = sum_d a[4ty + i][d] * b[tx + 16j][d] over the D columns
template <int D>
__device__ __forceinline__ void row_product(float (&s)[4][4], const float* a, const float* b, int ty, int tx) {
  using Dm = Dims<D>;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < Dm::V4; ++c) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a + (4 * ty + i) * Dm::S + 4 * c);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * Dm::S + 4 * c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
  }
}

// the DPT columns DPT tx .. of one row of a [64 x D] tile
template <int D>
__device__ __forceinline__ void row_slice(float (&out)[Dims<D>::DPT], const float* row) {
  constexpr int DPT = Dims<D>::DPT;
  if constexpr (DPT % 4 == 0) {
#pragma unroll
    for (int j = 0; j < DPT; j += 4) {
      const float4 x = *reinterpret_cast<const float4*>(row + j);
      out[j] = x.x;
      out[j + 1] = x.y;
      out[j + 2] = x.z;
      out[j + 3] = x.w;
    }
  } else if constexpr (DPT % 2 == 0) {
#pragma unroll
    for (int j = 0; j < DPT; j += 2) {
      const float2 x = *reinterpret_cast<const float2*>(row + j);
      out[j] = x.x;
      out[j + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < DPT; ++j) out[j] = row[j];
  }
}

// acc[i][j] += sum_k p[4ty + i][k] * m[k][DPT tx + j] over the 64 rows of m
template <int D>
__device__ __forceinline__ void tile_product(float (&acc)[4][Dims<D>::DPT], const float* p, const float* m, int ty,
                                             int tx) {
  using Dm = Dims<D>;
  constexpr int DPT = Dm::DPT;
#pragma unroll 2
  for (int c4 = 0; c4 < TILE / 4; ++c4) {
    float4 pa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[i] = *reinterpret_cast<const float4*>(p + (4 * ty + i) * SP + 4 * c4);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float mv[DPT];
      row_slice<D>(mv, m + (4 * c4 + cc) * Dm::S + DPT * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = cc == 0 ? pa[i].x : cc == 1 ? pa[i].y : cc == 2 ? pa[i].z : pa[i].w;
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pv, mv[j], acc[i][j]);
      }
    }
  }
}

// rows 4ty + i of acc, times mul, into rows r0 + 4ty + i (those below n) of
// a [n x D] matrix (row stride rs); the padded columns are not stored
template <int D>
__device__ __forceinline__ void store_rows(float* base, long long rs, int r0, int n, const float (&acc)[4][Dims<D>::DPT],
                                           const float (&mul)[4], int ty, int tx) {
  constexpr int DPT = Dims<D>::DPT;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r >= n) continue;
    float* row = base + r * rs + DPT * tx;
    if constexpr (DPT % 4 == 0) {
#pragma unroll
      for (int j = 0; j < DPT; j += 4)
        *reinterpret_cast<float4*>(row + j) =
            make_float4(acc[i][j] * mul[i], acc[i][j + 1] * mul[i], acc[i][j + 2] * mul[i], acc[i][j + 3] * mul[i]);
    } else {
#pragma unroll
      for (int j = 0; j < DPT; ++j)
        if (DPT * tx + j < D) row[j] = acc[i][j] * mul[i];
    }
  }
}

// the sum over the 16 threads of a half-warp (the threads that share rows)
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Strides {
  long long s[18];  // element strides (batch, head, row) of up to six [B, H, L, D] operands
};

}  // namespace f32attn
