// flash_f32.cuh: what the float32 attention kernels share
// (flash_fwd_f32.cu, flash_bwd_dq_f32.cu, flash_bwd_dkv_f32.cu). Float32
// throughout: fp32 FMA only, no TF32, no bf16, no tensor-core instruction.
//
// The three kernels are one design. Each warp owns 4 RI rows (q rows in the
// forward and in flash_bwd_dq_f32, keys in flash_bwd_dkv_f32; RI = 4, or 8
// in the backward kernels at D = 40) from its first product to its stores,
// and nothing but the copy rings is shared between a block's warps, so no
// instruction waits for the whole block:
//   * a logit tile (S = A . B^T over the head dim) gives a lane = 8 rg + cg
//     an RI x T register tile: rows rg + 4i of the warp's, columns cg + 8t
//     of the 8T-column tile (logit_tile). Both operands lie chunk-major in
//     shared memory, [D/4][rows][4], so a 16-byte read feeds 4 FMA and a
//     warp's reads cover 64 and 128 contiguous bytes;
//   * an accumulating product (O += P . M over the tile's columns) takes P
//     from a per-warp slab [4 RI][8T] (written by the lanes that hold it,
//     16 bytes read at a time; only __syncwarp) and gives a lane RI rows x
//     D/8 columns of O: 16-byte groups 32g + 4cg .. + 3, and at D = 40 and
//     80 single columns 32J + cg or pairs 32J + 2cg (Cols): no padded column;
//   * tiles come by TMA into rings of stages, each with a full mbarrier
//     that the TMA unit completes; the last warp done with a stage has the
//     TMA unit refill it, so a warp waits for data only.
// The backward kernels read M chunk-major too: their M tiles are boxes of
// 8T + 1 rows, whose chunk stride of 4 (8T + 1) floats puts the 8 lanes of a
// row group, reading 8 chunks of one row, on 8 different bank groups. So
// one copy of an operand serves both of its products (K in dq: in s over
// the head dim, in ds . K over keys). No result is summed through an
// atomic: a call repeats bit for bit.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "hopper.cuh"

namespace f32attn {

using namespace hopper;

constexpr int TILE = 64;           // keys a tile of the forward (F32_BLOCK_K: the online mode's max is per tile)
constexpr float NEG_INF = -1e30f;  // the TPU kernels' mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float exp2_ftz(float x) {
  const float y = exp2f(x);
  return y < FLT_MIN ? 0.f : y;  // subnormal results flush to zero, as on the TPU
}

__device__ __forceinline__ float lane_of(const float4& v, int e) { return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w; }

// A ring stage's release in the backward kernels, their one atomic
// operation: this warp is done reading the stage; the last of the block's
// `active` warps to get here (a count in shared memory, `done`) resets the
// count and, where `refill`, has the TMA unit refill the stage (`fetch`).
// The count only decides which warp issues a copy and touches no result, so
// a call still repeats bit for bit. (A warp that waits on an mbarrier for
// the others before it issues the copy ran them 1.4-1.8x slower on an H100:
// it and the warps waiting for its copy fall behind. The forward keeps the
// same logic inline: calling this moved its register allocation and cost
// it 1-5%.)
template <typename Fetch>
__device__ __forceinline__ void release_stage(int* done, int active, bool refill, Fetch fetch) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) {
    __threadfence_block();
    if (atomicAdd(done, 1) == active - 1) {
      *done = 0;
      __threadfence_block();
      if (refill) {
        fence_proxy_async();  // the warps' reads of the stage come before the TMA unit's writes
        fetch();
      }
    }
  }
}

// floats rounded up to a whole number of 128 bytes (a TMA destination's alignment)
constexpr int align32(int floats) { return (floats + 31) / 32 * 32; }

// The D/8 columns of a D-wide row that a lane of a row group holds (cg =
// lane % 8): 16-byte groups 32g + 4cg .. + 3 for g < J, then R single
// columns: 32J + cg (R = 1, D = 40) or 32J + 2cg, + 1 (R = 2, D = 80).
template <int D>
struct Cols {
  static_assert(D % 8 == 0 && D <= 256, "a lane holds D/8 columns; a TMA box row holds at most 256");
  static constexpr int J = D / 32;
  static constexpr int R = D % 32 / 8;
  static constexpr int N = 4 * J + R;
  static_assert(N * 8 == D, "no padded column");
};

// s[i][t] = sum_d A[rg + 4i][d] B[cg + 8t][d] for i < RI; `a` points at
// the lane's first row (A4 + row base + rg) of a chunk-major A with `as`
// rows, `b` at B4 + cg of a chunk-major B with `bs` rows
template <int D, int RI, int T>
__device__ __forceinline__ void logit_tile(float (&s)[RI][T], const float4* a, int as, const float4* b, int bs) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int t = 0; t < T; ++t) s[i][t] = 0.f;
#pragma unroll 2
  for (int c4 = 0; c4 < D / 4; ++c4) {
    float4 av[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) av[i] = a[c4 * as + 4 * i];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float4 bv = b[c4 * bs + 8 * t];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        s[i][t] = fmaf(av[i].x, bv.x, s[i][t]);
        s[i][t] = fmaf(av[i].y, bv.y, s[i][t]);
        s[i][t] = fmaf(av[i].z, bv.z, s[i][t]);
        s[i][t] = fmaf(av[i].w, bv.w, s[i][t]);
      }
    }
  }
}

// The lane's columns (Cols) of row r of a chunk-major tile whose chunks lie
// cs floats apart.
template <int D>
__device__ __forceinline__ void chunk_row(float (&v)[Cols<D>::N], const float* tile, int cs, int r, int cg) {
  constexpr int J = Cols<D>::J, R = Cols<D>::R;
#pragma unroll
  for (int g = 0; g < J; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(tile + (8 * g + cg) * cs + 4 * r);
    v[4 * g] = x.x;
    v[4 * g + 1] = x.y;
    v[4 * g + 2] = x.z;
    v[4 * g + 3] = x.w;
  }
  if constexpr (R == 1) {
    v[4 * J] = tile[(8 * J + cg / 4) * cs + 4 * r + cg % 4];
  } else if constexpr (R == 2) {
    const float2 x = *reinterpret_cast<const float2*>(tile + (8 * J + cg / 2) * cs + 4 * r + 2 * (cg % 2));
    v[4 * J] = x.x;
    v[4 * J + 1] = x.y;
  }
}

// acc[i][c] += sum_k P[rg + 4i][k] M[k][column c] (i < RI) over the tile's
// K rows of M, in order: P is the warp's slab [4 RI][K] (row r's 16-byte
// groups XOR-ed with swz = 8 (r % 4)), M chunk-major with chunks cs floats
// apart.
template <int D, int RI, int K>
__device__ __forceinline__ void slab_product(float (&acc)[RI][Cols<D>::N], const float* slab, int swz, const float* m,
                                             int cs, int rg, int cg) {
  constexpr int N = Cols<D>::N;
#pragma unroll 2
  for (int kk = 0; kk < K; kk += 4) {
    float4 pr[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) pr[i] = *reinterpret_cast<const float4*>(slab + (rg + 4 * i) * K + (kk ^ swz));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float mv[N];
      chunk_row<D>(mv, m, cs, kk + e, cg);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float pe = lane_of(pr[i], e);
#pragma unroll
        for (int c = 0; c < N; ++c) acc[i][c] = fmaf(pe, mv[c], acc[i][c]);
      }
    }
  }
}

// A lane's columns (Cols) of one row of O, times mul, into a row-major row.
template <int D>
__device__ __forceinline__ void store_cols(float* row, const float (&a)[Cols<D>::N], float mul, int cg) {
  constexpr int J = Cols<D>::J, R = Cols<D>::R;
#pragma unroll
  for (int g = 0; g < J; ++g)
    *reinterpret_cast<float4*>(row + 32 * g + 4 * cg) =
        make_float4(a[4 * g] * mul, a[4 * g + 1] * mul, a[4 * g + 2] * mul, a[4 * g + 3] * mul);
  if constexpr (R == 1) {
    row[32 * J + cg] = a[4 * J] * mul;
  } else if constexpr (R == 2) {
    *reinterpret_cast<float2*>(row + 32 * J + 2 * cg) = make_float2(a[4 * J] * mul, a[4 * J + 1] * mul);
  }
}

// A block's (tile, batch * H + head) when every head's whole tiles come
// first and the ragged last tiles after them, so the cheap blocks fill the
// last wave: `whole` tiles of each of `bhs` heads, then one ragged tile
// each (none when the length is a whole number of tiles).
__device__ __forceinline__ void block_tile(int bid, int whole, int bhs, int& tile, int& bh) {
  tile = bid < whole * bhs ? bid % whole : whole;
  bh = bid < whole * bhs ? bid / whole : bid - whole * bhs;
}

struct Strides {
  long long s[18];  // element strides (batch, head, row) of up to six [B, H, L, D] operands
};

// Host side.

inline cudaError_t encode_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box) {
  const auto encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(base), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The TMA maps of a strided [B, H, L, D] float32 view (element strides sb,
// sh, sl; the head dim contiguous) cut in tiles of `rows` rows; rows past L
// read as zeros. chunk_map is 5-D, (4 elements, L, D/4 chunks, H, B), so a
// tile lands chunk-major [D/4][rows][4]; row_map 4-D, (D, L, H, B), a
// row-major [rows][D].
inline cudaError_t chunk_map(CUtensorMap* map, const void* base, int B, int H, int L, int D, long long sb,
                             long long sh, long long sl, int rows) {
  const cuuint64_t dims[5] = {4, (cuuint64_t)L, (cuuint64_t)(D / 4), (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[4] = {(cuuint64_t)sl * 4, 16, (cuuint64_t)sh * 4, (cuuint64_t)sb * 4};
  const cuuint32_t box[5] = {4, (cuuint32_t)rows, (cuuint32_t)(D / 4), 1, 1};
  return encode_map(map, base, 5, dims, strides, box);
}

inline cudaError_t row_map(CUtensorMap* map, const void* base, int B, int H, int L, int D, long long sb, long long sh,
                           long long sl, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sl * 4, (cuuint64_t)sh * 4, (cuuint64_t)sb * 4};
  const cuuint32_t box[4] = {(cuuint32_t)D, (cuuint32_t)rows, 1, 1};
  return encode_map(map, base, 4, dims, strides, box);
}

inline int sm_count() {
  static int counts[MAX_DEVICES];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES) return 132;
  if (!counts[dev] && cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    counts[dev] = 132;
  return counts[dev];
}

// Warps a block: max_warps, or half as many where max_warps would leave
// the card a second wave of blocks less than half full (`blocks` at
// max_warps a block, `slots` blocks the card runs at once). A warp's work
// is its 16 rows whatever the block.
inline int wave_warps(long long blocks, int slots, int max_warps) {
  return blocks > slots && 2 * blocks <= 3LL * slots ? max_warps / 2 : max_warps;
}

// Warps a block of the backward kernels, whose warps own `rows` rows each
// of a length-L axis of each of bhs heads: wave_warps's choice, then
// halved while the blocks of half as many warps would still run in one
// wave, so that a short grid spreads over more SMs.
inline int block_warps(long long bhs, int L, int rows, int slots, int max_warps) {
  auto blocks = [&](int w) { return bhs * ((L + rows * w - 1) / (rows * w)); };
  int w = wave_warps(blocks(max_warps), slots, max_warps);
  while (w > 2 && blocks(w / 2) <= slots) w /= 2;
  return w;
}

}  // namespace f32attn
