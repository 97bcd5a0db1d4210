// gn_act_proj: GroupNorm, an optional SiLU and the 1x1 projection in one
// call, for the entry of every SpatialTransformer of the UNet without grad
// (DIFFMINING_FUSED_NORM=1). Written for Hopper (sm_90a). One C entry point
// launches two kernels on the caller's stream:
//   gn_stats_kernel      the per-(batch, group) mean and rsigma, fp32, per
//                        channel into a [B, 2, C] buffer;
//   gn_act_proj_kernel   the normalise (and SiLU) and the projection.
//
// Replaces diffmining_tpu/ops/fused_norm.py:27 _gn_act_matmul_kernel (via
// gn_act_proj, :44), and the XLA reduce that computes its statistics there
// (:68-77).
//
// Arithmetic, matching the TPU kernel and the plain version
// (ops/fused_norm.py gn_act_proj_plain) step by step:
//   mean, var over each (batch, group) in fp32, var the mean of squared
//                     deviations (merged centred, never E[x^2] - E[x]^2);
//                     rsig = 1 / sqrt(var + eps)
//   h   = ((x - mean) * rsig) * gamma + beta     fp32, each step rounded
//                                                (no FMA contraction, as the
//                                                plain version's torch ops)
//   h   = h * sigmoid(h)                         only with act="silu"
//   hb  = bf16(h)                                (cast to w's dtype)
//   out = bf16(hb . w) accumulated in fp32; then bf16(out + bias), the bias
//         added in the output dtype as the TPU kernel's caller does (:103)
//
// What bounds it on an H100 SXM: at B8 N4096 C320 Cout320 (the 512px level-0
// entry) x and out are 21 MB each and w 0.2 MB: 12.6 us at 3.35 TB/s,
// against 6.7 GFLOP on the tensor cores, 6.8 us at 989 TFLOP/s; the
// normalise is 4-5 fp32 operations per x element. Memory bounds it at
// N4096 and N64, the tensor cores at N1024 and N256 (C 640, 1280). The
// statistics read x once; the card's 50 MB L2 holds x (21 MB at the
// largest level) when the projection reads it again right after.
//
// The statistics (gn_stats_kernel): one block of 512 threads per (group,
// batch). A group's elements, in memory order (channel by channel for NCHW
// x, where a group is one run of C/G * N elements; pixel by pixel for
// channels-last x, where it is C/G channels a pixel, C apart), are cut in
// runs of 8. Thread t loads runs t, t + 512, t + 1024 and t + 1536 at once
// (16-byte loads where a run lies aligned in one row, bf16 pairs where rows
// and strides are even, as at C320 in 32 groups, 10 channels a group, else
// elements; every load of the four issued before any is used), takes their
// count, mean and sum of squared deviations from that mean, and merges them
// into its partial by Chan's centred merge; then the next four, 2048 runs
// on. A shuffle-down tree within each warp and one
// across the 16 warps end it. ops/fused_norm.py group_stats_plain repeats
// this order.
//
// The projection (gn_act_proj_kernel): one block per (pixel tile, split of
// Cout, image), two consumer warpgroups and one producer warp, which issues
// every TMA copy and waits on an empty barrier per stage before it refills
// one (a consumer warp never stalls on issuing a copy):
//   * x comes into shared memory by TMA in 64-channel K chunks of 128-byte
//     rows, 128-byte swizzled, wgmma's canonical layouts: K-major A
//     ([pixel][64 channels]) for channels-last x, MN-major A ([channel][64
//     pixels]) for NCHW x, which bf16 wgmma reads transposed, so no
//     transpose pass runs. Where a stride is not 16-byte aligned (N = 4095
//     gives an NCHW channel stride of 8,190 bytes) the consumers load the
//     same cells with element loads instead;
//   * the consumers normalise each chunk in place to bf16 h (the
//     per-channel mean, rsig, gamma and beta staged as float4 in shared
//     memory, read so that a warp's loads do not collide), fence it for
//     the async proxy and sync; chunk k + 1 is normalised while the
//     products on chunk k run;
//   * where a [128 pixels x C] slab fits beside a ring of w stages (C=320,
//     640: the slab mode), the block normalises the slab once, chunk by
//     chunk under its first Cout tile's products, and keeps h for its other
//     tiles; at C=1280 (the ring mode) x chunks stream through the ring
//     beside w and each block covers one Cout tile, so each x element is
//     still normalised once a block;
//   * w [Cout, C] (K-major B) streams through the ring as [tile rows x 64
//     channels] stages; the products are wgmma with fp32 accumulators over
//     tiles of 160 output channels: at 128 pixels each warpgroup takes 64
//     rows of the tile (m64n160k16), at 64 pixels half of its columns
//     (m64n80k16). Each block starts its K loop at its own chunk (its
//     linear index modulo C / 64), so the blocks in flight do not all read
//     one w chunk from L2 at once;
//   * the epilogue rounds to bf16, adds the bias in bf16, transposes each
//     group of four 8-column blocks in the quad that holds its rows, and
//     stores 16 bytes a thread into [B, N, Cout] contiguous;
//   * the host (ops/fused_norm.py plan) picks the mode, the block's pixels,
//     the ring depth from the shared memory left and the Cout split that
//     fills the card: one block covers all of Cout at N4096.
// Layout: x is [B, N, C] with element strides x_sb, x_sn, x_sc, of which
// x_sn or x_sc is 1; stats [B, 2, C] fp32 (written here); gamma, beta [C]
// bf16 or fp32; w [Cout, C] and bias [Cout] bf16 contiguous; out [B, N,
// Cout] bf16 contiguous. C must be a multiple of 64 and Cout of 160.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <string.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int STATS_THREADS = 512;
constexpr int STATS_UNROLL = 4;  // runs a thread loads at once and merges as one
constexpr int K_TILE = 64;       // input channels a w stage: one 128-byte row
constexpr int TILE_N = 160;      // output channels a tile (SD's widths 320, 640, 1280 are multiples)
constexpr int SMEM_LIMIT = 232448;
constexpr int MAX_CHUNKS = 32;  // K chunks of a slab, one barrier each
constexpr int THREADS = 256;   // two consumer warpgroups (products and normalise); one more warp issues the copies
constexpr int SILU = 1, GB_F32 = 2, USE_TMA = 4;  // flags of the projection
enum RunLoad { ELEMENTS = 0, VEC16 = 1, PAIRS = 2 };

// ---------------------------------------------------------------------------
// statistics
// ---------------------------------------------------------------------------

// Chan's merge of (nb, mb, qb) into (na, ma, qa): counts, means and sums of
// squared deviations, each step rounded (ops/fused_norm.py _chan_merge).
__device__ __forceinline__ void chan_merge(float& na, float& ma, float& qa, float nb, float mb, float qb) {
  if (nb == 0.f) return;
  if (na == 0.f) {
    na = nb;
    ma = mb;
    qa = qb;
    return;
  }
  const float n = __fadd_rn(na, nb);
  const float d = __fsub_rn(mb, ma);
  const float f = __fdiv_rn(nb, n);
  ma = __fadd_rn(ma, __fmul_rn(d, f));
  qa = __fadd_rn(__fadd_rn(qa, qb), __fmul_rn(__fmul_rn(d, d), __fmul_rn(na, f)));
  na = n;
}

__device__ __forceinline__ float pairwise8(const float (&v)[8]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[1]), __fadd_rn(v[2], v[3])),
                   __fadd_rn(__fadd_rn(v[4], v[5]), __fadd_rn(v[6], v[7])));
}

__device__ __forceinline__ void unpack8(float (&v)[8], const uint32_t (&raw)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = unpack_bf16x2(raw[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ float sum4(const float (&v)[4]) {
  return __fadd_rn(__fadd_rn(v[0], v[1]), __fadd_rn(v[2], v[3]));
}

// Run r (elements 8r .. 8r + 7 of the group, in memory order: `row`
// elements a row, rows `step` elements apart) as 8 bf16 in raw, zeros past
// the group's M elements; returns how many it holds. Only loads: the caller
// converts once every run of a batch is in flight.
template <int HOW>
__device__ __forceinline__ int load_run(uint32_t (&raw)[4], const __nv_bfloat16* g0, int r, int M, int row, int step) {
  const int i0 = r * 8;
  const int cnt = i0 >= M ? 0 : M - i0 < 8 ? M - i0 : 8;
  const int outer = i0 / row;
  int inner = i0 - outer * row;
  int off = outer * step + inner;  // elements from g0 (a group spans well under 2^31 of them)
  if constexpr (HOW == VEC16) {  // the run lies in one row, 16-byte aligned
    uint4 u = make_uint4(0, 0, 0, 0);
    if (cnt) u = __ldg(reinterpret_cast<const uint4*>(g0 + off));
    raw[0] = u.x;
    raw[1] = u.y;
    raw[2] = u.z;
    raw[3] = u.w;
  } else if constexpr (HOW == PAIRS) {  // rows, strides and counts even: pairs never straddle rows
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      raw[e] = 2 * e < cnt ? __ldg(reinterpret_cast<const unsigned int*>(g0 + off)) : 0u;
      off += 2;
      if ((inner += 2) == row) {
        inner = 0;
        off += step - row;
      }
    }
  } else {
    uint32_t h[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      h[e] = e < cnt ? __ldg(reinterpret_cast<const unsigned short*>(g0 + off)) : 0u;
      ++off;
      if (++inner == row) {
        inner = 0;
        off += step - row;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) raw[e] = h[2 * e] | (h[2 * e + 1] << 16);
  }
  return cnt;
}

template <int HOW>
__global__ void __launch_bounds__(STATS_THREADS, HOW == VEC16 ? 2 : 1)
    gn_stats_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ stats, int N, int C, int G, float eps,
                    long long x_sb, long long x_sn, long long x_sc, bool cl) {
  __shared__ float part[3][STATS_THREADS / 32];
  __shared__ float result[2];
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int Cg = C / G;
  const int M = Cg * N;
  const int runs = (M + 7) / 8;
  const int row = cl ? Cg : N;
  const int step = (int)(cl ? x_sn : x_sc);
  const __nv_bfloat16* g0 = x + b * x_sb + (long long)g * Cg * (cl ? 1 : x_sc);

  float n = 0.f, m = 0.f, q = 0.f;
  for (int r0 = tid; r0 < runs; r0 += STATS_UNROLL * STATS_THREADS) {
    uint32_t raw[STATS_UNROLL][4];
    float cnt[STATS_UNROLL], s[STATS_UNROLL], d2s[STATS_UNROLL];
#pragma unroll
    for (int u = 0; u < STATS_UNROLL; ++u)
      cnt[u] = (float)load_run<HOW>(raw[u], g0, r0 + u * STATS_THREADS, M, row, step);
#pragma unroll
    for (int u = 0; u < STATS_UNROLL; ++u) {
      float v[8];
      unpack8(v, raw[u]);
      s[u] = pairwise8(v);
    }
    const float c4 = sum4(cnt);
    const float mu = __fdiv_rn(sum4(s), c4);
#pragma unroll
    for (int u = 0; u < STATS_UNROLL; ++u) {
      float v[8];
      unpack8(v, raw[u]);  // again: the raw words take half the registers of the floats
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = (float)e < cnt[u] ? __fsub_rn(v[e], mu) : 0.f;
        v[e] = __fmul_rn(d, d);
      }
      d2s[u] = pairwise8(v);
    }
    chan_merge(n, m, q, c4, mu, sum4(d2s));
  }
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, n, o);
    const float mb = __shfl_down_sync(0xffffffffu, m, o);
    const float qb = __shfl_down_sync(0xffffffffu, q, o);
    chan_merge(n, m, q, nb, mb, qb);
  }
  if (lane == 0) {
    part[0][warp] = n;
    part[1][warp] = m;
    part[2][warp] = q;
  }
  __syncthreads();
  if (warp == 0) {
    constexpr int WARPS = STATS_THREADS / 32;
    n = lane < WARPS ? part[0][lane] : 0.f;
    m = lane < WARPS ? part[1][lane] : 0.f;
    q = lane < WARPS ? part[2][lane] : 0.f;
#pragma unroll
    for (int o = WARPS / 2; o >= 1; o >>= 1) {
      const float nb = __shfl_down_sync(0xffffffffu, n, o);
      const float mb = __shfl_down_sync(0xffffffffu, m, o);
      const float qb = __shfl_down_sync(0xffffffffu, q, o);
      chan_merge(n, m, q, nb, mb, qb);
    }
    if (lane == 0) {
      result[0] = m;
      result[1] = __frcp_rn(__fsqrt_rn(__fadd_rn(__fdiv_rn(q, n), eps)));
    }
  }
  __syncthreads();
  float* sb = stats + (long long)b * 2 * C + g * Cg;
  for (int c = tid; c < Cg; c += STATS_THREADS) {
    sb[c] = result[0];
    sb[C + c] = result[1];
  }
}

// ---------------------------------------------------------------------------
// normalise and project
// ---------------------------------------------------------------------------

// h = ((x - mean) * rsig) * gamma + beta, each step rounded; then h * sigmoid(h) with SiLU.
__device__ __forceinline__ float normalise(float x, float4 p, bool silu) {
  float h = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, p.x), p.y), p.z), p.w);
  if (silu) h = __fmul_rn(h, __frcp_rn(__fadd_rn(1.0f, __expf(-h))));
  return h;
}

// The u-th cell (16 bytes, 8 bf16) that thread tid normalises in K chunk
// kc, a [BM pixels x 64 channels] block of x at `at` whose 64-pixel pieces
// lie piece_stride bytes apart, each as 64 rows of 128 bytes; row r's
// physical 16-byte chunk k holds logical chunk k ^ (r % 8) (the 128-byte
// swizzle). Channels-last, a row is a pixel and a cell 8 of its channels:
// thread tid takes logical chunk tid % 8 of rows tid / 8 + 32 u, so its 8
// channels stay the same from cell to cell; NCHW, a row is a channel and a
// cell 8 of its pixels: thread tid takes cell tid + 256 u in memory order.
// Either way 8 neighbouring threads touch 8 different 16-byte banks. Gives
// the cell's address, first channel c and first pixel p.
template <bool CL>
__device__ __forceinline__ unsigned char* cell_at(int tid, int u, int kc, int p0, unsigned char* at, size_t piece_stride,
                                                  int& c, int& p) {
  if constexpr (CL) {
    const int row = (tid >> 3) + 32 * u;
    const int lc = tid & 7;
    c = kc * 64 + lc * 8;
    p = p0 + row;
    return at + (row >> 6) * piece_stride + (row & 63) * 128 + (lc ^ (row & 7)) * 16;
  } else {
    const int q = tid + u * THREADS;
    const int r = (q >> 3) & 63;
    c = kc * 64 + r;
    p = p0 + (q >> 9) * 64 + ((q & 7) ^ (r & 7)) * 8;
    return at + (q >> 9) * piece_stride + (q & 511) * 16;
  }
}

// A barrier of the consumer warpgroups alone (named barrier 1).
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory"); }

// v[i] for a lane-dependent i in 0..3, by selects (no local memory).
__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// Where channel c's parameters sit in shared memory: within each block of 64
// channels, (c % 8) * 8 + (c / 8) % 8, so the 8 lanes of a warp that read
// the same channel of 8 different channels-last chunks at once hit 8
// different banks.
__device__ __forceinline__ int param_slot(int c) { return (c & ~63) | ((c & 7) << 3) | ((c >> 3) & 7); }

// D[64 x N] (+)= A[64 x 16] . B[16 x N], both in shared memory, B K-major,
// A K-major (TA = 0) or MN-major (TA = 1: bf16 wgmma's transposed A).
template <int TA>
__device__ __forceinline__ void wgmma_m64n160k16_ss_ta(float (&d)[80], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %82, 0;\n"
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
      " %80, %81, p, 1, 1, %83, 0;\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA));
}

template <int TA>
__device__ __forceinline__ void wgmma_m64n80k16_ss_ta(float (&d)[40], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39},"
      " %40, %41, p, 1, 1, %43, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA));
}

template <int N, int TA>
__device__ __forceinline__ void wgmma_ta(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  if constexpr (N == 160)
    wgmma_m64n160k16_ss_ta<TA>(d, desc_a, desc_b, scale_d);
  else
    wgmma_m64n80k16_ss_ta<TA>(d, desc_a, desc_b, scale_d);
}

// Shared memory of a block (ops/fused_norm.py smem_bytes), from a 1024-byte
// boundary: the slab [BM x C] bf16 (x, then h; none with RING), the
// per-channel (mean, rsig, gamma, beta), the ring of stages (w [160 x 64
// channels], and with RING x [BM x 64 channels]), a barrier per slab chunk,
// a full and an empty barrier per stage.
template <bool CL, int BM, bool RING>
__global__ void __launch_bounds__(THREADS + 32, 1)
    gn_act_proj_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                       const __nv_bfloat16* __restrict__ x, const float* __restrict__ stats,
                       const void* __restrict__ gamma, const void* __restrict__ beta,
                       const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out, int N, int C,
                       int Cout, long long x_sb, long long x_sn, long long x_sc, int flags, int tiles_per_block,
                       int nstage) {
  constexpr bool COLS = BM == 64;         // each warpgroup takes half of a tile's columns, not 64 of its rows
  constexpr int WN = COLS ? TILE_N / 2 : TILE_N;  // output channels a warpgroup
  constexpr int W_BYTES = TILE_N * K_TILE * 2;
  constexpr int X_BYTES = BM * K_TILE * 2;  // a K chunk of x
  constexpr int STAGE_BYTES = W_BYTES + (RING ? X_BYTES : 0);
  constexpr int PIECES = BM / 64;          // 64-pixel pieces of a chunk, 512 cells each
  constexpr int CELLS = BM * 8 / THREADS;  // cells of a chunk a thread normalises
  extern __shared__ unsigned char smem_raw[];
  unsigned char* slab =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float4* params = reinterpret_cast<float4*>(slab + (RING ? 0 : (size_t)BM * C * 2));
  unsigned char* ring = reinterpret_cast<unsigned char*>(params + C);
  uint64_t* chunk_bar = reinterpret_cast<uint64_t*>(ring + (size_t)nstage * STAGE_BYTES);
  uint64_t* full = chunk_bar + MAX_CHUNKS;  // the stage has landed
  uint64_t* empty = full + nstage;           // the consumer warps are done with it

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int p0 = blockIdx.x * BM;
  const int tile0 = blockIdx.y * tiles_per_block;
  const int b = blockIdx.z;
  const int kch = C / K_TILE;
  const int n_stages = tiles_per_block * kch;  // the stages this block consumes, in order
  const bool silu = flags & SILU;
  const bool tma = flags & USE_TMA;
  // Each block takes the K chunks of a tile from its own starting chunk, so
  // that the blocks in flight do not all read the same w chunk from L2 at
  // once; stage j holds chunk chunk_of(j).
  const int rot = (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) % kch;
  auto chunk_of = [&](int j) {
    const int k = j % kch + rot;
    return k < kch ? k : k - kch;
  };
  // Where K chunk kc of x lies (stage st with RING), and how far apart its
  // 64-pixel pieces are: the slab holds channels-last x as [chunk][pixel]
  // rows of 128 bytes, NCHW x as [piece][channel] rows; a RING stage holds
  // its chunk as [piece][64 rows].
  constexpr bool PIECE_ROWS_OF_C = !RING && !CL;
  const size_t piece_stride = PIECE_ROWS_OF_C ? (size_t)C * 128 : 64 * 128;
  auto chunk_at = [&](int kc, int st) -> unsigned char* {
    if constexpr (RING)
      return ring + (size_t)st * STAGE_BYTES + W_BYTES;
    else
      return slab + (CL ? (size_t)kc * X_BYTES : (size_t)kc * 64 * 128);
  };

  // by one thread: x chunk kc into dst, reported to bar
  auto fetch_x = [&](int kc, unsigned char* dst, uint64_t* bar) {
    if constexpr (CL) {
      tma_load_3d(dst, &map_x, bar, kc * K_TILE, p0, b);
    } else {
#pragma unroll
      for (int pb = 0; pb < PIECES; ++pb) tma_load_3d(dst + pb * piece_stride, &map_x, bar, p0 + pb * 64, kc * K_TILE, b);
    }
  };
  auto fetch = [&](int j) {  // by one thread: stage j (w, and x with RING) into slot j % nstage
    const int st = j % nstage;
    const int kc = chunk_of(j);
    mbar_expect_tx(&full[st], W_BYTES + (RING && tma ? X_BYTES : 0));
    tma_load_2d(ring + (size_t)st * STAGE_BYTES, &map_w, &full[st], kc * K_TILE, (tile0 + j / kch) * TILE_N);
    if (RING && tma) fetch_x(kc, chunk_at(kc, st), &full[st]);
  };
  if (tid == 0) {
    if (!RING)
      for (int kc = 0; kc < kch; ++kc) mbar_init(&chunk_bar[kc], 1);
    for (int s = 0; s < nstage; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], THREADS / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();  // the barriers are initialised
  if (tid >= THREADS) {  // the producer warp: one thread issues every copy, then the warp leaves
    if (tid == THREADS) {
      if (!RING && tma) {  // the slab, chunk by chunk in the order the normalise takes them
        for (int i = 0; i < kch; ++i) {
          const int kc = chunk_of(i);
          mbar_expect_tx(&chunk_bar[kc], X_BYTES);
          fetch_x(kc, chunk_at(kc, 0), &chunk_bar[kc]);
        }
      }
      for (int j = 0; j < n_stages; ++j) {
        if (j >= nstage) mbar_wait(&empty[j % nstage], (j / nstage - 1) & 1);
        fetch(j);
      }
    }
    return;
  }
  {  // every load in flight before the stores
    constexpr int PER = MAX_CHUNKS * K_TILE / THREADS;  // channels a thread at most
    const float* st = stats + (long long)b * 2 * C;
    float4 v[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int c = tid + u * THREADS;
      if (c < C) {
        if (flags & GB_F32)
          v[u] = make_float4(st[c], st[C + c], static_cast<const float*>(gamma)[c], static_cast<const float*>(beta)[c]);
        else
          v[u] = make_float4(st[c], st[C + c], __bfloat162float(static_cast<const __nv_bfloat16*>(gamma)[c]),
                             __bfloat162float(static_cast<const __nv_bfloat16*>(beta)[c]));
      }
    }
#pragma unroll
    for (int u = 0; u < PER; ++u)
      if (tid + u * THREADS < C) params[param_slot(tid + u * THREADS)] = v[u];
  }
  consumers_sync();  // the parameters are staged

  // Normalise K chunk kc, at `at`, in place: its BM * 8 cells, CELLS a
  // thread, every load in flight before any is converted. Its data has
  // landed (the caller waited).
  const __nv_bfloat16* xb = x + b * x_sb;
  auto normalise_chunk = [&](int kc, unsigned char* at) {
    uint32_t raw[CELLS][4];
    unsigned char* cell[CELLS];
    int c[CELLS], p[CELLS];
#pragma unroll
    for (int u = 0; u < CELLS; ++u) {
      cell[u] = cell_at<CL>(tid, u, kc, p0, at, piece_stride, c[u], p[u]);
      if (tma) {
        const uint4 v = *reinterpret_cast<const uint4*>(cell[u]);
        raw[u][0] = v.x;
        raw[u][1] = v.y;
        raw[u][2] = v.z;
        raw[u][3] = v.w;
      } else {  // element loads; pixels past N read as zeros (their rows are never stored)
        unsigned short h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if constexpr (CL)
            h[e] = p[u] < N ? __ldg(reinterpret_cast<const unsigned short*>(xb + (long long)p[u] * x_sn + c[u] + e)) : 0;
          else
            h[e] = p[u] + e < N ? __ldg(reinterpret_cast<const unsigned short*>(xb + (long long)c[u] * x_sc + p[u] + e))
                                : 0;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) raw[u][e] = (uint32_t)h[2 * e] | ((uint32_t)h[2 * e + 1] << 16);
      }
    }
    // h in place of the raw words; channels-last, each pair of the thread's
    // 8 channels (the same in every cell) is read once for all its cells
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float4 pa, pb;
      if constexpr (CL) {
        pa = params[param_slot(c[0] + 2 * e)];
        pb = params[param_slot(c[0] + 2 * e + 1)];
      }
#pragma unroll
      for (int u = 0; u < CELLS; ++u) {
        if constexpr (!CL) pa = pb = params[param_slot(c[u])];
        const float2 f = unpack_bf16x2(raw[u][e]);
        raw[u][e] = pack_bf16x2(normalise(f.x, pa, silu), normalise(f.y, pb, silu));
      }
    }
#pragma unroll
    for (int u = 0; u < CELLS; ++u)
      *reinterpret_cast<uint4*>(cell[u]) = make_uint4(raw[u][0], raw[u][1], raw[u][2], raw[u][3]);
    fence_proxy_async();  // h, visible to wgmma
  };
  // stage j's chunk: wait for it, normalise it (with RING every stage's,
  // else the first tile's only: the slab keeps h for the others)
  auto prepare_chunk = [&](int j) {
    const int kc = chunk_of(j);
    if constexpr (RING) {
      mbar_wait(&full[j % nstage], (j / nstage) & 1);
    } else {
      if (tma) mbar_wait(&chunk_bar[kc], 0);
    }
    normalise_chunk(kc, chunk_at(kc, j % nstage));
  };
  prepare_chunk(0);
  consumers_sync();

  // A, this warpgroup's 64 pixels of h in chunk kc: channels-last, K-major,
  // 8-row atoms 1024 bytes apart, a k16 step 32 bytes on; NCHW, MN-major,
  // 8-channel atoms 1024 bytes apart, a k16 step two atoms on. B, the
  // stage's w rows (K-major), 8-row atoms 1024 bytes apart, a k16 step 32
  // bytes on. The products on stage j run while the threads normalise the
  // chunk of stage j + 1.
  const int r_lo = p0 + (COLS ? 0 : wg * 64) + ((tid / 32) % 4) * 16 + lane / 4;
  const int r_hi = r_lo + 8;
  const int tig = lane % 4;
  float acc[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
  for (int tl = 0; tl < tiles_per_block; ++tl) {
    for (int i = 0; i < kch; ++i) {
      const int j = tl * kch + i;
      const int kc = chunk_of(j);
      const int st = j % nstage;
      mbar_wait(&full[st], (j / nstage) & 1);
      const uint64_t desc_a = make_desc_sw128(chunk_at(kc, st) + (COLS ? 0 : wg * piece_stride),
                                              CL ? 16 : (uint32_t)piece_stride, 1024);
      const uint64_t desc_w = make_desc_sw128(ring + (size_t)st * STAGE_BYTES + (COLS ? wg * WN * 128 : 0), 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < K_TILE / 16; ++ks)
        wgmma_ta<WN, CL ? 0 : 1>(acc, desc_add(desc_a, CL ? ks * 32 : ks * 2048), desc_add(desc_w, ks * 32),
                                 i > 0 || ks > 0);
      wgmma_commit();
      const bool more = RING ? j + 1 < n_stages : tl == 0 && i + 1 < kch;
      if (more) prepare_chunk(j + 1);
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[st]);  // this warp's products on the stage are done
      if (more) consumers_sync();              // the next chunk is h for every warpgroup
    }
    // round to bf16, add the bias in bf16, store rows below N: each group of
    // four 8-column blocks is transposed in the quad that holds its rows, so
    // each thread stores 16 bytes of a row, and a warp 64 contiguous bytes of
    // each of its 8 rows
    const int co0 = (tile0 + tl) * TILE_N + (COLS ? wg * WN : 0);
    auto out_pair = [&](int jb, int half) {  // bf16(bf16(acc) + bias) of two adjacent columns
      const float2 bv = unpack_bf16x2(*reinterpret_cast<const uint32_t*>(bias + co0 + jb * 8 + tig * 2));
      const float2 o = unpack_bf16x2(pack_bf16x2(acc[4 * jb + 2 * half], acc[4 * jb + 2 * half + 1]));
      return pack_bf16x2(o.x + bv.x, o.y + bv.y);
    };
#pragma unroll
    for (int jg = 0; jg < WN / 32; ++jg) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t v[4], got[4], row_out[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = out_pair(jg * 4 + k, half);
#pragma unroll
        for (int sx = 0; sx < 4; ++sx) got[sx] = __shfl_xor_sync(0xffffffffu, pick4(v, tig ^ sx), sx);
#pragma unroll
        for (int m = 0; m < 4; ++m) row_out[m] = pick4(got, m ^ tig);
        const int r = half ? r_hi : r_lo;
        if (r < N)
          *reinterpret_cast<uint4*>(out + ((long long)b * N + r) * Cout + co0 + (jg * 4 + tig) * 8) =
              make_uint4(row_out[0], row_out[1], row_out[2], row_out[3]);
      }
    }
#pragma unroll
    for (int jb = WN / 32 * 4; jb < WN / 8; ++jb) {  // the blocks past the last group of four
      const int col = co0 + jb * 8 + tig * 2;
      if (r_lo < N) *reinterpret_cast<uint32_t*>(out + ((long long)b * N + r_lo) * Cout + col) = out_pair(jb, 0);
      if (r_hi < N) *reinterpret_cast<uint32_t*>(out + ((long long)b * N + r_hi) * Cout + col) = out_pair(jb, 1);
    }
  }
}

// A bf16 tile map of `rank` dims (innermost first), strides in bytes of
// dims 1.., cut in `box` boxes of 128-byte rows, 128-byte swizzled; boxes
// past the edge read as zeros.
cudaError_t sw128_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims, const cuuint64_t* strides,
                      const cuuint32_t* box) {
  const auto encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool CL, int BM, bool RING>
cudaError_t launch_proj(const void* x, const float* stats, const void* gamma, const void* beta, const void* w,
                        const void* bias, void* out, int B, int N, int C, int Cout, long long x_sb, long long x_sn,
                        long long x_sc, int flags, int splits, int nstage, cudaStream_t s) {
  const auto kernel = gn_act_proj_kernel<CL, BM, RING>;
  static bool ready[MAX_DEVICES];
  cudaError_t err = prepare(kernel, SMEM_LIMIT, ready);
  if (err != cudaSuccess) return err;
  const int smem = 1024 + (RING ? 0 : BM * C * 2) + C * 16 + nstage * (TILE_N + (RING ? BM : 0)) * K_TILE * 2 +
                   8 * MAX_CHUNKS + 16 * nstage;
  if (smem > SMEM_LIMIT || (!RING && C / K_TILE > MAX_CHUNKS)) return cudaErrorInvalidValue;
  CUtensorMap mx, mw;
  memset(&mx, 0, sizeof(mx));
  if (flags & USE_TMA) {
    if (CL) {  // (channel, pixel, image), boxes of (64 channels, BM pixels)
      const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)N, (cuuint64_t)B};
      const cuuint64_t strides[2] = {(cuuint64_t)x_sn * 2, (cuuint64_t)x_sb * 2};
      const cuuint32_t box[3] = {64, (cuuint32_t)BM, 1};
      err = sw128_map(&mx, x, 3, dims, strides, box);
    } else {  // (pixel, channel, image), boxes of (64 pixels, 64 channels)
      const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)C, (cuuint64_t)B};
      const cuuint64_t strides[2] = {(cuuint64_t)x_sc * 2, (cuuint64_t)x_sb * 2};
      const cuuint32_t box[3] = {64, 64, 1};
      err = sw128_map(&mx, x, 3, dims, strides, box);
    }
    if (err != cudaSuccess) return err;
  }
  {  // w [Cout, C], boxes of (64 channels, TILE_N output channels)
    const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)Cout};
    const cuuint64_t strides[1] = {(cuuint64_t)C * 2};
    const cuuint32_t box[2] = {K_TILE, TILE_N};
    err = sw128_map(&mw, w, 2, dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + BM - 1) / BM, splits, B);
  kernel<<<grid, THREADS + 32, smem, s>>>(mx, mw, static_cast<const __nv_bfloat16*>(x), stats, gamma, beta,
                                     static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), N, C,
                                     Cout, x_sb, x_sn, x_sc, flags, Cout / TILE_N / splits, nstage);
  return cudaGetLastError();
}

template <bool CL, bool RING>
cudaError_t launch_proj_tile(const void* x, const float* stats, const void* gamma, const void* beta, const void* w,
                             const void* bias, void* out, int B, int N, int C, int Cout, long long x_sb,
                             long long x_sn, long long x_sc, int flags, int bm, int splits, int nstage,
                             cudaStream_t s) {
  if (bm == 128)
    return launch_proj<CL, 128, RING>(x, stats, gamma, beta, w, bias, out, B, N, C, Cout, x_sb, x_sn, x_sc,
                                              flags, splits, nstage, s);
  return launch_proj<CL, 64, RING>(x, stats, gamma, beta, w, bias, out, B, N, C, Cout, x_sb, x_sn, x_sc, flags,
                                           splits, nstage, s);
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

// Plain C entry point (loaded with ctypes): the statistics, then the
// normalise and projection, on `stream`. x [B, N, C] bf16 with element
// strides x_sb, x_sn, x_sc, of which x_sn (pixels contiguous, the NCHW
// activations) or x_sc (channels contiguous) is 1; stats [B, 2, C] float32
// (written: per-channel mean, then rsigma); gamma, beta [C] bf16, or
// float32 with flag 2; w [Cout, C], bias [Cout] bf16; out [B, N, Cout] bf16.
// flags: 1 SiLU, 2 gamma/beta float32. The tiling (bm, splits, nstage,
// ring) is ops/fused_norm.py plan's. Returns the CUDA error of the launches (0 on
// success).
extern "C" int gn_act_proj(const void* x, void* stats, const void* gamma, const void* beta, const void* w,
                           const void* bias, void* out, int B, int N, int C, int Cout, int G, float eps,
                           long long x_sb, long long x_sn, long long x_sc, int flags, int bm, int splits,
                           int nstage, int ring, void* stream) {
  if (B <= 0 || N <= 0 || C % K_TILE != 0 || G <= 0 || C % G != 0 || (x_sn != 1 && x_sc != 1) ||
      (bm != 64 && bm != 128) || Cout % TILE_N != 0 || splits <= 0 || (Cout / TILE_N) % splits != 0 || nstage < 1 ||
      !aligned(w, 16) || !aligned(bias, 4))
    return (int)cudaErrorInvalidValue;
  const long long group_span = x_sc == 1 ? (N - 1) * x_sn + C / G : (C / G - 1) * x_sc + N;
  if (group_span >= (1ll << 31)) return (int)cudaErrorInvalidValue;  // the statistics address a group in int
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool cl = x_sc == 1;
  const int Cg = C / G;
  const int row = cl ? Cg : N;
  const long long step = cl ? x_sn : x_sc;
  const dim3 stats_grid(G, B);
  const auto* xs = static_cast<const __nv_bfloat16*>(x);
  float* so = static_cast<float*>(stats);
  if (row % 8 == 0 && step % 8 == 0 && x_sb % 8 == 0 && aligned(x, 16))
    gn_stats_kernel<VEC16><<<stats_grid, STATS_THREADS, 0, s>>>(xs, so, N, C, G, eps, x_sb, x_sn, x_sc, cl);
  else if (row % 2 == 0 && step % 2 == 0 && x_sb % 2 == 0 && aligned(x, 4))
    gn_stats_kernel<PAIRS><<<stats_grid, STATS_THREADS, 0, s>>>(xs, so, N, C, G, eps, x_sb, x_sn, x_sc, cl);
  else
    gn_stats_kernel<ELEMENTS><<<stats_grid, STATS_THREADS, 0, s>>>(xs, so, N, C, G, eps, x_sb, x_sn, x_sc, cl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the TMA unit takes 16-byte-aligned strides
  const bool tma = x_sb % 8 == 0 && aligned(x, 16) && (cl ? x_sn % 8 == 0 : x_sc % 8 == 0);
  flags = (flags & (SILU | GB_F32)) | (tma ? USE_TMA : 0);
  const float* st = static_cast<const float*>(stats);
  if (cl && ring)
    err = launch_proj_tile<true, true>(x, st, gamma, beta, w, bias, out, B, N, C, Cout, x_sb, x_sn, x_sc, flags, bm,
                                       splits, nstage, s);
  else if (cl)
    err = launch_proj_tile<true, false>(x, st, gamma, beta, w, bias, out, B, N, C, Cout, x_sb, x_sn, x_sc, flags, bm,
                                        splits, nstage, s);
  else if (ring)
    err = launch_proj_tile<false, true>(x, st, gamma, beta, w, bias, out, B, N, C, Cout, x_sb, x_sn, x_sc, flags, bm,
                                        splits, nstage, s);
  else
    err = launch_proj_tile<false, false>(x, st, gamma, beta, w, bias, out, B, N, C, Cout, x_sb, x_sn, x_sc, flags, bm,
                                         splits, nstage, s);
  return (int)err;
}
