// gn_act_proj_f32: GroupNorm, an optional SiLU and the 1x1 projection in
// one call, in float32, for the entry of every SpatialTransformer of the
// UNet without grad in a float32 run (DIFFMINING_FUSED_NORM=1 with --dtype
// fp32). Written for Hopper (sm_90a). One C entry point launches two
// kernels on the caller's stream:
//   gn_stats_f32_kernel  the per-(batch, group) mean and rsigma, fp32, per
//                        channel into a [B, 2, C] buffer;
//   gn_proj_f32_kernel   the normalise (and SiLU) and the projection.
//
// Replaces diffmining_tpu/ops/fused_norm.py:27 _gn_act_matmul_kernel (via
// gn_act_proj, :44) at float32, and the XLA reduce that computes its
// statistics there (:68-77). At float32 the TPU kernel computes in float32
// throughout (h.astype(w.dtype) and the output's astype are no-ops).
//
// Arithmetic, float32 throughout (no TF32, no tensor-core instruction; fp32
// FMA only in the product), as the plain version (ops/fused_norm.py
// gn_act_proj_plain at float32):
//   mean, var over each (batch, group), var the mean of squared deviations
//                     (merged centred, never E[x^2] - E[x]^2), in the
//                     order of gn_act_proj.cu's statistics kernel, so
//                     group_stats_plain repeats it; rsig = 1 / sqrt(var + eps)
//   h   = ((x - mean) * rsig) * gamma + beta     each step rounded (no FMA
//                                                contraction)
//   h   = h * sigmoid(h)                         only with act="silu"
//   out = (sum over channels of h . w) + bias    each output's sum channel
//                                                by channel; a split sum
//                                                adds its parts in order
//
// What bounds it on an H100 SXM: 2 N C Cout fp32 operations an image for
// the projection (and 4 a normalised x element) against 67 TFLOP/s outside
// the tensor cores: at B8 N4096 C320 Cout320 6.7e9, 0.100 ms; x and out are
// 42 MB each, 0.025 ms at 3.35 TB/s. It is bound by its operations at every
// SpatialTransformer entry of a 512 px pass (B8 N64 C1280: 1.7e9, 0.025 ms).
// On the FMA pipes an SM issues one warp's FFMA a clock on each of its four
// schedulers, so a product runs at that rate only while few other
// instructions (shared-memory reads above all) share the issue slots.
//
// The statistics (gn_stats_f32_kernel): gn_act_proj.cu's order with element
// loads: one block of 512 threads per (group, batch); a group's elements,
// in memory order (channel by channel for NCHW x, pixel by pixel for
// channels-last x), cut in runs of 8; thread t takes runs t, t + 512, t +
// 1024 and t + 1536 at once (their count, mean and sum of squared
// deviations, pairwise sums), merges them into its partial by Chan's
// centred merge, then the next four, 2048 runs on; a shuffle-down tree
// within each warp and one across the 16 warps end it.
//
// The projection (gn_proj_f32_kernel): one block a (BM pixels, 160 output
// channels, image, part of the channel sum), BM = 128 (256 threads) or 64
// (128 threads) where an image has no more than 64 pixels. Each thread
// holds an 8 x 10 register tile of the output: pixels 4ty + i and BM/2 +
// 4ty + i, outputs 4tx + j, 64 + 4tx + j and 128 + 2tx + j; a warp is 8 ty
// x 4 tx, so each shared read touches 128 bytes or less without bank
// conflicts. A channel step is two 16-byte reads of h and two 16-byte and
// one 8-byte read of w for 80 FFMA. Both stages are channel-major (h
// [16][BM + 4], w [16][164]), so a thread's operands of a step come from
// registers of both parities and the compiler can keep each FFMA's two
// register reads off one bank. w read along its channels instead (a
// [160][36] stage that cp.async fills, whose 16-byte reads give all of a
// step's w operands one parity) measured 4-8% slower: 0.2527 against
// 0.2348 ms at B8 N4096 C320 on an H100.
// The input channels stream in 16-channel chunks through a ring of two
// stages in shared memory, one barrier a chunk. While a block multiplies
// one stage, cp.async brings the next w chunk ([160][20], as it lies in
// memory) into a staging area and the next x chunk is loaded into
// registers (16 bytes a load along whichever axis of x is contiguous:
// pixels for NCHW x, channels for channels-last x; element loads where
// the strides or N leave 16-byte loads unaligned); after the multiply each
// thread moves its own w copies into the other stage transposed and
// normalises its x once into it.
// What bounds it: the FFMA loop alone (the chunk loads and stores taken
// out) ran at 61% of the fp32 peak, 0.187 ms at B8 N4096 C320 with the
// statistics, as cuBLAS's float32 product of the same shape does (0.161);
// the loads, the normalise and the transposed stores of each chunk, done by
// the same warps between the products, take the rest (a chunk's unrolled
// loop is 61% product FFMA by instruction count): 199-209 registers a
// thread, one block an SM, so no other block's products fill that time.
// Measured and not kept: a producer warpgroup feeding two consumer
// warpgroups (0.24-0.27 against 0.22 ms at B8 N4096 C320, faster only at
// N64), stores spread among the channel steps (no faster), two blocks an
// SM at 128 registers (spills, 8-40% slower).
// Small images (B8 N64 C1280: 64 blocks of 64 pixels for 132 SMs) split
// the channel sum over a cluster of 2 or 4 blocks, until the blocks would
// pass one an SM: each block sums its share of the channels, hands its
// [64 x 160] partial to the cluster in its shared memory, and block r of
// the cluster adds its rows of the partials in rank order (0, 1, ...)
// through distributed shared memory, adds the bias and stores them. No
// atomics: a call repeats bit for bit. The split and BM are chosen from the
// shape and the card's SM count in the entry point.
// Layout: x is [B, N, C] with element strides x_sb, x_sn, x_sc, of which
// x_sn or x_sc is 1; stats [B, 2, C] fp32 (written here); gamma, beta [C],
// w [Cout, C] and bias [Cout] fp32 contiguous; out [B, N, Cout] fp32
// contiguous. C must be a multiple of 16 and of G, Cout of 160.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int STATS_THREADS = 512;
constexpr int STATS_UNROLL = 4;  // runs a thread loads at once and merges as one
constexpr int BN = 160;          // output channels a block: SD's widths 320, 640 and 1280 are multiples
constexpr int TX = 16;           // threads along the output channels, 10 outputs each
constexpr int KC = 16;           // input channels a chunk
constexpr int WS = BN + 4;       // row stride of a w stage [KC][WS], and of a split block's partial [BM][WS]
constexpr int MAX_SPLIT = 4;     // blocks a cluster splits the channel sum over
constexpr int SILU = 1;

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

__device__ __forceinline__ float sum4(const float (&v)[4]) {
  return __fadd_rn(__fadd_rn(v[0], v[1]), __fadd_rn(v[2], v[3]));
}

// Run r (elements 8r .. 8r + 7 of the group, in memory order: `row`
// elements a row, rows `step` elements apart), zeros past the group's M
// elements; returns how many it holds.
__device__ __forceinline__ int load_run(float (&v)[8], const float* g0, int r, int M, int row, long long step) {
  const int i0 = r * 8;
  const int cnt = i0 >= M ? 0 : M - i0 < 8 ? M - i0 : 8;
  const int outer = i0 / row;
  int inner = i0 - outer * row;
  long long off = outer * step + inner;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    v[e] = e < cnt ? __ldg(g0 + off) : 0.f;
    ++off;
    if (++inner == row) {
      inner = 0;
      off += step - row;
    }
  }
  return cnt;
}

__global__ void __launch_bounds__(STATS_THREADS)
    gn_stats_f32_kernel(const float* __restrict__ x, float* __restrict__ stats, int N, int C, int G, float eps,
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
  const long long step = cl ? x_sn : x_sc;
  const float* g0 = x + b * x_sb + static_cast<long long>(g) * Cg * (cl ? 1 : x_sc);

  float n = 0.f, m = 0.f, q = 0.f;
  for (int r0 = tid; r0 < runs; r0 += STATS_UNROLL * STATS_THREADS) {
    float v[STATS_UNROLL][8];
    float cnt[STATS_UNROLL], s[STATS_UNROLL], d2s[STATS_UNROLL];
#pragma unroll
    for (int u = 0; u < STATS_UNROLL; ++u) cnt[u] = (float)load_run(v[u], g0, r0 + u * STATS_THREADS, M, row, step);
#pragma unroll
    for (int u = 0; u < STATS_UNROLL; ++u) s[u] = pairwise8(v[u]);
    const float c4 = sum4(cnt);
    const float mu = __fdiv_rn(sum4(s), c4);
#pragma unroll
    for (int u = 0; u < STATS_UNROLL; ++u) {
      float d2[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = (float)e < cnt[u] ? __fsub_rn(v[u][e], mu) : 0.f;
        d2[e] = __fmul_rn(d, d);
      }
      d2s[u] = pairwise8(d2);
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
  float* sb = stats + static_cast<long long>(b) * 2 * C + g * Cg;
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
  if (silu) h = __fmul_rn(h, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-h))));
  return h;
}

__device__ __forceinline__ float lane_of(const float4& v, int e) { return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// The projection's tiling at BM pixels a block.
template <int BM>
struct Proj {
  static constexpr int THREADS = BM / 8 * TX;  // 256 at BM = 128, 128 at 64
  static constexpr int MIN_BLOCKS = BM == 128 ? 1 : 2;
  static constexpr int HS = BM + 4;  // row stride of an h stage [KC][HS] (odd in 16-byte units)
  static constexpr int STAGE = KC * (HS + WS);  // floats of a stage: h [KC][HS], then w [KC][WS]
  static constexpr int X4 = BM * KC / 4;        // 16-byte x slots of a chunk
  static constexpr int XLOADS = (X4 + THREADS - 1) / THREADS;
  static constexpr int W4 = BN * KC / 4;  // 16-byte w slots of a chunk
  static constexpr int WLOADS = (W4 + THREADS - 1) / THREADS;
  static constexpr int RING = 2 * STAGE > BM * WS ? 2 * STAGE : BM * WS;  // floats: the ring, or the partial
  static constexpr int STAGING = BN * (KC + 4);  // raw w [BN][KC + 4] as cp.async brings it
  static size_t smem(int channels) {
    return size_t(channels) * sizeof(float4) + size_t(RING + STAGING) * sizeof(float);
  }
};

// w slot f of a chunk: channels c .. c + 3 of output co, a warp taking 16
// outputs x 2 slots (whole 32-byte sectors of w), so its transposed stores
// into the w stage hit 32 banks.
__device__ __forceinline__ void w_slot(int f, int& co, int& c) {
  const int q = f / 32, r = f % 32;
  c = 4 * (2 * (q / (BN / 16)) + r / 16);
  co = 16 * (q % (BN / 16)) + r % 16;
}

// x slot f of a chunk: its pixel p and first channel c (relative to the
// tile and chunk). Channels-last x: channels c .. c + 3 of pixel p, a warp
// taking 16 pixels x 2 slots so its transposed stores into the h stage hit
// 32 banks; NCHW x: pixels p .. p + 3 of channel c, a warp along a row.
template <int BM>
__device__ __forceinline__ void x_slot(int f, bool cl, int& p, int& c) {
  if (cl) {
    const int q = f / 32, r = f % 32;
    c = 4 * (2 * (q / (BM / 16)) + r / 16);
    p = 16 * (q % (BM / 16)) + r % 16;
  } else {
    p = 4 * (f % (BM / 4));
    c = f / (BM / 4);
  }
}

template <int BM, bool VEC>
__global__ void __launch_bounds__(Proj<BM>::THREADS, Proj<BM>::MIN_BLOCKS)
    gn_proj_f32_kernel(const float* __restrict__ x, const float* __restrict__ stats, const float* __restrict__ gamma,
                       const float* __restrict__ beta, const float* __restrict__ w, const float* __restrict__ bias,
                       float* __restrict__ out, int N, int C, int Cout, long long x_sb, long long x_sn, long long x_sc,
                       int flags, int split) {
  using P = Proj<BM>;
  constexpr int T = P::THREADS;
  const int cs = C / split;  // channels this block sums
  extern __shared__ float4 smem4[];
  float4* sparam = smem4;                              // [cs]: mean, rsig, gamma, beta
  float* ring = reinterpret_cast<float*>(smem4 + cs);  // two stages (h [KC][HS], then w [KC][WS])
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ty = (warp / 4) * 8 + lane / 4, tx = (warp % 4) * 4 + lane % 4;
  const int n0 = blockIdx.x * BM, co0 = blockIdx.y * BN;
  const int b = blockIdx.z / split, part = blockIdx.z % split;
  const int c_lo = part * cs;
  const bool silu = flags & SILU;
  const bool cl = x_sc == 1;
  const float* xb = x + b * x_sb;
  const float* sb = stats + static_cast<long long>(b) * 2 * C + c_lo;

  for (int c = tid; c < cs; c += T) sparam[c] = make_float4(sb[c], sb[C + c], gamma[c_lo + c], beta[c_lo + c]);

  float4 xr[P::XLOADS];  // this thread's x slots of the next chunk, raw
  auto load_x = [&](int k) {
    const int c0 = c_lo + k * KC;
#pragma unroll
    for (int i = 0; i < P::XLOADS; ++i) {
      const int f = tid + i * T;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);  // pixels past N: zeros, never stored
      if (f < P::X4) {
        int p, c;
        x_slot<BM>(f, cl, p, c);
        const int n = n0 + p;
        if (cl) {
          const float* src = xb + n * x_sn + c0 + c;
          if (n < N) v = VEC ? __ldg(reinterpret_cast<const float4*>(src))
                             : make_float4(__ldg(src), __ldg(src + 1), __ldg(src + 2), __ldg(src + 3));
        } else {
          const float* src = xb + (c0 + c) * x_sc + n;
          if (VEC) {
            if (n < N) v = __ldg(reinterpret_cast<const float4*>(src));  // N % 4 == 0: all four or none
          } else {
            if (n < N) v.x = __ldg(src);
            if (n + 1 < N) v.y = __ldg(src + 1);
            if (n + 2 < N) v.z = __ldg(src + 2);
            if (n + 3 < N) v.w = __ldg(src + 3);
          }
        }
      }
      xr[i] = v;
    }
  };
  // normalised once, channel-major into an h stage
  auto store_h = [&](int k, float* hs) {
    const float4* prm = sparam + k * KC;
#pragma unroll
    for (int i = 0; i < P::XLOADS; ++i) {
      const int f = tid + i * T;
      if (f < P::X4) {
        int p, c;
        x_slot<BM>(f, cl, p, c);
        if (cl) {
#pragma unroll
          for (int e = 0; e < 4; ++e) hs[(c + e) * P::HS + p] = normalise(lane_of(xr[i], e), prm[c + e], silu);
        } else {
          const float4 q = prm[c];
          *reinterpret_cast<float4*>(hs + c * P::HS + p) =
              make_float4(normalise(xr[i].x, q, silu), normalise(xr[i].y, q, silu), normalise(xr[i].z, q, silu),
                          normalise(xr[i].w, q, silu));
        }
      }
    }
  };
  constexpr bool W4_EXACT = P::W4 % T == 0;
  float* staging = ring + P::RING;
  auto load_w = [&](int k) {  // rows co0 .. co0 + 159 of w, this chunk's KC channels, by cp.async
    const float* src = w + static_cast<long long>(co0) * C + c_lo + k * KC;
#pragma unroll
    for (int i = 0; i < P::WLOADS; ++i) {
      int co, c;
      w_slot(tid + i * T, co, c);
      if (W4_EXACT || tid + i * T < P::W4)
        cp_async16(staging + co * (KC + 4) + c, src + static_cast<long long>(co) * C + c);
    }
    cp_async_commit();
  };
  auto store_w = [&](float* ws) {  // this thread's own copies, transposed: channel-major
    cp_async_wait_all();
#pragma unroll
    for (int i = 0; i < P::WLOADS; ++i) {
      int co, c;
      w_slot(tid + i * T, co, c);
      if (W4_EXACT || tid + i * T < P::W4) {
        const float4 v = *reinterpret_cast<const float4*>(staging + co * (KC + 4) + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) ws[(c + e) * WS + co] = lane_of(v, e);
      }
    }
  };

  float acc[8][10];  // pixels 4ty + i, BM/2 + 4ty + i; outputs 4tx + j, 64 + 4tx + j, 128 + 2tx + j
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 10; ++j) acc[i][j] = 0.f;

  const int nk = cs / KC;
  load_w(0);
  load_x(0);
  __syncthreads();  // the parameters are staged
  store_w(ring + KC * P::HS);
  store_h(0, ring);
  __syncthreads();
  for (int k = 0; k < nk; ++k) {
    const float* hs = ring + (k & 1) * P::STAGE;
    const float* ws = hs + KC * P::HS;
    float* next = ring + ((k + 1) & 1) * P::STAGE;
    const bool more = k + 1 < nk;
    if (more) {  // in flight while this stage is multiplied
      load_w(k + 1);
      load_x(k + 1);
    }
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const float4 a0 = *reinterpret_cast<const float4*>(hs + c * P::HS + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(hs + c * P::HS + BM / 2 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(ws + c * WS + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(ws + c * WS + 64 + 4 * tx);
      const float2 b2 = *reinterpret_cast<const float2*>(ws + c * WS + 128 + 2 * tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[10] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w, b2.x, b2.y};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 10; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {  // the other stage is free: every thread passed the last barrier
      store_w(next + KC * P::HS);
      store_h(k + 1, next);
    }
    __syncthreads();  // the next stage is whole; this one is free
  }

  // a row's ten outputs: 4 at 4tx, 4 at 64 + 4tx, 2 at 128 + 2tx
  auto store_row = [&](float* row, const float (&a)[10], float4 b0, float4 b1, float2 b2) {
    *reinterpret_cast<float4*>(row + 4 * tx) = make_float4(a[0] + b0.x, a[1] + b0.y, a[2] + b0.z, a[3] + b0.w);
    *reinterpret_cast<float4*>(row + 64 + 4 * tx) = make_float4(a[4] + b1.x, a[5] + b1.y, a[6] + b1.z, a[7] + b1.w);
    *reinterpret_cast<float2*>(row + 128 + 2 * tx) = make_float2(a[8] + b2.x, a[9] + b2.y);
  };
  if (split == 1) {
    const float* bb = bias + co0;
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(bb + 4 * tx));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(bb + 64 + 4 * tx));
    const float2 b2 = __ldg(reinterpret_cast<const float2*>(bb + 128 + 2 * tx));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = n0 + (i < 4 ? 4 * ty + i : BM / 2 + 4 * ty + i - 4);
      if (n < N) store_row(out + (static_cast<long long>(b) * N + n) * Cout + co0, acc[i], b0, b1, b2);
    }
    return;
  }

  // a split sum: this block's partial into its shared memory (the ring is
  // free: the last barrier passed), then block r of the cluster adds rows
  // r BM / split .. of the partials in rank order and stores them
  float* mine = ring;  // [BM][WS]
  const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    store_row(mine + (i < 4 ? 4 * ty + i : BM / 2 + 4 * ty + i - 4) * WS, acc[i], z4, z4, make_float2(0.f, 0.f));
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every partial of the cluster is written
  const int rows = BM / split, r0 = part * rows;
  for (int f = tid; f < rows * (BN / 4); f += T) {
    const int r = r0 + f / (BN / 4), c4 = f % (BN / 4);
    const int off = r * WS + 4 * c4;
    float4 s = *reinterpret_cast<const float4*>(cluster.map_shared_rank(mine, 0) + off);
    for (int q = 1; q < split; ++q) {
      const float4 t = *reinterpret_cast<const float4*>(cluster.map_shared_rank(mine, q) + off);
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    const int n = n0 + r;
    if (n < N) {
      const float4 bs = __ldg(reinterpret_cast<const float4*>(bias + co0 + 4 * c4));
      *reinterpret_cast<float4*>(out + (static_cast<long long>(b) * N + n) * Cout + co0 + 4 * c4) =
          make_float4(s.x + bs.x, s.y + bs.y, s.z + bs.z, s.w + bs.w);
    }
  }
  cluster.sync();  // no block leaves while another reads its partial
}

template <int BM, bool VEC>
cudaError_t launch_proj(const float* x, const float* stats, const float* gamma, const float* beta, const float* w,
                        const float* bias, float* out, int B, int N, int C, int Cout, long long x_sb, long long x_sn,
                        long long x_sc, int flags, int split, cudaStream_t s) {
  const auto kernel = gn_proj_f32_kernel<BM, VEC>;
  const size_t smem = Proj<BM>::smem(C / split);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BM - 1) / BM, Cout / BN, B * split);
  cfg.blockDim = dim3(Proj<BM>::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, x, stats, gamma, beta, w, bias, out, N, C, Cout, x_sb, x_sn, x_sc, flags,
                           split);
  return err != cudaSuccess ? err : cudaGetLastError();
}

int sm_count() {
  static int counts[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!counts[dev] && cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    counts[dev] = 132;
  return counts[dev];
}

}  // namespace

// Plain C entry point (loaded with ctypes): the statistics kernel, then the
// projection kernel. flags: 1 = SiLU. Returns the CUDA error of the launches
// (0 on success).
extern "C" int gn_act_proj_f32(const void* x, void* stats, const void* gamma, const void* beta, const void* w,
                               const void* bias, void* out, int B, int N, int C, int Cout, int G, float eps,
                               long long x_sb, long long x_sn, long long x_sc, int flags, void* stream) {
  if (B <= 0 || N <= 0 || B > 65535 / MAX_SPLIT || G <= 0 || C % G != 0 || C % KC != 0 || Cout % BN != 0 ||
      (x_sn != 1 && x_sc != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool cl = x_sc == 1;
  gn_stats_f32_kernel<<<dim3(G, B), STATS_THREADS, 0, s>>>(static_cast<const float*>(x), static_cast<float*>(stats),
                                                          N, C, G, eps, x_sb, x_sn, x_sc, cl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // 16-byte x loads where the base, the strides and (NCHW) N allow them
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && x_sb % 4 == 0 &&
                   (cl ? x_sn % 4 == 0 : x_sc % 4 == 0 && N % 4 == 0);
  const int bm = N > 64 ? 128 : 64;
  // small images: split the channel sum until the blocks would pass one an SM
  int split = 1;
  if (bm == 64) {
    const long long tiles = static_cast<long long>((N + 63) / 64) * (Cout / BN) * B;
    while (split < MAX_SPLIT && tiles * split * 2 <= sm_count() && C % (2 * split * KC) == 0) split *= 2;
  }
  const float* xf = static_cast<const float*>(x);
  const float* args[5] = {static_cast<const float*>(stats), static_cast<const float*>(gamma),
                          static_cast<const float*>(beta), static_cast<const float*>(w),
                          static_cast<const float*>(bias)};
  float* o = static_cast<float*>(out);
  if (bm == 128)
    err = vec ? launch_proj<128, true>(xf, args[0], args[1], args[2], args[3], args[4], o, B, N, C, Cout, x_sb, x_sn,
                                       x_sc, flags, split, s)
              : launch_proj<128, false>(xf, args[0], args[1], args[2], args[3], args[4], o, B, N, C, Cout, x_sb, x_sn,
                                        x_sc, flags, split, s);
  else
    err = vec ? launch_proj<64, true>(xf, args[0], args[1], args[2], args[3], args[4], o, B, N, C, Cout, x_sb, x_sn,
                                      x_sc, flags, split, s)
              : launch_proj<64, false>(xf, args[0], args[1], args[2], args[3], args[4], o, B, N, C, Cout, x_sb, x_sn,
                                       x_sc, flags, split, s);
  return (int)err;
}
