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
//   out = (sum over channels of h . w) + bias    the sum channel by channel
//
// What bounds it on an H100 SXM: 2 N C Cout fp32 operations an image for
// the projection (and 4 a normalised x element) against 67 TFLOP/s outside
// the tensor cores: at B8 N4096 C320 Cout320 6.7e9, 0.100 ms; x and out are
// 42 MB each, 0.025 ms at 3.35 TB/s. It is bound by its operations at every
// SpatialTransformer entry of a 512 px pass.
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
// The projection (gn_proj_f32_kernel; a simple kernel that is right
// first): one block of 256 threads a (64 pixels, 64 output channels,
// image). It stages each channel's (mean, rsig, gamma, beta) in shared
// memory, then walks C in chunks of 32 channels: the x chunk is loaded
// along whichever axis is contiguous (pixels for NCHW x, channels for
// channels-last x), normalised once into a [32 channels x 64 pixels] tile,
// the w chunk ([Cout, C] rows) into a [32 x 64 outputs] tile, and each
// thread accumulates a 4 x 4 block of the output (pixels 4ty + i, outputs
// 4tx + j) with two 16-byte shared reads a channel.
// Layout: x is [B, N, C] with element strides x_sb, x_sn, x_sc, of which
// x_sn or x_sc is 1; stats [B, 2, C] fp32 (written here); gamma, beta [C],
// w [Cout, C] and bias [Cout] fp32 contiguous; out [B, N, Cout] fp32
// contiguous. C must be a multiple of 32 and of G, Cout of 64.

#include <cuda_runtime.h>

namespace {

constexpr int STATS_THREADS = 512;
constexpr int STATS_UNROLL = 4;  // runs a thread loads at once and merges as one
constexpr int THREADS = 256;     // 16 x 16
constexpr int BM = 64;           // pixels a block
constexpr int BN = 64;           // output channels a block
constexpr int KC = 32;           // input channels a chunk
constexpr int SH = BM + 4;       // row stride of the h and w tiles
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

__global__ void __launch_bounds__(THREADS)
    gn_proj_f32_kernel(const float* __restrict__ x, const float* __restrict__ stats, const float* __restrict__ gamma,
                       const float* __restrict__ beta, const float* __restrict__ w, const float* __restrict__ bias,
                       float* __restrict__ out, int N, int C, int Cout, long long x_sb, long long x_sn, long long x_sc,
                       int flags) {
  extern __shared__ float4 smem4[];
  float4* sparam = smem4;                                  // [C]: mean, rsig, gamma, beta
  float* sh = reinterpret_cast<float*>(smem4 + C);         // [KC][SH]: h, channel-major
  float* sw = sh + KC * SH;                                // [KC][SH]: w, channel-major
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n0 = blockIdx.x * BM, co0 = blockIdx.y * BN, b = blockIdx.z;
  const bool silu = flags & SILU;
  const bool cl = x_sc == 1;
  const float* xb = x + b * x_sb;
  const float* sb = stats + static_cast<long long>(b) * 2 * C;

  for (int c = tid; c < C; c += THREADS) sparam[c] = make_float4(sb[c], sb[C + c], gamma[c], beta[c]);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += KC) {
    __syncthreads();  // the parameters are staged; the last chunk's tiles are free
#pragma unroll
    for (int it = 0; it < BM * KC / THREADS; ++it) {
      const int f = tid + it * THREADS;
      // along the contiguous axis: pixels for NCHW x, channels for channels-last x
      const int px = cl ? f / KC : f % BM, c = cl ? f % KC : f / BM;
      const int n = n0 + px;
      float h = 0.f;  // pixels past N: zeros, never stored
      if (n < N) h = normalise(__ldg(xb + n * x_sn + (c0 + c) * x_sc), sparam[c0 + c], silu);
      sh[c * SH + px] = h;
    }
#pragma unroll
    for (int it = 0; it < BN * KC / THREADS; ++it) {
      const int f = tid + it * THREADS, co = f / KC, c = f % KC;
      sw[c * SH + co] = __ldg(w + static_cast<long long>(co0 + co) * C + c0 + c);
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < KC; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(sh + c * SH + 4 * ty);
      const float4 bw = *reinterpret_cast<const float4*>(sw + c * SH + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {bw.x, bw.y, bw.z, bw.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  float bs[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) bs[j] = bias[co0 + 4 * tx + j];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + 4 * ty + i;
    if (n >= N) continue;
    *reinterpret_cast<float4*>(out + (static_cast<long long>(b) * N + n) * Cout + co0 + 4 * tx) =
        make_float4(acc[i][0] + bs[0], acc[i][1] + bs[1], acc[i][2] + bs[2], acc[i][3] + bs[3]);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes): the statistics kernel, then the
// projection kernel. flags: 1 = SiLU. Returns the CUDA error of the launches
// (0 on success).
extern "C" int gn_act_proj_f32(const void* x, void* stats, const void* gamma, const void* beta, const void* w,
                               const void* bias, void* out, int B, int N, int C, int Cout, int G, float eps,
                               long long x_sb, long long x_sn, long long x_sc, int flags, void* stream) {
  if (B <= 0 || N <= 0 || B > 65535 || G <= 0 || C % G != 0 || C % KC != 0 || Cout % BN != 0 ||
      (x_sn != 1 && x_sc != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool cl = x_sc == 1;
  gn_stats_f32_kernel<<<dim3(G, B), STATS_THREADS, 0, s>>>(static_cast<const float*>(x), static_cast<float*>(stats),
                                                          N, C, G, eps, x_sb, x_sn, x_sc, cl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = size_t(C) * sizeof(float4) + 2 * size_t(KC) * SH * sizeof(float);
  err = cudaFuncSetAttribute(gn_proj_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BM - 1) / BM, Cout / BN, B);
  gn_proj_f32_kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(stats), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(out), N, C, Cout, x_sb, x_sn, x_sc, flags);
  return (int)cudaGetLastError();
}
