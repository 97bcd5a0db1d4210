// gn_act_proj: GroupNorm from precomputed statistics, an optional SiLU and
// the 1x1 projection in one pass, for the entry of every SpatialTransformer
// of the UNet without grad (DIFFMINING_FUSED_NORM=1). Written for Hopper
// (sm_90a).
//
// Replaces diffmining_tpu/ops/fused_norm.py:27 _gn_act_matmul_kernel (via
// gn_act_proj, :44). As there, the per-(batch, group) mean and rsigma are
// computed outside the kernel (fp32) and handed in per channel; the kernel
// never writes the normalised activations to device memory.
//
// Arithmetic, matching the TPU kernel and the plain version
// (ops/fused_norm.py gn_act_proj_plain) step by step:
//   h   = ((x - mean) * rsig) * gamma + beta     fp32, each step rounded
//                                                (no FMA contraction, as the
//                                                plain version's torch ops)
//   h   = h * (1 / (1 + exp(-h)))                only with act="silu"
//   hb  = bf16(h)                                (cast to w's dtype)
//   out = bf16(hb . w) accumulated in fp32; then bf16(out + bias), the bias
//         added in the output dtype as the TPU kernel's caller does (:103)
//
// What bounds it on an H100 SXM: at B8 N4096 C320 Cout320 (the 512px level-0
// entry) x and out are 21 MB each and w 0.2 MB: 12.6 us at 3.35 TB/s,
// against 6.7 GFLOP on the tensor cores, 6.8 us at 989 TFLOP/s; the
// prologue is 4-5 fp32 operations per x element (0.1 GFLOP). Memory bounds
// it, and would at every level of the UNet (N 4096/1024/256/64 at C
// 320/640/1280/1280). The design reads x once per 64-wide slice of output
// channels from L2 (not once overall: a later PR can keep the normalised
// tile in shared memory across all of Cout) and writes the output once.
//
// Design (simple first):
//   * one block of 4 warps per (64 pixels, 64 output channels, image); a loop
//     over 32-channel chunks of the input inside the block;
//   * the port's UNet is NCHW, but a transformer's exit (proj_out on the
//     [B, H, W, C] blocks' output) hands channels-last tensors on to the
//     layers after it, so the A operand [pixels, channels] of one image
//     comes in either layout, and the kernel takes both (a template flag):
//     - pixels contiguous (NCHW): A is column-major. Each chunk is staged as
//       [32 channels][64 pixels] in shared memory, 16-byte loads along the
//       pixels, and the A fragments are read with ldmatrix.trans, which
//       transposes the 8x8 sub-tiles into mma.sync's row-major A layout;
//     - channels contiguous (channels-last): A is row-major, staged as [64
//       pixels][32 channels] with 16-byte loads along the channels, the
//       chunk's per-channel statistics and gamma/beta in shared memory, and
//       the A fragments read as plain 32-bit shared loads;
//     either way the normalise (and SiLU) is applied on the way in and h
//     rounded to bf16;
//   * w is the conv weight [Cout, C] (input channels contiguous), staged as
//     [64 out channels][32 in channels]: that is mma.sync's column-major B;
//   * mma.sync m16n8k16 bf16 with fp32 accumulators, 32x32 outputs a warp;
//   * the ragged pixel tail (N = 64 at the mid block, any odd N) is masked
//     on load and store; a stride that is not a multiple of 8 takes element
//     loads instead of 16-byte ones.
// Layout: x is [B, N, C] with element strides x_sb, x_sn, x_sc, of which
// x_sn or x_sc is 1; mean and rsig [B, C] and gamma, beta [C] fp32
// contiguous; w [Cout, C] and bias [Cout] bf16 contiguous; out [B, N, Cout]
// bf16 contiguous. C must be a multiple of 32 and Cout of 64.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BM = 64;       // pixels per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 32;       // input channels per chunk
constexpr int THREADS = 128;
constexpr int SA = BM + 8;   // row stride of the pixels-contiguous sA [BK][SA] (conflict-free ldmatrix rows)
constexpr int SAR = BK + 8;  // row stride of the channels-contiguous sA [BM][SAR] (conflict-free fragment loads)
constexpr int SW = BK + 8;   // row stride of sW [BN][SW] (conflict-free fragment loads)

__device__ __forceinline__ float normalize(float x, float mean, float rsig, float gamma, float beta, bool silu) {
  float h = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), rsig), gamma), beta);
  if (silu) h = __fmul_rn(h, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-h))));
  return h;
}

// The A fragment (16 pixels x 16 channels, row-major) of a [channels][pixels]
// shared tile: lanes 8i..8i+7 address the 8 rows of sub-matrix i (i = 0: k
// 0-7 / m 0-7, 1: k 0-7 / m 8-15, 2: k 8-15 / m 0-7, 3: k 8-15 / m 8-15),
// and .trans hands each thread the transposed elements.
__device__ __forceinline__ void load_a_trans(uint32_t* a, const __nv_bfloat16* tile, int k0, int m0, int lane) {
  const int k = k0 + (lane & 7) + ((lane >> 4) & 1) * 8;
  const int m = m0 + ((lane >> 3) & 1) * 8;
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(tile + k * SA + m));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s));
}

template <bool SILU, bool CH_CONTIG>
__global__ void __launch_bounds__(THREADS)
    gn_act_proj_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ mean,
                       const float* __restrict__ rsig, const float* __restrict__ gamma,
                       const float* __restrict__ beta, const __nv_bfloat16* __restrict__ w,
                       const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out, int N, int C,
                       int Cout, long long x_sb, long long x_sn, long long x_sc, bool vec) {
  __shared__ __align__(16) __nv_bfloat16 sA[CH_CONTIG ? BM * SAR : BK * SA];
  __shared__ __align__(16) __nv_bfloat16 sW[BN * SW];
  __shared__ float sP[4][BK];  // the chunk's mean, rsig, gamma, beta (channels-contiguous staging)

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wm = warp & 1;   // the warp's 32 pixels of the block's 64
  const int wn = warp >> 1;  // the warp's 32 output channels of the block's 64
  const int n0 = blockIdx.x * BM;
  const int co0 = blockIdx.y * BN;
  const int b = blockIdx.z;

  const __nv_bfloat16* xb = x + b * x_sb;
  const float* mb = mean + (long long)b * C;
  const float* rb = rsig + (long long)b * C;

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  for (int c0 = 0; c0 < C; c0 += BK) {
    if constexpr (CH_CONTIG) {
      // A: 64 pixels x 32 channels, 8 channels a step, normalised on the way in
      static_assert(4 * BK == THREADS, "one parameter a thread");
      {
        const float* src[4] = {mb, rb, gamma, beta};
        sP[tid / BK][tid % BK] = src[tid / BK][c0 + tid % BK];
      }
      __syncthreads();
      for (int i = tid; i < BM * (BK / 8); i += THREADS) {
        const int p = i / (BK / 8);
        const int kc = (i - p * (BK / 8)) * 8;
        uint32_t hv[4] = {0u, 0u, 0u, 0u};  // pixels past N stay zero (their output rows are never stored)
        if (n0 + p < N) {
          const __nv_bfloat16* src = xb + (long long)(n0 + p) * x_sn + c0 + kc;
          float xv[8];
          if (vec) {
            const uint4 u = *reinterpret_cast<const uint4*>(src);
            const uint32_t uu[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = unpack_bf16x2(uu[e]);
              xv[2 * e] = f.x;
              xv[2 * e + 1] = f.y;
            }
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) xv[e] = __bfloat162float(src[(long long)e * x_sc]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k0 = kc + 2 * e, k1 = k0 + 1;
            hv[e] = pack_bf16x2(normalize(xv[2 * e], sP[0][k0], sP[1][k0], sP[2][k0], sP[3][k0], SILU),
                                normalize(xv[2 * e + 1], sP[0][k1], sP[1][k1], sP[2][k1], sP[3][k1], SILU));
          }
        }
        *reinterpret_cast<uint4*>(sA + p * SAR + kc) = make_uint4(hv[0], hv[1], hv[2], hv[3]);
      }
    } else {
      // A: 32 channels x 64 pixels, 8 pixels a step, normalised on the way in
      for (int i = tid; i < BK * (BM / 8); i += THREADS) {
        const int r = i / (BM / 8);
        const int p = (i - r * (BM / 8)) * 8;
        const int c = c0 + r;
        const float mu = mb[c], rs = rb[c], ga = gamma[c], be = beta[c];
        const __nv_bfloat16* src = xb + (long long)c * x_sc + n0 + p;
        float xv[8];
        if (vec && n0 + p + 8 <= N) {
          const uint4 u = *reinterpret_cast<const uint4*>(src);
          const uint32_t uu[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = unpack_bf16x2(uu[e]);
            xv[2 * e] = f.x;
            xv[2 * e + 1] = f.y;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) xv[e] = n0 + p + e < N ? __bfloat162float(src[(long long)e * x_sn]) : 0.f;
        }
        uint32_t hv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // pixels past N stay zero (their output rows are never stored)
          const float h0 = n0 + p + 2 * e < N ? normalize(xv[2 * e], mu, rs, ga, be, SILU) : 0.f;
          const float h1 = n0 + p + 2 * e + 1 < N ? normalize(xv[2 * e + 1], mu, rs, ga, be, SILU) : 0.f;
          hv[e] = pack_bf16x2(h0, h1);
        }
        *reinterpret_cast<uint4*>(sA + r * SA + p) = make_uint4(hv[0], hv[1], hv[2], hv[3]);
      }
    }
    // B: 64 output channels x 32 input channels of w [Cout, C]
    for (int i = tid; i < BN * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8);
      const int kc = (i - r * (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(sW + r * SW + kc) =
          *reinterpret_cast<const uint4*>(w + (long long)(co0 + r) * C + c0 + kc);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if constexpr (CH_CONTIG)
          load_a<SAR>(af[mt], sA + (wm * 32 + mt * 16) * SAR, kk, gid, tig);
        else
          load_a_trans(af[mt], sA, kk * 16, wm * 32 + mt * 16, lane);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t bf[2];
        load_b_rows<SW>(bf, sW, wn * 32 + nt * 8, kk, gid, tig);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16_16816(acc[mt][nt], af[mt], bf);
      }
    }
    __syncthreads();  // every warp is done with the tiles before the next chunk overwrites them
  }

  // epilogue: round to bf16, add the bias in bf16, store [B, N, Cout]
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = co0 + wn * 32 + nt * 8 + tig * 2;
    const float2 bv = unpack_bf16x2(lds32(bias + col));
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int row = n0 + wm * 32 + mt * 16 + gid;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rr = row + half * 8;
        if (rr < N) {
          const float2 o = unpack_bf16x2(pack_bf16x2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]));
          *reinterpret_cast<uint32_t*>(out + ((long long)b * N + rr) * Cout + col) =
              pack_bf16x2(o.x + bv.x, o.y + bv.y);
        }
      }
    }
  }
}

template <bool SILU, bool CH_CONTIG>
void launch(const void* x, const void* mean, const void* rsig, const void* gamma, const void* beta, const void* w,
            const void* bias, void* out, int B, int N, int C, int Cout, long long x_sb, long long x_sn,
            long long x_sc, bool vec, cudaStream_t s) {
  const dim3 grid((N + BM - 1) / BM, Cout / BN, B);
  gn_act_proj_kernel<SILU, CH_CONTIG><<<grid, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(mean), static_cast<const float*>(rsig),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), N, C, Cout, x_sb, x_sn, x_sc, vec);
}

}  // namespace

// Plain C entry point (loaded with ctypes). x [B, N, C] bf16 with element
// strides x_sb, x_sn, x_sc, of which x_sn (pixels contiguous, the NCHW
// activations) or x_sc (channels contiguous) is 1; mean, rsig [B, C],
// gamma, beta [C] float32; w [Cout, C], bias [Cout] bf16; out [B, N, Cout]
// bf16. Returns the CUDA error of the launch (0 on success); C must be a
// multiple of 32 and Cout of 64.
extern "C" int gn_act_proj(const void* x, const void* mean, const void* rsig, const void* gamma, const void* beta,
                           const void* w, const void* bias, void* out, int B, int N, int C, int Cout,
                           long long x_sb, long long x_sn, long long x_sc, int silu, void* stream) {
  if (C % BK != 0 || Cout % BN != 0 || N <= 0 || B <= 0 || (x_sn != 1 && x_sc != 1))
    return (int)cudaErrorInvalidValue;
  const bool ch_contig = x_sc == 1;
  const long long other = ch_contig ? x_sn : x_sc;
  const bool vec = x_sb % 8 == 0 && other % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (silu && ch_contig)
    launch<true, true>(x, mean, rsig, gamma, beta, w, bias, out, B, N, C, Cout, x_sb, x_sn, x_sc, vec, s);
  else if (silu)
    launch<true, false>(x, mean, rsig, gamma, beta, w, bias, out, B, N, C, Cout, x_sb, x_sn, x_sc, vec, s);
  else if (ch_contig)
    launch<false, true>(x, mean, rsig, gamma, beta, w, bias, out, B, N, C, Cout, x_sb, x_sn, x_sc, vec, s);
  else
    launch<false, false>(x, mean, rsig, gamma, beta, w, bias, out, B, N, C, Cout, x_sb, x_sn, x_sc, vec, s);
  return (int)cudaGetLastError();
}
