// flash_bwd_dq: the query gradient of non-causal softmax attention from the
// forward's logsumexp, for the UNet's long self-attention. Written for
// Hopper (sm_90a).
//
// Replaces diffmining_tpu/ops/flash_attention.py:573 _bwd_dq_kernel (via
// _bwd_pallas, :659). Arithmetic, step by step (flash_attention.py:583-606):
//   qs    = bf16(q * bf16(scale*log2e)),  lse2 = lse * log2e  (per q row)
//   s     = qs . k^T in fp32; keys past Lk get -1e30
//   p     = exp2(s - lse2)                 (no max: lse already normalises)
//   dp    = dO . v^T in fp32
//   ds    = bf16(p * (dp - delta))         (cast to k's dtype; delta =
//                                           sum(dO * o) per q row, fp32)
//   dq    = bf16((ds . k) * scale)
//
// What bounds it on an H100 SXM: at B4 H8 L4096 D40 one call is 1.3e11
// tensor FLOP (QK^T, dO.V^T, dS.K: 6 L^2 D per head), 0.130 ms at 989
// TFLOP/s; per logit an exp2, two subtracts and a multiply (2.1e9 fp32
// operations, 0.032 ms at 67 TFLOP/s); q, k, v, dO, dq, lse and delta are
// 52 MB, 0.016 ms at 3.35 TB/s. The tensor cores bound it.
//
// Design. On the TPU the k blocks are the sequential grid axis and dq
// accumulates in VMEM scratch across grid steps. Here each block owns a
// 64-row q tile and loops over all 64-key tiles itself, so dq never leaves
// registers and needs no atomics; the dk/dv kernel (flash_bwd_dkv.cu) is
// the k-outer twin. 4 warps, 16 q rows each; q (pre-scaled in place) and dO
// stay in shared memory for the whole loop and their A fragments are read
// per k-step, which keeps the registers for the fp32 dq accumulator
// (D=160: 80 a thread); K and V are double-buffered with cp.async; ds is
// re-packed as the A operand of ds.K in registers and K's B operand comes
// from ldmatrix.trans. mma.sync m16n8k16 throughout (wgmma later).
// Layout: q, k, v, dO, dq are [B, H, L, D] with arbitrary 16-byte-aligned
// strides (head dim contiguous); lse and delta are contiguous [B, H, Lq]
// fp32.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BLOCK_M = 64;
constexpr int BLOCK_N = 64;
constexpr int NUM_THREADS = 128;

template <int D_PAD>
__global__ void __launch_bounds__(NUM_THREADS)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int H, int Lq, int Lk, int D, long long q_sb, long long q_sh,
                        long long q_sl, long long k_sb, long long k_sh, long long k_sl, long long v_sb,
                        long long v_sh, long long v_sl, long long g_sb, long long g_sh, long long g_sl,
                        long long dq_sb, long long dq_sh, long long dq_sl, float q_scale, float scale) {
  constexpr int STRIDE = D_PAD + 8;
  constexpr int KSTEPS = D_PAD / 16;
  constexpr int DTILES = D_PAD / 8;
  constexpr int NTILES = BLOCK_N / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BLOCK_M][STRIDE]
  __nv_bfloat16* sG = sQ + BLOCK_M * STRIDE;                        // [BLOCK_M][STRIDE]
  __nv_bfloat16* sK = sG + BLOCK_M * STRIDE;                        // [2][BLOCK_N][STRIDE]
  __nv_bfloat16* sV = sK + 2 * BLOCK_N * STRIDE;                    // [2][BLOCK_N][STRIDE]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int m0 = blockIdx.x * BLOCK_M;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  const __nv_bfloat16* gb = g + b * g_sb + h * g_sh;
  __nv_bfloat16* dqb = dq + b * dq_sb + h * dq_sh;

  zero_pad<D_PAD, STRIDE, NUM_THREADS>(sQ, 2 * BLOCK_M + 4 * BLOCK_N, D, tid);

  const int n_tiles = (Lk + BLOCK_N - 1) / BLOCK_N;
  load_tile<BLOCK_M, STRIDE, NUM_THREADS>(sQ, qb, q_sl, m0, Lq, D, tid);
  load_tile<BLOCK_M, STRIDE, NUM_THREADS>(sG, gb, g_sl, m0, Lq, D, tid);
  cp_async_commit();
  load_tile<BLOCK_N, STRIDE, NUM_THREADS>(sK, kb, k_sl, 0, Lk, D, tid);
  load_tile<BLOCK_N, STRIDE, NUM_THREADS>(sV, vb, v_sl, 0, Lk, D, tid);
  cp_async_commit();

  const int r_lo = m0 + warp * 16 + gid;
  const int r_hi = r_lo + 8;
  const float* lb = lse + (long long)bh * Lq;
  const float* db = delta + (long long)bh * Lq;
  const float lse2_lo = r_lo < Lq ? lb[r_lo] * LOG2E : 0.f;
  const float lse2_hi = r_hi < Lq ? lb[r_hi] * LOG2E : 0.f;
  const float del_lo = r_lo < Lq ? db[r_lo] : 0.f;
  const float del_hi = r_hi < Lq ? db[r_hi] : 0.f;

  cp_async_wait<1>();  // q and dO have landed
  __syncthreads();
  prescale_tile<STRIDE, NUM_THREADS>(sQ, BLOCK_M, D, q_scale, tid);
  __syncthreads();

  const __nv_bfloat16* qw = sQ + warp * 16 * STRIDE;
  const __nv_bfloat16* gw = sG + warp * 16 * STRIDE;

  float acc[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<BLOCK_N, STRIDE, NUM_THREADS>(sK + (buf ^ 1) * BLOCK_N * STRIDE, kb, k_sl, (j + 1) * BLOCK_N, Lk, D,
                                              tid);
      load_tile<BLOCK_N, STRIDE, NUM_THREADS>(sV + (buf ^ 1) * BLOCK_N * STRIDE, vb, v_sl, (j + 1) * BLOCK_N, Lk, D,
                                              tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const __nv_bfloat16* kt = sK + buf * BLOCK_N * STRIDE;
    const __nv_bfloat16* vt = sV + buf * BLOCK_N * STRIDE;

    // s = qs . k^T and dp = dO . v^T for this warp's 16 rows and 64 keys
    float s[NTILES][4], dp[NTILES][4];
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t qa[4], ga[4];
      load_a<STRIDE>(qa, qw, kk, gid, tig);
      load_a<STRIDE>(ga, gw, kk, gid, tig);
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt) {
        uint32_t bfrag[2];
        load_b_rows<STRIDE>(bfrag, kt, nt * 8, kk, gid, tig);
        mma_bf16_16816(s[nt], qa, bfrag);
        load_b_rows<STRIDE>(bfrag, vt, nt * 8, kk, gid, tig);
        mma_bf16_16816(dp[nt], ga, bfrag);
      }
    }

    // ds = p * (dp - delta), p = exp2(s - lse2); keys past Lk: p = 0
    const int key0 = j * BLOCK_N;
    const bool ragged = key0 + BLOCK_N > Lk;
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool live = !ragged || key0 + nt * 8 + tig * 2 + (e & 1) < Lk;
        const float p = live ? ex2_ftz(s[nt][e] - (e < 2 ? lse2_lo : lse2_hi)) : 0.f;
        s[nt][e] = p * (dp[nt][e] - (e < 2 ? del_lo : del_hi));
      }
    }

    // acc += bf16(ds) . k
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      uint32_t da[4];
      pack_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt) {
        uint32_t bfrag[2];
        load_b_cols<STRIDE>(bfrag, kt, kk * 16, dt * 8, lane);
        mma_bf16_16816(acc[dt], da, bfrag);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt) {
    const int col = dt * 8 + tig * 2;
    if (dt * 8 < D) {
      if (r_lo < Lq)
        *reinterpret_cast<uint32_t*>(dqb + (long long)r_lo * dq_sl + col) =
            pack_bf16x2(acc[dt][0] * scale, acc[dt][1] * scale);
      if (r_hi < Lq)
        *reinterpret_cast<uint32_t*>(dqb + (long long)r_hi * dq_sl + col) =
            pack_bf16x2(acc[dt][2] * scale, acc[dt][3] * scale);
    }
  }
}

template <int D_PAD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g, const float* lse, const float* delta,
                   void* dq, int B, int H, int Lq, int Lk, int D, const long long* st, float q_scale, float scale,
                   cudaStream_t stream) {
  constexpr int STRIDE = D_PAD + 8;
  const int smem = (2 * BLOCK_M + 4 * BLOCK_N) * STRIDE * (int)sizeof(__nv_bfloat16);
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dq_kernel<D_PAD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + BLOCK_M - 1) / BLOCK_M, B * H);
  flash_bwd_dq_kernel<D_PAD><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(g), lse, delta,
      static_cast<__nv_bfloat16*>(dq), H, Lq, Lk, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[12], st[13], st[14], q_scale, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). strides: 15 element strides,
// (batch, head, row) for q, k, v, dO, dq in that order; lse and delta are
// contiguous [B, H, Lq] float32 buffers. Returns the CUDA error of the
// launch (0 on success); D must be 40, 80 or 160.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* g, const void* lse,
                            const void* delta, void* dq, int B, int H, int Lq, int Lk, int D,
                            const long long* strides, float q_scale, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (D) {
    case 40: return (int)launch<48>(q, k, v, g, l, dl, dq, B, H, Lq, Lk, D, strides, q_scale, scale, s);
    case 80: return (int)launch<80>(q, k, v, g, l, dl, dq, B, H, Lq, Lk, D, strides, q_scale, scale, s);
    case 160: return (int)launch<160>(q, k, v, g, l, dl, dq, B, H, Lq, Lk, D, strides, q_scale, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
