// flash_fwd_lse: non-causal softmax(q.k^T * scale).v with the running max,
// that also writes the per-row natural-log logsumexp, for the UNet's long
// self-attention under differentiation. Written for Hopper (sm_90a).
//
// Replaces diffmining_tpu/ops/flash_attention.py:37 _flash_kernel (via
// _flash_forward(..., return_lse=True), :142): the forward rule of the
// custom_vjp, whose lse the backward kernels (flash_bwd_dq.cu,
// flash_bwd_dkv.cu) re-form the softmax from.
//
// Arithmetic, matching the TPU kernel step by step (flash_attention.py:59-87):
//   qs    = bf16(q * bf16(scale*log2e))               (the pre-scale, q's dtype)
//   s     = qs . k^T in fp32; keys past Lk get -1e30
//   m_new = max(m, rowmax(s)), alpha = exp2(m - m_new), m starts at -1e30
//   p     = exp2(s - m_new); pb = bf16(p)             (cast to v's dtype)
//   acc   = acc * alpha + pb . v,  l = l * alpha + sum pb   (l = the ones column)
//   o     = bf16(acc * (1 / max(l, 1e-30)))
//   lse   = m * ln2 + log(max(l, 1e-30))              (natural log, fp32)
// The running max is taken per 64-key tile here and per 1024-key block on
// the TPU, so p is rounded to bf16 relative to a different max: the output
// agrees with the TPU kernel to a bf16 ulp or two, and exactly with the
// plain version run at block_k=64 up to summation order.
//
// What bounds it on an H100 SXM: at B4 H8 L4096 D40 one call is 8.6e10
// tensor FLOP (QK^T and PV), 0.087 ms at the dense bf16 rate of 989
// TFLOP/s; per logit it adds a max, a subtract, an exp2 and a sum (5.4e8
// logits: 2.1e9 fp32 operations, 0.032 ms at 67 TFLOP/s; the exp2 alone is
// ~0.13 ms on the SFUs at 16 per clock per SM); q, k, v, o and lse are 42
// MB, 0.013 ms at 3.35 TB/s. The tensor-core and SFU work bound it. The
// design keeps one exp2 per logit (plus one per row per tile for alpha),
// folds log2e into q, and masks only the ragged last tile.
//
// Design (simple first; wgmma, TMA and warp specialisation come later), the
// structure of flash_fwd_nomax.cu plus the online softmax:
//   * one block of 4 warps per (batch*head, 64-row q tile); each warp owns
//     16 q rows and keeps its q fragments in registers for the whole loop;
//   * a loop over 64-key tiles inside the block (the TPU's sequential k
//     grid axis); K and V double-buffered in shared memory with cp.async;
//   * QK^T and PV with mma.sync m16n8k16; the row max is reduced over the
//     4 threads of a quad with shuffles; p is re-packed as PV's A operand
//     in registers; the head dim is zero-padded in shared memory to a
//     multiple of 16 (40 -> 48).
// Layout: q, k, v, o are [B, H, L, D] with arbitrary 16-byte-aligned
// element strides for B, H and L (head dim contiguous); lse is a contiguous
// [B, H, Lq] fp32 tensor.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BLOCK_M = 64;
constexpr int BLOCK_N = 64;
constexpr int NUM_THREADS = 128;

template <int D_PAD>
__global__ void __launch_bounds__(NUM_THREADS)
    flash_fwd_lse_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int H, int Lq, int Lk, int D, long long q_sb, long long q_sh,
                         long long q_sl, long long k_sb, long long k_sh, long long k_sl, long long v_sb,
                         long long v_sh, long long v_sl, long long o_sb, long long o_sh, long long o_sl,
                         float q_scale) {
  constexpr int STRIDE = D_PAD + 8;
  constexpr int KSTEPS = D_PAD / 16;
  constexpr int DTILES = D_PAD / 8;
  constexpr int NTILES = BLOCK_N / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BLOCK_M][STRIDE]
  __nv_bfloat16* sK = sQ + BLOCK_M * STRIDE;                        // [2][BLOCK_N][STRIDE]
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
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;

  zero_pad<D_PAD, STRIDE, NUM_THREADS>(sQ, BLOCK_M + 4 * BLOCK_N, D, tid);

  const int n_tiles = (Lk + BLOCK_N - 1) / BLOCK_N;
  load_tile<BLOCK_M, STRIDE, NUM_THREADS>(sQ, qb, q_sl, m0, Lq, D, tid);
  cp_async_commit();
  load_tile<BLOCK_N, STRIDE, NUM_THREADS>(sK, kb, k_sl, 0, Lk, D, tid);
  load_tile<BLOCK_N, STRIDE, NUM_THREADS>(sV, vb, v_sl, 0, Lk, D, tid);
  cp_async_commit();

  cp_async_wait<1>();  // the q tile has landed
  __syncthreads();
  prescale_tile<STRIDE, NUM_THREADS>(sQ, BLOCK_M, D, q_scale, tid);
  __syncthreads();

  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) load_a<STRIDE>(qf[kk], sQ + warp * 16 * STRIDE, kk, gid, tig);

  float acc[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  // running max (base 2; equal across the quad) and partial denominators
  // (this thread's columns) of rows gid and gid+8
  float m_lo = NEG_INF, m_hi = NEG_INF;
  float l_lo = 0.f, l_hi = 0.f;

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

    float s[NTILES][4];
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t bfrag[2];
        load_b_rows<STRIDE>(bfrag, kt, nt * 8, kk, gid, tig);
        mma_bf16_16816(s[nt], qf[kk], bfrag);
      }
    }

    const int key0 = j * BLOCK_N;
    if (key0 + BLOCK_N > Lk) {
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + nt * 8 + tig * 2 + (e & 1) >= Lk) s[nt][e] = NEG_INF;
    }

    // the tile's row max, over the quad that holds the row
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float alpha_lo = ex2_ftz(m_lo - mx_lo);
    const float alpha_hi = ex2_ftz(m_hi - mx_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;

#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
      s[nt][0] = ex2_ftz(s[nt][0] - m_lo);
      s[nt][1] = ex2_ftz(s[nt][1] - m_lo);
      s[nt][2] = ex2_ftz(s[nt][2] - m_hi);
      s[nt][3] = ex2_ftz(s[nt][3] - m_hi);
    }
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      acc[dt][0] *= alpha_lo;
      acc[dt][1] *= alpha_lo;
      acc[dt][2] *= alpha_hi;
      acc[dt][3] *= alpha_hi;
    }
    l_lo *= alpha_lo;
    l_hi *= alpha_hi;

    // p rounded to bf16 as PV's A operand; l sums the ROUNDED p, as the
    // ones column of the TPU kernel's PV product does
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      uint32_t pf[4];
      pack_a(pf, s[2 * kk], s[2 * kk + 1]);
      const float2 a0 = unpack_bf16x2(pf[0]);
      const float2 a1 = unpack_bf16x2(pf[1]);
      const float2 a2 = unpack_bf16x2(pf[2]);
      const float2 a3 = unpack_bf16x2(pf[3]);
      l_lo += (a0.x + a0.y) + (a2.x + a2.y);
      l_hi += (a1.x + a1.y) + (a3.x + a3.y);
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt) {
        uint32_t bfrag[2];
        load_b_cols<STRIDE>(bfrag, vt, kk * 16, dt * 8, lane);
        mma_bf16_16816(acc[dt], pf, bfrag);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float ls_lo = fmaxf(l_lo, 1e-30f);
  const float ls_hi = fmaxf(l_hi, 1e-30f);
  const float inv_lo = 1.0f / ls_lo;
  const float inv_hi = 1.0f / ls_hi;

  const int r_lo = m0 + warp * 16 + gid;
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt) {
    const int col = dt * 8 + tig * 2;
    if (dt * 8 < D) {
      if (r_lo < Lq)
        *reinterpret_cast<uint32_t*>(ob + (long long)r_lo * o_sl + col) =
            pack_bf16x2(acc[dt][0] * inv_lo, acc[dt][1] * inv_lo);
      if (r_hi < Lq)
        *reinterpret_cast<uint32_t*>(ob + (long long)r_hi * o_sl + col) =
            pack_bf16x2(acc[dt][2] * inv_hi, acc[dt][3] * inv_hi);
    }
  }
  if (tig == 0) {
    float* lb = lse + (long long)bh * Lq;
    if (r_lo < Lq) lb[r_lo] = m_lo * LN2 + logf(ls_lo);
    if (r_hi < Lq) lb[r_hi] = m_hi * LN2 + logf(ls_hi);
  }
}

template <int D_PAD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int Lq, int Lk,
                   int D, const long long* st, float q_scale, cudaStream_t stream) {
  constexpr int STRIDE = D_PAD + 8;
  const int smem = (BLOCK_M + 4 * BLOCK_N) * STRIDE * (int)sizeof(__nv_bfloat16);
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_lse_kernel<D_PAD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + BLOCK_M - 1) / BLOCK_M, B * H);
  flash_fwd_lse_kernel<D_PAD><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, H, Lq, Lk, D, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], q_scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). strides: 12 element strides,
// (batch, head, row) for q, k, v, o in that order; lse is a contiguous
// [B, H, Lq] float32 buffer. Returns the CUDA error of the launch (0 on
// success); D must be 40, 80 or 160.
extern "C" int flash_fwd_lse(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Lq,
                             int Lk, int D, const long long* strides, float q_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 40: return (int)launch<48>(q, k, v, o, l, B, H, Lq, Lk, D, strides, q_scale, s);
    case 80: return (int)launch<80>(q, k, v, o, l, B, H, Lq, Lk, D, strides, q_scale, s);
    case 160: return (int)launch<160>(q, k, v, o, l, B, H, Lq, Lk, D, strides, q_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
