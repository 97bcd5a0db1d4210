// flash_bwd_dkv: the key and value gradients of non-causal softmax
// attention from the forward's logsumexp, for the UNet's long self-attention.
// Written for Hopper (sm_90a).
//
// Replaces diffmining_tpu/ops/flash_attention.py:609 _bwd_dkv_kernel (via
// _bwd_pallas, :659). Arithmetic, step by step (flash_attention.py:620-650):
//   qs    = bf16(q * bf16(scale*log2e)),  lse2 = lse * log2e  (per q row)
//   s     = qs . k^T in fp32;  p = exp2(s - lse2);  q rows past Lq: p = 0
//   dv   += bf16(p)^T . dO                     (p cast to dO's dtype)
//   dp    = dO . v^T in fp32
//   ds    = bf16(p * (dp - delta))             (cast to q's dtype)
//   dk   += ds^T . qs
//   dk    = bf16(dk * ln2), dv = bf16(dv)      (ln2 undoes the log2e in qs)
//
// What bounds it on an H100 SXM: at B4 H8 L4096 D40 one call is 1.7e11
// tensor FLOP (S, dP, dV, dK: 8 L^2 D per head), 0.174 ms at 989 TFLOP/s;
// per logit an exp2, two subtracts and a multiply (2.1e9 fp32 operations,
// 0.032 ms at 67 TFLOP/s); q, k, v, dO, dk, dv, lse and delta are 63 MB,
// 0.019 ms at 3.35 TB/s. The tensor cores bound it.
//
// Design. On the TPU the q blocks are the sequential grid axis and dk/dv
// accumulate in VMEM scratch. Here each block owns 64 keys and loops over
// all q tiles itself: dk and dv stay in registers and no atomics are
// needed (the dq kernel, flash_bwd_dq.cu, is the q-outer twin). Each of 4
// warps owns 16 keys and computes the transposed products (s^T = k.qs^T,
// dp^T = v.dO^T), so p^T and ds^T are already in the A-operand layout of
// dv += p^T.dO and dk += ds^T.qs and never leave registers; the per-q-row
// lse and delta are staged in shared memory beside each q tile. K and V
// stay in shared memory (A fragments read per k-step); q and dO tiles are
// double-buffered with cp.async, q pre-scaled in place once per tile.
// Register pressure: the two fp32 accumulators are 2 * D_PAD / 2 registers
// a thread (160 at D=160), so at D=160 the q tile shrinks from 64 rows to
// 32, halving the s^T and dp^T fragments (64 -> 32 registers).
// Layout: q, k, v, dO, dk, dv are [B, H, L, D] with arbitrary 16-byte-
// aligned strides (head dim contiguous); lse and delta are contiguous
// [B, H, Lq] fp32.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BLOCK_N = 64;  // keys per block
constexpr int NUM_THREADS = 128;

template <int D_PAD, int BLOCK_Q>
__global__ void __launch_bounds__(NUM_THREADS)
    flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H, int Lq, int Lk, int D,
                         long long q_sb, long long q_sh, long long q_sl, long long k_sb, long long k_sh,
                         long long k_sl, long long v_sb, long long v_sh, long long v_sl, long long g_sb,
                         long long g_sh, long long g_sl, long long dk_sb, long long dk_sh, long long dk_sl,
                         long long dv_sb, long long dv_sh, long long dv_sl, float q_scale) {
  constexpr int STRIDE = D_PAD + 8;
  constexpr int KSTEPS = D_PAD / 16;
  constexpr int DTILES = D_PAD / 8;
  constexpr int QTILES = BLOCK_Q / 8;  // n-tiles of s^T over the q rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BLOCK_N][STRIDE]
  __nv_bfloat16* sV = sK + BLOCK_N * STRIDE;                        // [BLOCK_N][STRIDE]
  __nv_bfloat16* sQ = sV + BLOCK_N * STRIDE;                        // [2][BLOCK_Q][STRIDE]
  __nv_bfloat16* sG = sQ + 2 * BLOCK_Q * STRIDE;                    // [2][BLOCK_Q][STRIDE]
  float* sL = reinterpret_cast<float*>(sG + 2 * BLOCK_Q * STRIDE);  // [2][BLOCK_Q] lse * log2e
  float* sD = sL + 2 * BLOCK_Q;                                     // [2][BLOCK_Q] delta

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int n0 = blockIdx.x * BLOCK_N;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  const __nv_bfloat16* gb = g + b * g_sb + h * g_sh;
  const float* lb = lse + (long long)bh * Lq;
  const float* db = delta + (long long)bh * Lq;

  zero_pad<D_PAD, STRIDE, NUM_THREADS>(sK, 2 * BLOCK_N + 4 * BLOCK_Q, D, tid);

  auto stage_q_tile = [&](int i, int buf) {
    const int r0 = i * BLOCK_Q;
    load_tile<BLOCK_Q, STRIDE, NUM_THREADS>(sQ + buf * BLOCK_Q * STRIDE, qb, q_sl, r0, Lq, D, tid);
    load_tile<BLOCK_Q, STRIDE, NUM_THREADS>(sG + buf * BLOCK_Q * STRIDE, gb, g_sl, r0, Lq, D, tid);
    if (tid < BLOCK_Q) {
      const bool valid = r0 + tid < Lq;
      sL[buf * BLOCK_Q + tid] = valid ? lb[r0 + tid] * LOG2E : 0.f;
      sD[buf * BLOCK_Q + tid] = valid ? db[r0 + tid] : 0.f;
    }
  };

  const int n_tiles = (Lq + BLOCK_Q - 1) / BLOCK_Q;
  load_tile<BLOCK_N, STRIDE, NUM_THREADS>(sK, kb, k_sl, n0, Lk, D, tid);
  load_tile<BLOCK_N, STRIDE, NUM_THREADS>(sV, vb, v_sl, n0, Lk, D, tid);
  cp_async_commit();
  stage_q_tile(0, 0);
  cp_async_commit();

  const __nv_bfloat16* kw = sK + warp * 16 * STRIDE;
  const __nv_bfloat16* vw = sV + warp * 16 * STRIDE;

  float dk_acc[DTILES][4], dv_acc[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt) {
    dk_acc[dt][0] = dk_acc[dt][1] = dk_acc[dt][2] = dk_acc[dt][3] = 0.f;
    dv_acc[dt][0] = dv_acc[dt][1] = dv_acc[dt][2] = dv_acc[dt][3] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < n_tiles) stage_q_tile(i + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // K, V and q tile i have landed
    __syncthreads();
    __nv_bfloat16* qt = sQ + buf * BLOCK_Q * STRIDE;
    const __nv_bfloat16* gt = sG + buf * BLOCK_Q * STRIDE;
    const float* lt = sL + buf * BLOCK_Q;
    const float* dlt = sD + buf * BLOCK_Q;
    prescale_tile<STRIDE, NUM_THREADS>(qt, BLOCK_Q, D, q_scale, tid);
    __syncthreads();

    // s^T = k . qs^T and dp^T = v . dO^T for this warp's 16 keys
    float st[QTILES][4], dpt[QTILES][4];
#pragma unroll
    for (int nt = 0; nt < QTILES; ++nt) {
      st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
      dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t ka[4], va[4];
      load_a<STRIDE>(ka, kw, kk, gid, tig);
      load_a<STRIDE>(va, vw, kk, gid, tig);
#pragma unroll
      for (int nt = 0; nt < QTILES; ++nt) {
        uint32_t bfrag[2];
        load_b_rows<STRIDE>(bfrag, qt, nt * 8, kk, gid, tig);
        mma_bf16_16816(st[nt], ka, bfrag);
        load_b_rows<STRIDE>(bfrag, gt, nt * 8, kk, gid, tig);
        mma_bf16_16816(dpt[nt], va, bfrag);
      }
    }

    // p^T = exp2(s^T - lse2[q]) and ds^T = p^T * (dp^T - delta[q]); q rows
    // past Lq get p = 0
    const int q0 = i * BLOCK_Q;
    const bool ragged = q0 + BLOCK_Q > Lq;
#pragma unroll
    for (int nt = 0; nt < QTILES; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + tig * 2 + (e & 1);
        const bool live = !ragged || q0 + qc < Lq;
        const float p = live ? ex2_ftz(st[nt][e] - lt[qc]) : 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - dlt[qc]);
      }
    }

    // dv += bf16(p^T) . dO and dk += bf16(ds^T) . qs, contracting the q rows
#pragma unroll
    for (int kk = 0; kk < BLOCK_Q / 16; ++kk) {
      uint32_t pa[4], da[4];
      pack_a(pa, st[2 * kk], st[2 * kk + 1]);
      pack_a(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt) {
        uint32_t bfrag[2];
        load_b_cols<STRIDE>(bfrag, gt, kk * 16, dt * 8, lane);
        mma_bf16_16816(dv_acc[dt], pa, bfrag);
        load_b_cols<STRIDE>(bfrag, qt, kk * 16, dt * 8, lane);
        mma_bf16_16816(dk_acc[dt], da, bfrag);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  __nv_bfloat16* dkb = dk + b * dk_sb + h * dk_sh;
  __nv_bfloat16* dvb = dv + b * dv_sb + h * dv_sh;
  const int r_lo = n0 + warp * 16 + gid;
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt) {
    const int col = dt * 8 + tig * 2;
    if (dt * 8 < D) {
      if (r_lo < Lk) {
        *reinterpret_cast<uint32_t*>(dkb + (long long)r_lo * dk_sl + col) =
            pack_bf16x2(dk_acc[dt][0] * LN2, dk_acc[dt][1] * LN2);
        *reinterpret_cast<uint32_t*>(dvb + (long long)r_lo * dv_sl + col) =
            pack_bf16x2(dv_acc[dt][0], dv_acc[dt][1]);
      }
      if (r_hi < Lk) {
        *reinterpret_cast<uint32_t*>(dkb + (long long)r_hi * dk_sl + col) =
            pack_bf16x2(dk_acc[dt][2] * LN2, dk_acc[dt][3] * LN2);
        *reinterpret_cast<uint32_t*>(dvb + (long long)r_hi * dv_sl + col) =
            pack_bf16x2(dv_acc[dt][2], dv_acc[dt][3]);
      }
    }
  }
}

template <int D_PAD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g, const float* lse, const float* delta,
                   void* dk, void* dv, int B, int H, int Lq, int Lk, int D, const long long* st, float q_scale,
                   cudaStream_t stream) {
  constexpr int STRIDE = D_PAD + 8;
  constexpr int BLOCK_Q = D_PAD >= 160 ? 32 : 64;
  const int smem = (2 * BLOCK_N + 4 * BLOCK_Q) * STRIDE * (int)sizeof(__nv_bfloat16) + 4 * BLOCK_Q * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D_PAD, BLOCK_Q>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lk + BLOCK_N - 1) / BLOCK_N, B * H);
  flash_bwd_dkv_kernel<D_PAD, BLOCK_Q><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(g), lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, Lq, Lk, D, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14], st[15], st[16], st[17],
      q_scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). strides: 18 element strides,
// (batch, head, row) for q, k, v, dO, dk, dv in that order; lse and delta
// are contiguous [B, H, Lq] float32 buffers. Returns the CUDA error of the
// launch (0 on success); D must be 40, 80 or 160.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* g, const void* lse,
                             const void* delta, void* dk, void* dv, int B, int H, int Lq, int Lk, int D,
                             const long long* strides, float q_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (D) {
    case 40: return (int)launch<48>(q, k, v, g, l, dl, dk, dv, B, H, Lq, Lk, D, strides, q_scale, s);
    case 80: return (int)launch<80>(q, k, v, g, l, dl, dk, dv, B, H, Lq, Lk, D, strides, q_scale, s);
    case 160: return (int)launch<160>(q, k, v, g, l, dl, dk, dv, B, H, Lq, Lk, D, strides, q_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
