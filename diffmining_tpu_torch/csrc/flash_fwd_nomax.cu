// flash_fwd_nomax: non-causal softmax(q.k^T * scale).v without the running
// max, for the UNet's long self-attention, written for Hopper (sm_90a).
//
// Replaces two TPU kernels of diffmining_tpu/ops/flash_attention.py:
//   * _flash_kernel_t_1shot (:290) — the whole key row in one VMEM block,
//     exp2 with scale*log2e folded into q, no max subtraction, the
//     denominator from a ones column appended to v;
//   * _flash_kernel_t_nomax (:250) — the same arithmetic over several k
//     blocks, acc += exp2(q.k^T).[v|1] being the only carried state.
// On the TPU the one-shot kernel keeps the full key row resident. A Hopper
// block has 227 KB of shared memory, and K+V at L=4096, D=40 in bf16 is
// 655 KB, so this kernel loops over k tiles inside each block — which, with
// no running max, is exactly the multi-block no-max computation. One kernel
// therefore serves both.
//
// Arithmetic, matching the TPU kernels step by step:
//   qs    = bf16(q * bf16(scale*log2e))         (the pre-scale, in q's dtype)
//   s     = qs . k^T                            (bf16 products, fp32 sum)
//   p     = exp2(s) in fp32, subnormal -> 0     (masked keys: p = 0)
//   pb    = bf16(p)                             (cast to v's dtype before PV)
//   acc   = sum pb . v  (fp32),  l = sum pb     (l = the ones column)
//   o     = bf16(acc * (1 / max(l, 1e-30)))
// A row whose natural-log logits are all below about -87 gets p = 0
// everywhere and outputs zeros: the designed underflow edge of the TPU
// kernels, kept (ex2.approx.ftz flushes subnormal results as the TPU does).
//
// What bounds it on an H100 SXM: at B16 H8 L4096 D40 one call evaluates
// 2.1e9 exp2 (B*H*L^2). The SFUs issue 16 of them per clock per SM, about
// 4.2e12/s on 132 SMs at 1.98 GHz, so roughly 0.5 ms; the two matrix
// products are 3.4e11 FLOP, about 0.35 ms at the dense bf16 tensor rate of
// 989 TFLOP/s; q, k, v and o are 168 MB, 0.05 ms at 3.35 TB/s. The exp2 is
// the likely limit. The design keeps it to one SFU op per logit: no max, no
// subtract, no rescale, the log2e folded into q, and masking only on the
// ragged last tile.
//
// Design (a simple one; wgmma, TMA and warp specialisation come later):
//   * one block of 4 warps per (batch*head, 64-row q tile); each warp owns
//     16 q rows and keeps its q fragments in registers for the whole loop;
//   * a loop over 64-key tiles; K and V are staged in shared memory with
//     cp.async into two buffers, so tile j+1 loads while tile j computes;
//   * QK^T and PV on tensor cores with mma.sync m16n8k16 (bf16 in, fp32
//     accumulate); the head dim is zero-padded in shared memory to a
//     multiple of 16 (40 -> 48; 80 and 160 are multiples already);
//   * the QK^T accumulator is exponentiated in registers and re-packed as
//     the A operand of PV without leaving registers; V's B operand comes
//     from ldmatrix.trans;
//   * rows and keys past the end are zero-filled by cp.async and the last
//     tile's keys are masked, so any L works.
// Layout: q, k, v, o are [B, H, L, D] with arbitrary element strides for B,
// H and L (the head dim contiguous), so strided views straight out of the
// projections need no copy. Strides and base pointers must be 16-byte
// aligned; the Python wrapper checks that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;  // q rows per block
constexpr int BLOCK_N = 64;  // keys per tile
constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// B operand of m16n8k16 from a row-major [key][d] tile: lanes 0-15 give the
// addresses of the 16 key rows; .trans hands each thread (k=2*tig+{0,1}, n=gid).
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t u) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&u);
  return __bfloat1622float2(v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage rows [r0, r0 + 64) of one head's [L, D] matrix into a [64][STRIDE]
// shared tile with 16-byte cp.async; rows past L are zero-filled.
template <int STRIDE>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, long long row_stride,
                                          int r0, int L, int D, int tid) {
  const int chunks = D / 8;
  for (int c = tid; c < BLOCK_N * chunks; c += NUM_THREADS) {
    const int row = c / chunks;
    const int col = (c - row * chunks) * 8;
    const bool valid = r0 + row < L;
    const __nv_bfloat16* g = src + (valid ? (long long)(r0 + row) * row_stride + col : 0);
    cp_async_16(dst + row * STRIDE + col, g, valid);
  }
}

template <int D_PAD>
__global__ void __launch_bounds__(NUM_THREADS)
    flash_fwd_nomax_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int H, int Lq,
                           int Lk, int D, long long q_sb, long long q_sh, long long q_sl, long long k_sb,
                           long long k_sh, long long k_sl, long long v_sb, long long v_sh, long long v_sl,
                           long long o_sb, long long o_sh, long long o_sl, float q_scale) {
  constexpr int STRIDE = D_PAD + 8;  // +16 bytes a row: conflict-free fragment loads
  constexpr int KSTEPS = D_PAD / 16;  // k-steps of QK^T over the head dim
  constexpr int DTILES = D_PAD / 8;   // n-tiles of PV over the head dim
  constexpr int NTILES = BLOCK_N / 8;  // n-tiles of QK^T over the keys
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BLOCK_M][STRIDE]
  __nv_bfloat16* sK = sQ + BLOCK_M * STRIDE;                        // [2][BLOCK_N][STRIDE]
  __nv_bfloat16* sV = sK + 2 * BLOCK_N * STRIDE;                    // [2][BLOCK_N][STRIDE]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = lane >> 2;  // row within the 8-row half of a fragment
  const int tig = lane & 3;   // thread within the quad
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int m0 = blockIdx.x * BLOCK_M;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;

  // zero the head-dim pad columns [D, D_PAD) of every tile once; cp.async
  // never writes them
  const int pad_chunks = (D_PAD - D) / 8;
  for (int c = tid; c < (BLOCK_M + 4 * BLOCK_N) * pad_chunks; c += NUM_THREADS) {
    const int row = c / pad_chunks;
    const int col = D + (c - row * pad_chunks) * 8;
    *reinterpret_cast<uint4*>(sQ + row * STRIDE + col) = make_uint4(0, 0, 0, 0);
  }

  const int n_tiles = (Lk + BLOCK_N - 1) / BLOCK_N;
  load_tile<STRIDE>(sQ, qb, q_sl, m0, Lq, D, tid);
  cp_async_commit();
  load_tile<STRIDE>(sK, kb, k_sl, 0, Lk, D, tid);
  load_tile<STRIDE>(sV, vb, v_sl, 0, Lk, D, tid);
  cp_async_commit();

  cp_async_wait<1>();  // the q tile has landed
  __syncthreads();
  // the pre-scale in q's dtype: bf16(q * bf16(scale*log2e)), as the TPU
  // kernels' caller does before launching
  for (int c = tid; c < BLOCK_M * D; c += NUM_THREADS) {
    const int row = c / D;
    const int col = c - row * D;
    __nv_bfloat16* p = sQ + row * STRIDE + col;
    *p = __float2bfloat16_rn(__bfloat162float(*p) * q_scale);
  }
  __syncthreads();

  uint32_t qf[KSTEPS][4];
  {
    const __nv_bfloat16* qw = sQ + warp * 16 * STRIDE;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      qf[kk][0] = lds32(qw + gid * STRIDE + kk * 16 + tig * 2);
      qf[kk][1] = lds32(qw + (gid + 8) * STRIDE + kk * 16 + tig * 2);
      qf[kk][2] = lds32(qw + gid * STRIDE + kk * 16 + 8 + tig * 2);
      qf[kk][3] = lds32(qw + (gid + 8) * STRIDE + kk * 16 + 8 + tig * 2);
    }
  }

  float acc[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float l_lo = 0.f, l_hi = 0.f;  // partial denominators of rows gid and gid+8

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<STRIDE>(sK + (buf ^ 1) * BLOCK_N * STRIDE, kb, k_sl, (j + 1) * BLOCK_N, Lk, D, tid);
      load_tile<STRIDE>(sV + (buf ^ 1) * BLOCK_N * STRIDE, vb, v_sl, (j + 1) * BLOCK_N, Lk, D, tid);
    }
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait<1>();  // tile j has landed
    __syncthreads();

    const __nv_bfloat16* kt = sK + buf * BLOCK_N * STRIDE;
    const __nv_bfloat16* vt = sV + buf * BLOCK_N * STRIDE;

    // s = qs . k^T for this warp's 16 rows and the tile's 64 keys
    float s[NTILES][4];
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* krow = kt + (nt * 8 + gid) * STRIDE + tig * 2;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t bfrag[2];
        bfrag[0] = lds32(krow + kk * 16);
        bfrag[1] = lds32(krow + kk * 16 + 8);
        mma_bf16_16816(s[nt], qf[kk], bfrag);
      }
    }

    // p = exp2(s); keys past Lk get p = 0 (exp2 of the TPU kernels' -1e30)
    const int key0 = j * BLOCK_N;
    const bool ragged = key0 + BLOCK_N > Lk;
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool live = !ragged || key0 + nt * 8 + tig * 2 + (e & 1) < Lk;
        s[nt][e] = live ? ex2_ftz(s[nt][e]) : 0.f;
      }
    }

    // re-pack p as bf16 A fragments (16 keys each); l sums the ROUNDED p,
    // as the ones column of the TPU kernels' PV product does
    uint32_t pf[BLOCK_N / 16][4];
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      pf[kk][0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pf[kk][1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pf[kk][2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[kk][3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const float2 a0 = unpack_bf16x2(pf[kk][0]);
      const float2 a1 = unpack_bf16x2(pf[kk][1]);
      const float2 a2 = unpack_bf16x2(pf[kk][2]);
      const float2 a3 = unpack_bf16x2(pf[kk][3]);
      l_lo += (a0.x + a0.y) + (a2.x + a2.y);
      l_hi += (a1.x + a1.y) + (a3.x + a3.y);
    }

    // acc += pb . v
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      const __nv_bfloat16* vrow = vt + (kk * 16 + (lane & 15)) * STRIDE;
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt) {
        uint32_t bfrag[2];
        ldmatrix_x2_trans(bfrag, vrow + dt * 8);
        mma_bf16_16816(acc[dt], pf[kk], bfrag);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  // full-row denominators: reduce over the 4 threads of the quad
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.0f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.0f / fmaxf(l_hi, 1e-30f);

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
}

template <int D_PAD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Lq, int Lk, int D,
                   const long long* st, float q_scale, cudaStream_t stream) {
  constexpr int STRIDE = D_PAD + 8;
  const int smem = (BLOCK_M + 4 * BLOCK_N) * STRIDE * (int)sizeof(__nv_bfloat16);
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_nomax_kernel<D_PAD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + BLOCK_M - 1) / BLOCK_M, B * H);
  flash_fwd_nomax_kernel<D_PAD><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H, Lq, Lk, D, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], q_scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). strides: 12 element strides,
// (batch, head, row) for q, k, v, o in that order. Returns the CUDA error of
// the launch (0 on success); D must be 40, 80 or 160 (SD-v1.5's head dims).
extern "C" int flash_fwd_nomax(const void* q, const void* k, const void* v, void* o, int B, int H, int Lq, int Lk,
                               int D, const long long* strides, float q_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40: return (int)launch<48>(q, k, v, o, B, H, Lq, Lk, D, strides, q_scale, s);
    case 80: return (int)launch<80>(q, k, v, o, B, H, Lq, Lk, D, strides, q_scale, s);
    case 160: return (int)launch<160>(q, k, v, o, B, H, Lq, Lk, D, strides, q_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
