// Shared device helpers of the training flash kernels (flash_fwd_lse.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu), written for Hopper (sm_90a).
//
// mma.sync m16n8k16 fragments (bf16 in, fp32 accumulate). A thread of a
// warp is (gid = lane / 4, tig = lane % 4):
//   A (16x16, row-major): a0 (row gid,   k 2tig..+1)   a1 (row gid+8, k 2tig..+1)
//                         a2 (row gid,   k 2tig+8..+9) a3 (row gid+8, k 2tig+8..+9)
//   B (16x8, col-major):  b0 (k 2tig..+1, n gid)       b1 (k 2tig+8..+9, n gid)
//   C (16x8):             c0,c1 (row gid, n 2tig..+1)  c2,c3 (row gid+8, n 2tig..+1)
// Every operand lives in shared memory as a row-major [rows][STRIDE] bf16
// tile (STRIDE = padded head dim + 8, so fragment loads are conflict-free).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float NEG_INF = -1e30f;  // the TPU kernels' mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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

// D = A(16x16, row) * B(16x8, col) + D
__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

// A fragment of k-step kk from the 16 rows starting at `rows`.
template <int STRIDE>
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* rows, int kk, int gid, int tig) {
  const __nv_bfloat16* p = rows + gid * STRIDE + kk * 16 + tig * 2;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * STRIDE);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * STRIDE + 8);
}

// B fragment with k over the head dim and n over 8 tile rows: B[k=d][n=row]
// = T[n0 + n][kk*16 + k], i.e. the product contracts the head dim (q.k^T).
template <int STRIDE>
__device__ __forceinline__ void load_b_rows(uint32_t* b, const __nv_bfloat16* t, int n0, int kk, int gid, int tig) {
  const __nv_bfloat16* p = t + (n0 + gid) * STRIDE + kk * 16 + tig * 2;
  b[0] = lds32(p);
  b[1] = lds32(p + 8);
}

// B fragment with k over 16 tile rows and n over 8 head-dim columns:
// B[k=row][n=d] = T[k0 + k][d0 + n] (the product contracts the rows, p.v),
// via ldmatrix.trans: lanes 0-15 give the addresses of the 16 rows.
template <int STRIDE>
__device__ __forceinline__ void load_b_cols(uint32_t* b, const __nv_bfloat16* t, int k0, int d0, int lane) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(t + (k0 + (lane & 15)) * STRIDE + d0));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(s));
}

// The fp32 C fragments of two adjacent n-tiles (16 columns) rounded to bf16
// as the A fragment of one k-step: the p -> (p . v) hand-over in registers.
__device__ __forceinline__ void pack_a(uint32_t* a, const float* c0, const float* c1) {
  a[0] = pack_bf16x2(c0[0], c0[1]);
  a[1] = pack_bf16x2(c0[2], c0[3]);
  a[2] = pack_bf16x2(c1[0], c1[1]);
  a[3] = pack_bf16x2(c1[2], c1[3]);
}

// Stage rows [r0, r0 + ROWS) of one head's [L, D] matrix into a [ROWS][STRIDE]
// shared tile with 16-byte cp.async; rows past L are zero-filled.
template <int ROWS, int STRIDE, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, long long row_stride, int r0,
                                          int L, int D, int tid) {
  const int chunks = D / 8;
  for (int c = tid; c < ROWS * chunks; c += THREADS) {
    const int row = c / chunks;
    const int col = (c - row * chunks) * 8;
    const bool valid = r0 + row < L;
    const __nv_bfloat16* g = src + (valid ? (long long)(r0 + row) * row_stride + col : 0);
    cp_async_16(dst + row * STRIDE + col, g, valid);
  }
}

// Zero the head-dim pad columns [D, D_PAD) of `rows` consecutive tile rows;
// cp.async never writes them.
template <int D_PAD, int STRIDE, int THREADS>
__device__ __forceinline__ void zero_pad(__nv_bfloat16* t, int rows, int D, int tid) {
  const int pad_chunks = (D_PAD - D) / 8;
  for (int c = tid; c < rows * pad_chunks; c += THREADS) {
    const int row = c / pad_chunks;
    const int col = D + (c - row * pad_chunks) * 8;
    *reinterpret_cast<uint4*>(t + row * STRIDE + col) = make_uint4(0, 0, 0, 0);
  }
}

// The pre-scale in q's dtype, in place: bf16(q * bf16(scale*log2e)), as the
// TPU kernels' caller does before launching (flash_attention.py:155, :673).
template <int STRIDE, int THREADS>
__device__ __forceinline__ void prescale_tile(__nv_bfloat16* t, int rows, int D, float q_scale, int tid) {
  for (int c = tid; c < rows * D; c += THREADS) {
    const int row = c / D;
    __nv_bfloat16* p = t + row * STRIDE + (c - row * D);
    *p = __float2bfloat16_rn(__bfloat162float(*p) * q_scale);
  }
}

}  // namespace flash
