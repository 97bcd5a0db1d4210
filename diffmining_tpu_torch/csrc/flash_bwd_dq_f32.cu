// flash_bwd_dq_f32: the query gradient of non-causal softmax attention from
// the forward's logsumexp, in float32, for the UNet's long self-attention in
// a float32 training run (finetune --mixed_precision no). Written for Hopper
// (sm_90a).
//
// Replaces diffmining_tpu/ops/flash_attention.py:573 _bwd_dq_kernel (via
// _bwd_pallas, :659) at float32, and the delta that _bwd_pallas forms
// beside it (:669). The interface is flash_bwd_dq.cu's: it reads the
// pre-scaled q, forms delta = sum_d dO . o of its rows itself and writes it
// for flash_bwd_dkv_f32.cu.
//
// Arithmetic, float32 throughout (no TF32, no bf16; fp32 FMA only), as
// _bwd_dq_kernel at float32:
//   s     = qs . k^T (qs = q * fp32(scale*log2e)); keys past Lk get -1e30
//   p     = exp2(s - lse*log2e)       (no max; subnormal results flush to 0)
//   dp    = dO . v^T
//   ds    = p * (dp - delta)          (no rounding of p or ds)
//   dq    = (sum over keys of ds . k) * scale
//
// What bounds it on an H100 SXM: 6 Lq Lk D fp32 operations a head (the
// three products) against 67 TFLOP/s outside the tensor cores: at B4 H8
// L4096 D40 1.29e11 operations, 1.92 ms; its bytes (qs, k, v, dO, o, dq,
// lse, delta) take 0.01 ms. It is bound by its operations.
//
// Design (a simple kernel that is right first; flash_f32.cuh has the
// shared parts): one block of 256 threads a (64-row q tile, head, batch),
// looping over all key tiles itself, so dq stays in registers and needs no
// atomics. qs and dO stay in shared memory; K and V stream through it in
// 64-key tiles by cp.async, V's next tile copied during this tile's q.K^T
// and dq products, K's next during the next tile's dO.V^T. A thread holds
// 4 x 4 blocks of s and dp and 4 rows x DPT head-dim columns of dq; ds goes
// through shared memory between the products. D = 40 is padded to 48
// columns in shared memory only (K's columns 40-47 are zeros).

#include "flash_f32.cuh"

namespace {

using namespace f32attn;

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_f32_kernel(const float* __restrict__ qs, const float* __restrict__ k, const float* __restrict__ v,
                            const float* __restrict__ g, const float* __restrict__ o, const float* __restrict__ lse,
                            float* __restrict__ delta, float* __restrict__ dq, int Lq, int Lk, Strides st,
                            float scale) {
  using Dm = Dims<D>;
  constexpr int DPT = Dm::DPT;

  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sg = sq + Dm::TILE_FLOATS;
  float* sk = sg + Dm::TILE_FLOATS;
  float* sv = sk + Dm::TILE_FLOATS;
  float* sds = sv + Dm::TILE_FLOATS;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const float* qb = qs + b * st.s[0] + h * st.s[1];
  const float* kb = k + b * st.s[3] + h * st.s[4];
  const float* vb = v + b * st.s[6] + h * st.s[7];
  const float* gb = g + b * st.s[9] + h * st.s[10];
  const float* ob = o + b * st.s[12] + h * st.s[13];
  float* dqb = dq + b * st.s[15] + h * st.s[16];
  const long long row0 = (static_cast<long long>(b) * gridDim.y + h) * Lq;  // this head's lse and delta rows

  load_tile<D>(sg, gb, st.s[11], q0, Lq);  // rows past Lq are zeros: their dp and delta are 0
  load_tile<D>(sv, vb, st.s[8], 0, Lk);
  cp_async_commit();
  load_tile<D>(sq, qb, st.s[2], q0, Lq);
  load_tile<D>(sk, kb, st.s[5], 0, Lk);
  cp_async_commit();
  zero_pad<D>(sk);

  // lse in base 2 and delta = sum_d dO . o of this thread's rows; the dO
  // tile is in shared memory, o is read once
  float lse2[4], dl[4];
  cp_async_wait<1>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    float part = 0.f;
    if (r < Lq)
      for (int c = tx; c < D; c += 16) part = fmaf(sg[(4 * ty + i) * Dm::S + c], ob[r * st.s[14] + c], part);
    dl[i] = half_warp_sum(part);
    lse2[i] = r < Lq ? lse[row0 + r] * LOG2E : 0.f;
    if (tx == 0 && r < Lq) delta[row0 + r] = dl[i];
  }

  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += TILE) {
    cp_async_wait<1>();  // this tile's V has landed (its K may be in flight)
    __syncthreads();
    float dp[4][4];
    row_product<D>(dp, sg, sv, ty, tx);
    __syncthreads();  // V is free
    if (k0 + TILE < Lk) load_tile<D>(sv, vb, st.s[8], k0 + TILE, Lk);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's K has landed (the next V may be in flight)
    __syncthreads();

    float s[4][4];
    row_product<D>(s, sq, sk, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = k0 + tx + 16 * j < Lk ? exp2_ftz(s[i][j] - lse2[i]) : 0.f;  // exp2(-1e30 - lse) is 0
        sds[(4 * ty + i) * SP + tx + 16 * j] = p * (dp[i][j] - dl[i]);
      }
    __syncthreads();  // ds is whole
    tile_product<D>(acc, sds, sk, ty, tx);
    __syncthreads();  // K and ds are free
    if (k0 + TILE < Lk) load_tile<D>(sk, kb, st.s[5], k0 + TILE, Lk);
    cp_async_commit();
  }
  cp_async_wait<0>();

  const float mul[4] = {scale, scale, scale, scale};
  store_rows<D>(dqb, st.s[17], q0, Lq, acc, mul, ty, tx);
}

template <int D>
int launch(const void* qs, const void* k, const void* v, const void* g, const void* o, const float* lse, float* delta,
           void* dq, int B, int H, int Lq, int Lk, const Strides& st, float scale, cudaStream_t stream) {
  constexpr size_t smem = (4 * size_t(Dims<D>::TILE_FLOATS) + size_t(TILE) * SP) * sizeof(float);
  auto kernel = flash_bwd_dq_f32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + TILE - 1) / TILE, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const float*>(qs), static_cast<const float*>(k),
                                          static_cast<const float*>(v), static_cast<const float*>(g),
                                          static_cast<const float*>(o), lse, delta, static_cast<float*>(dq), Lq, Lk,
                                          st, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes), flash_bwd_dq's interface.
// strides: 18 element strides, (batch, head, row) for qs, k, v, dO, o and dq
// in that order, the head dim contiguous and every row 16-byte aligned; lse
// and delta [B, H, Lq] contiguous float32. Returns the CUDA error of the
// launch (0 on success); D must be 40, 64, 80 or 160.
extern "C" int flash_bwd_dq_f32(const void* qs, const void* k, const void* v, const void* g, const void* o,
                                const void* lse, void* delta, void* dq, int B, int H, int Lq, int Lk, int D,
                                const long long* strides, float scale, void* stream) {
  Strides st;
  for (int i = 0; i < 18; ++i) st.s[i] = strides[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (Lq <= 0 || Lk <= 0 || B <= 0 || H <= 0 || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  switch (D) {
    case 40: return launch<40>(qs, k, v, g, o, l, dl, dq, B, H, Lq, Lk, st, scale, s);
    case 64: return launch<64>(qs, k, v, g, o, l, dl, dq, B, H, Lq, Lk, st, scale, s);
    case 80: return launch<80>(qs, k, v, g, o, l, dl, dq, B, H, Lq, Lk, st, scale, s);
    case 160: return launch<160>(qs, k, v, g, o, l, dl, dq, B, H, Lq, Lk, st, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
