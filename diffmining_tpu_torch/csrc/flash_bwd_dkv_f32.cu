// flash_bwd_dkv_f32: the key and value gradients of non-causal softmax
// attention from the forward's logsumexp and delta, in float32, for the
// UNet's long self-attention in a float32 training run (finetune
// --mixed_precision no). Written for Hopper (sm_90a).
//
// Replaces diffmining_tpu/ops/flash_attention.py:609 _bwd_dkv_kernel (via
// _bwd_pallas, :659) at float32. The interface is flash_bwd_dkv.cu's: it
// reads the pre-scaled q and the delta that flash_bwd_dq_f32.cu wrote.
//
// Arithmetic, float32 throughout (no TF32, no bf16; fp32 FMA only), as
// _bwd_dkv_kernel at float32:
//   s     = qs . k^T (qs = q * fp32(scale*log2e))
//   p     = exp2(s - lse*log2e)       (no max; subnormal results flush to 0;
//                                      0 for q rows past Lq)
//   dv    = sum over q rows of p^T . dO
//   dp    = dO . v^T
//   ds    = p * (dp - delta)          (no rounding of p or ds)
//   dk    = (sum over q rows of ds^T . qs) * ln2   (ln2 undoes qs's log2e)
//
// What bounds it on an H100 SXM: 8 Lq Lk D fp32 operations a head (the
// four products) against 67 TFLOP/s outside the tensor cores: at B4 H8
// L4096 D40 1.72e11 operations, 2.56 ms; its bytes take 0.01 ms. It is
// bound by its operations.
//
// Design (a simple kernel that is right first; flash_f32.cuh has the
// shared parts): one block of 256 threads a (64-key tile, head, batch),
// looping over all q tiles itself, so dk and dv stay in registers and need
// no atomics. The block's K and V tiles stay in shared memory; qs and dO
// come in 64-row tiles by cp.async, with their rows' lse and delta. The
// products are taken transposed: a thread holds 4 x 4 blocks of s^T and
// dp^T (keys 4ty + i, q rows tx + 16j), writes p^T and ds^T to shared
// memory, and accumulates keys 4ty + i x DPT head-dim columns of dv and dk.
// D = 40 is padded to 48 columns in shared memory only (the qs and dO
// tiles' columns 40-47 are zeros). A q tile is copied while nothing else
// runs: the overlap of copies and products is left to a redesign.

#include "flash_f32.cuh"

namespace {

using namespace f32attn;

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ qs, const float* __restrict__ k, const float* __restrict__ v,
                             const float* __restrict__ g, const float* __restrict__ lse,
                             const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int Lq,
                             int Lk, Strides st) {
  using Dm = Dims<D>;
  constexpr int DPT = Dm::DPT;

  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);
  float* sv = sk + Dm::TILE_FLOATS;
  float* sq = sv + Dm::TILE_FLOATS;
  float* sg = sq + Dm::TILE_FLOATS;
  float* sp = sg + Dm::TILE_FLOATS;
  float* sds = sp + TILE * SP;
  float* slse = sds + TILE * SP;  // base 2
  float* sdl = slse + TILE;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const float* qb = qs + b * st.s[0] + h * st.s[1];
  const float* kb = k + b * st.s[3] + h * st.s[4];
  const float* vb = v + b * st.s[6] + h * st.s[7];
  const float* gb = g + b * st.s[9] + h * st.s[10];
  float* dkb = dk + b * st.s[12] + h * st.s[13];
  float* dvb = dv + b * st.s[15] + h * st.s[16];
  const long long row0 = (static_cast<long long>(b) * gridDim.y + h) * Lq;  // this head's lse and delta rows

  load_tile<D>(sk, kb, st.s[5], k0, Lk);  // keys past Lk are zeros; their dk and dv are not stored
  load_tile<D>(sv, vb, st.s[8], k0, Lk);
  cp_async_commit();
  zero_pad<D>(sq);
  zero_pad<D>(sg);

  float dka[4][DPT], dva[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int q0 = 0; q0 < Lq; q0 += TILE) {
    load_tile<D>(sq, qb, st.s[2], q0, Lq);  // rows past Lq are zeros, and their p is 0
    load_tile<D>(sg, gb, st.s[11], q0, Lq);
    cp_async_commit();
    if (tid < TILE) {
      const int r = q0 + tid;
      slse[tid] = r < Lq ? lse[row0 + r] * LOG2E : 0.f;
      sdl[tid] = r < Lq ? delta[row0 + r] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();

    float st_[4][4], dpt[4][4];
    row_product<D>(st_, sk, sq, ty, tx);  // s^T: keys 4ty + i, q rows tx + 16j
    row_product<D>(dpt, sv, sg, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const bool in = q0 + c < Lq;
      const float l2 = slse[c], dl = sdl[c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = in ? exp2_ftz(st_[i][j] - l2) : 0.f;
        sp[(4 * ty + i) * SP + c] = p;
        sds[(4 * ty + i) * SP + c] = p * (dpt[i][j] - dl);
      }
    }
    __syncthreads();  // p^T and ds^T are whole
    tile_product<D>(dva, sp, sg, ty, tx);
    tile_product<D>(dka, sds, sq, ty, tx);
    __syncthreads();  // the q tile, p^T and ds^T are free
  }

  const float one[4] = {1.f, 1.f, 1.f, 1.f}, ln2[4] = {LN2, LN2, LN2, LN2};
  store_rows<D>(dkb, st.s[14], k0, Lk, dka, ln2, ty, tx);
  store_rows<D>(dvb, st.s[17], k0, Lk, dva, one, ty, tx);
}

template <int D>
int launch(const void* qs, const void* k, const void* v, const void* g, const float* lse, const float* delta,
           void* dk, void* dv, int B, int H, int Lq, int Lk, const Strides& st, cudaStream_t stream) {
  constexpr size_t smem =
      (4 * size_t(Dims<D>::TILE_FLOATS) + 2 * size_t(TILE) * SP + 2 * size_t(TILE)) * sizeof(float);
  auto kernel = flash_bwd_dkv_f32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Lk + TILE - 1) / TILE, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const float*>(qs), static_cast<const float*>(k),
                                          static_cast<const float*>(v), static_cast<const float*>(g), lse, delta,
                                          static_cast<float*>(dk), static_cast<float*>(dv), Lq, Lk, st);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes), flash_bwd_dkv's interface.
// strides: 18 element strides, (batch, head, row) for qs, k, v, dO, dk and
// dv in that order, the head dim contiguous and every row 16-byte aligned;
// lse and delta [B, H, Lq] contiguous float32. Returns the CUDA error of the
// launch (0 on success); D must be 40, 64, 80 or 160.
extern "C" int flash_bwd_dkv_f32(const void* qs, const void* k, const void* v, const void* g, const void* lse,
                                 const void* delta, void* dk, void* dv, int B, int H, int Lq, int Lk, int D,
                                 const long long* strides, void* stream) {
  Strides st;
  for (int i = 0; i < 18; ++i) st.s[i] = strides[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (Lq <= 0 || Lk <= 0 || B <= 0 || H <= 0 || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  switch (D) {
    case 40: return launch<40>(qs, k, v, g, l, dl, dk, dv, B, H, Lq, Lk, st, s);
    case 64: return launch<64>(qs, k, v, g, l, dl, dk, dv, B, H, Lq, Lk, st, s);
    case 80: return launch<80>(qs, k, v, g, l, dl, dk, dv, B, H, Lq, Lk, st, s);
    case 160: return launch<160>(qs, k, v, g, l, dl, dk, dv, B, H, Lq, Lk, st, s);
    default: return cudaErrorInvalidValue;
  }
}
