// flash_fwd_f32: non-causal softmax(q.k^T * scale).v in float32, for every
// gated self-attention of a float32 run on the card: the UNet's (SD-v1.5's
// head dims 40, 80 and 160: --dtype fp32 sweeps and mining, finetune
// --mixed_precision no) and the CLIP vision towers' at crops of 448 px and
// more (ViT-L/14: L = 1025 at 448, 4097 at 896; head dim 64). Written for
// Hopper (sm_90a).
//
// The JAX package's Pallas forwards compute in their operands' dtype (every
// astype in them is to the operand's own dtype), so at float32 they are
// float32 throughout. This kernel is their counterpart in three modes of one
// loop:
//   * online (MODE 0) replaces _flash_kernel_t (K3,
//     diffmining_tpu/ops/flash_attention.py:199);
//   * no-max (MODE 1) replaces _flash_kernel_t_nomax (K2, :250) and
//     _flash_kernel_t_1shot (K1, :290), which is the same arithmetic with
//     the key row in one block;
//   * lse (MODE 2) replaces _flash_kernel (K4, :37): the online loop, which
//     also writes the natural-log logsumexp for the backward
//     (flash_bwd_dq_f32.cu, flash_bwd_dkv_f32.cu).
//
// Arithmetic, float32 throughout (no TF32, no bf16; fp32 FMA only):
//   qs    = q * fp32(scale*log2e)                     (the pre-scale, :363)
//   s     = qs . k^T; keys past Lk get -1e30
//   online: m_new = max(m, rowmax(s)), alpha = exp2(m - m_new), m from -1e30
//           p = exp2(s - m_new); acc = acc*alpha + p.v; l = l*alpha + sum p
//   no-max: p = exp2(s); acc += p.v; l += sum p
//   o     = acc * (1 / max(l, 1e-30))
//   lse   = m * ln2 + log(max(l, 1e-30))              (lse mode, :80-86)
// exp2 results below the smallest normal float flush to zero, as on the TPU
// and in the plain versions. The running max is taken per 64-key tile here
// and per TPU key block there; in float32 that moves only roundings.
//
// What bounds it on an H100 SXM: a call is 4 Lq Lk D fp32 operations a
// head for the two products (the exp2 and the row sums are a few more a
// logit), against 67 TFLOP/s outside the tensor cores: at B4 H8 L4096 D40
// 2.1e10 operations, 0.32 ms; q, k, v and o are 21 MB, 0.006 ms at 3.35
// TB/s. It is bound by its operations at every shape the paths give it.
//
// Design (a simple kernel that is right first; flash_f32.cuh has the
// shared parts): one block of 256 threads a (64-row q tile, head, batch).
// The pre-scaled q tile stays in shared memory; K and V stream through
// shared memory in 64-key tiles by cp.async, K's next tile copied during
// this tile's P.V and V's next during the next tile's q.K^T, so neither
// holds registers. A thread holds a 4 x 4 block of S and 4 rows x DPT
// head-dim columns of the output; P goes through shared memory between the
// two products. The row max is four shuffles; the row sum is carried per
// thread and reduced once at the end. D = 40 is padded to 48 columns in
// shared memory only (V's columns 40-47 are zeros, so the padded output
// columns sum exact zeros and are not stored; flash_f32.cuh). At D = 160
// the tiles take 143 KB of shared memory: one block an SM.

#include "flash_f32.cuh"

namespace {

using namespace f32attn;

template <int D, int MODE>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                         float* __restrict__ o, float* __restrict__ lse, int Lq, int Lk, Strides st, float q_scale) {
  using Dm = Dims<D>;
  constexpr int DPT = Dm::DPT;
  constexpr bool NOMAX = MODE == 1;

  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sk = sq + Dm::TILE_FLOATS;
  float* sv = sk + Dm::TILE_FLOATS;
  float* sp = sv + Dm::TILE_FLOATS;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const float* qb = q + b * st.s[0] + h * st.s[1];
  const float* kb = k + b * st.s[3] + h * st.s[4];
  const float* vb = v + b * st.s[6] + h * st.s[7];
  float* ob = o + b * st.s[9] + h * st.s[10];

  load_tile<D>(sk, kb, st.s[5], 0, Lk);
  cp_async_commit();
  load_tile<D>(sv, vb, st.s[8], 0, Lk);
  cp_async_commit();
  load_tile_scaled<D>(sq, qb, st.s[2], q0, Lq, q_scale);  // rows past Lq are zeros and are never stored
  zero_pad<D>(sv);

  float acc[4][DPT], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < Lk; k0 += TILE) {
    cp_async_wait<1>();  // this tile's K has landed (its V may be in flight)
    __syncthreads();

    float s[4][4];
    row_product<D>(s, sq, sk, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k0 + tx + 16 * j >= Lk)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = NEG_INF;

    // p, the running max (online and lse modes) and the per-thread part of l
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float shift = 0.f;
      if (!NOMAX) {
        const float m_new = fmaxf(m[i], half_warp_max(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]))));
        const float alpha = exp2_ftz(m[i] - m_new);
        m[i] = m_new;
        shift = m_new;
        l[i] *= alpha;
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2_ftz(s[i][j] - shift);
        l[i] += p;
        sp[(4 * ty + i) * SP + tx + 16 * j] = p;
      }
    }
    __syncthreads();  // K is free, P is whole
    if (k0 + TILE < Lk) load_tile<D>(sk, kb, st.s[5], k0 + TILE, Lk);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's V has landed (the next K may be in flight)
    __syncthreads();

    tile_product<D>(acc, sp, sv, ty, tx);
    __syncthreads();  // V and P are free
    if (k0 + TILE < Lk) load_tile<D>(sv, vb, st.s[8], k0 + TILE, Lk);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // l from the half-warp's parts; o = acc / max(l, 1e-30)
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = fmaxf(half_warp_sum(l[i]), 1e-30f);
    inv[i] = 1.f / li;
    const int r = q0 + 4 * ty + i;
    if (MODE == 2 && tx == 0 && r < Lq)
      lse[(static_cast<long long>(b) * gridDim.y + h) * Lq + r] = m[i] * LN2 + logf(li);
  }
  store_rows<D>(ob, st.s[11], q0, Lq, acc, inv, ty, tx);
}

template <int D, int MODE>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Lq, int Lk,
           const Strides& st, float q_scale, cudaStream_t stream) {
  constexpr size_t smem = (3 * size_t(Dims<D>::TILE_FLOATS) + size_t(TILE) * SP) * sizeof(float);
  auto kernel = flash_fwd_f32_kernel<D, MODE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + TILE - 1) / TILE, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                          static_cast<const float*>(v), static_cast<float*>(o),
                                          static_cast<float*>(lse), Lq, Lk, st, q_scale);
  return cudaGetLastError();
}

template <int D>
int launch_mode(int mode, const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Lq,
                int Lk, const Strides& st, float q_scale, cudaStream_t s) {
  switch (mode) {
    case 0: return launch<D, 0>(q, k, v, o, lse, B, H, Lq, Lk, st, q_scale, s);
    case 1: return launch<D, 1>(q, k, v, o, lse, B, H, Lq, Lk, st, q_scale, s);
    case 2: return launch<D, 2>(q, k, v, o, lse, B, H, Lq, Lk, st, q_scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). strides: 12 element strides,
// (batch, head, row) for q, k, v, o in that order, the head dim contiguous
// and every row 16-byte aligned. mode: 0 online, 1 no-max, 2 online with
// the lse written to lse ([B, H, Lq] contiguous float32; unused in the
// other modes). Returns the CUDA error of the launch (0 on success); D must
// be 40, 64, 80 or 160.
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Lq,
                             int Lk, int D, int mode, const long long* strides, float q_scale, void* stream) {
  Strides st;
  for (int i = 0; i < 12; ++i) st.s[i] = strides[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Lq <= 0 || Lk <= 0 || B <= 0 || H <= 0 || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  switch (D) {
    case 40: return launch_mode<40>(mode, q, k, v, o, lse, B, H, Lq, Lk, st, q_scale, s);
    case 64: return launch_mode<64>(mode, q, k, v, o, lse, B, H, Lq, Lk, st, q_scale, s);
    case 80: return launch_mode<80>(mode, q, k, v, o, lse, B, H, Lq, Lk, st, q_scale, s);
    case 160: return launch_mode<160>(mode, q, k, v, o, lse, B, H, Lq, Lk, st, q_scale, s);
    default: return cudaErrorInvalidValue;
  }
}
