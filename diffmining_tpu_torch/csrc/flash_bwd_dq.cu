// flash_bwd_dq: the query gradient of non-causal softmax attention from the
// forward's logsumexp, for the UNet's long self-attention. Written for
// Hopper (sm_90a).
//
// Replaces diffmining_tpu/ops/flash_attention.py:573 _bwd_dq_kernel (via
// _bwd_pallas, :659). The arithmetic, what bounds it and the design shared
// with the dk/dv kernel are in flash_bwd.cuh.
//
// Design. On the TPU the k blocks are the sequential grid axis and dq
// accumulates in VMEM scratch across grid steps. Here each block owns 128
// q rows (64 to each warpgroup) and loops over all key tiles itself, so dq
// never leaves registers and needs no atomics (the dk/dv kernel,
// flash_bwd_dkv.cu, is the k-outer twin). qs and dO are brought once by the
// TMA unit and stay in shared memory as the K-major A operands of
//   s = qs . K^T,  dp = dO . V^T   (wgmma, both operands in shared memory);
// ds lands in the accumulator layout, the register A layout of
//   dq += ds . K                    (wgmma, A in registers, K MN-major),
// and K and V stream through the ring in NK-key stages. Registers a thread
// are about D/2 (dq) + NK (s and dp): 84 at D=40, 144 at D=160.
//
// The kernel also forms delta = sum_d dO . o of its rows (fp32; the
// products of bf16 values are exact), from the dO tile already in shared
// memory and o read once, and writes it for the dk/dv kernel: the XLA pass
// of _bwd_pallas (:669) would read dO and o again.

#include "flash_bwd.cuh"

namespace {

constexpr int BLOCK_M = 128;  // q rows a block: two warpgroups of 64

template <int D>
struct DqCfg {
  using Dm = BwdDims<D>;
  static constexpr int NK = 64;  // keys a stage
  static constexpr int NSTAGE = D == 160 ? 2 : 3;
  // two blocks an SM at D=40; at D=80 the 128 registers a thread that two
  // would leave made it 2.6x slower on an H100
  static constexpr int MIN_BLOCKS = D == 40 ? 2 : 1;
  static constexpr int Q_BYTES = BLOCK_M * Dm::DP * 2;  // the qs tile, and the dO tile
  static constexpr int K_BYTES = NK * Dm::DP * 2;       // k of a stage, and v
  static constexpr int STAGE_BYTES = 2 * K_BYTES;
  static constexpr uint32_t Q_TX = 2 * BLOCK_M * D * 2;  // what the TMA unit brings: qs and dO
  static constexpr uint32_t STAGE_TX = 2 * NK * D * 2;   // ... a stage: k and v
  // qs, dO, the stages, then a full barrier for each stage and for qs/dO,
  // and a count of warps done for each stage
  static constexpr int SMEM = 2 * Q_BYTES + NSTAGE * STAGE_BYTES + (NSTAGE + 1) * 8 + NSTAGE * 4;
};

template <int D>
__global__ void __launch_bounds__(NUM_THREADS, DqCfg<D>::MIN_BLOCKS)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_g,
                        const __nv_bfloat16* __restrict__ o, const float* __restrict__ lse,
                        float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int H, int Lq, int Lk,
                        long long o_sb, long long o_sh, long long o_sl, long long dq_sb, long long dq_sh,
                        long long dq_sl, float scale) {
  using C = DqCfg<D>;
  using Dm = BwdDims<D>;
  constexpr int NS = C::NSTAGE;
  constexpr int NK = C::NK;
  constexpr int PK = NK / 16;  // k16 steps of ds . K
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sQ = smem;
  unsigned char* sG = sQ + C::Q_BYTES;
  unsigned char* sS = sG + C::Q_BYTES;  // [NSTAGE][k | v]
  uint64_t* full = reinterpret_cast<uint64_t*>(sS + NS * C::STAGE_BYTES);  // [NSTAGE], then qs/dO's
  uint64_t* q_full = full + NS;
  int* done = reinterpret_cast<int*>(q_full + 1);  // [NSTAGE] warps done with the stage

  const int tid = threadIdx.x;
  const int wg = tid / 128;  // this thread's warpgroup: q rows m0 + 64 wg ..
  const int lane = tid % 32;
  const int tig = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int m0 = blockIdx.x * BLOCK_M;
  const int n_tiles = (Lk + NK - 1) / NK;

  auto fetch = [&](int t) {  // by one thread: key tile t into stage t % NS
    const int st = t % NS;
    unsigned char* s = sS + st * C::STAGE_BYTES;
    mbar_expect_tx(&full[st], C::STAGE_TX);
    tma_load_5d(s, &map_k, &full[st], 0, t * NK, 0, h, b);
    tma_load_5d(s + C::K_BYTES, &map_v, &full[st], 0, t * NK, 0, h, b);
  };
  if (tid == 0) {
    for (int s = 0; s <= NS; ++s) mbar_init(&full[s], 1);
    for (int s = 0; s < NS; ++s) done[s] = 0;
    fence_mbar_init();
  }
  zero_pad_chunks<D>(sQ, BLOCK_M, 2, C::Q_BYTES, tid);         // qs and dO
  zero_pad_chunks<D>(sS, NK, 2 * NS, C::K_BYTES, tid);         // k and v of every stage
  fence_proxy_async();  // the pads, visible to wgmma
  __syncthreads();      // ... and the barriers initialised
  if (tid == 0) {
    mbar_expect_tx(q_full, C::Q_TX);
    tma_load_5d(sQ, &map_q, q_full, 0, m0, 0, h, b);
    tma_load_5d(sG, &map_g, q_full, 0, m0, 0, h, b);
    for (int t = 0; t < NS && t < n_tiles; ++t) fetch(t);
  }

  // lse (base 2) of rows r_lo and r_lo + 8, and the 16-byte chunks
  // tig, tig + 4, .. of their o rows, read while the TMA unit brings qs and
  // dO; rows past Lq are zeros in qs, dO and o, computed harmlessly and
  // never stored
  constexpr int OC = (Dm::CH + 3) / 4;
  const int r_lo = m0 + (tid / 32) * 16 + lane / 4;
  const int r_hi = r_lo + 8;
  const float* lb = lse + (long long)bh * Lq;
  const float lse2_lo = r_lo < Lq ? lb[r_lo] * LOG2E : 0.f;
  const float lse2_hi = r_hi < Lq ? lb[r_hi] * LOG2E : 0.f;
  const __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
  uint4 o_lo[OC], o_hi[OC];
#pragma unroll
  for (int c = 0; c < OC; ++c) {
    const int ch = tig + 4 * c;
    const bool in = ch < Dm::CH;
    o_lo[c] = in && r_lo < Lq ? __ldg(reinterpret_cast<const uint4*>(ob + (long long)r_lo * o_sl + ch * 8))
                              : make_uint4(0, 0, 0, 0);
    o_hi[c] = in && r_hi < Lq ? __ldg(reinterpret_cast<const uint4*>(ob + (long long)r_hi * o_sl + ch * 8))
                              : make_uint4(0, 0, 0, 0);
  }

  // this warpgroup's 64 rows of qs and dO, K-major A operands
  const uint64_t desc_q = desc_rows(sQ + wg * 64 * 16, BLOCK_M);
  const uint64_t desc_g = desc_rows(sG + wg * 64 * 16, BLOCK_M);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(q_full, 0);

  // delta of rows r_lo and r_lo + 8: this thread's chunks, then the quad's
  const unsigned char* g_lo = sG + (r_lo - m0) * 16;  // row r_lo's cell of chunk 0
  float del_lo = 0.f, del_hi = 0.f;
#pragma unroll
  for (int c = 0; c < OC; ++c) {
    const int ch = tig + 4 * c;
    if (ch < Dm::CH) {
      del_lo = dot8_bf16(*reinterpret_cast<const uint4*>(g_lo + ch * BLOCK_M * 16), o_lo[c], del_lo);
      del_hi = dot8_bf16(*reinterpret_cast<const uint4*>(g_lo + ch * BLOCK_M * 16 + 8 * 16), o_hi[c], del_hi);
    }
  }
  del_lo += __shfl_xor_sync(0xffffffffu, del_lo, 1);
  del_lo += __shfl_xor_sync(0xffffffffu, del_lo, 2);
  del_hi += __shfl_xor_sync(0xffffffffu, del_hi, 1);
  del_hi += __shfl_xor_sync(0xffffffffu, del_hi, 2);
  if (tig == 0) {
    if (r_lo < Lq) delta[(long long)bh * Lq + r_lo] = del_lo;
    if (r_hi < Lq) delta[(long long)bh * Lq + r_hi] = del_hi;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % NS;
    unsigned char* s = sS + st * C::STAGE_BYTES;
    mbar_wait(&full[st], (j / NS) & 1);

    // s = qs . K^T and dp = dO . V^T; the first k16 step of each does not
    // read the accumulator (scale-d 0)
    float sc[NK / 2], dp[NK / 2];
    const uint64_t desc_k = desc_rows(s, NK), desc_v = desc_rows(s + C::K_BYTES, NK);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Dm::QK; ++kk)
      wgmma_ss<NK>(sc, desc_add(desc_q, kk * 2 * BLOCK_M * 16), desc_add(desc_k, kk * 2 * NK * 16), kk);
#pragma unroll
    for (int kk = 0; kk < Dm::QK; ++kk)
      wgmma_ss<NK>(dp, desc_add(desc_g, kk * 2 * BLOCK_M * 16), desc_add(desc_v, kk * 2 * NK * 16), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // ds = p (dp - delta) with p = exp2(s - lse2); keys past Lk get
    // s = -1e30, so p = 0
    const int key0 = j * NK;
    if (key0 + NK > Lk) {
#pragma unroll
      for (int e = 0; e < NK / 2; ++e)
        if (key0 + (e / 4) * 8 + tig * 2 + (e & 1) >= Lk) sc[e] = NEG_INF;
    }
#pragma unroll
    for (int e = 0; e < NK / 2; ++e) {
      const bool hi = e & 2;  // the accumulator's second row of the pair
      sc[e] = ex2_ftz(sc[e] - (hi ? lse2_hi : lse2_lo)) * (dp[e] - (hi ? del_hi : del_lo));
    }
    uint32_t da[PK][4];  // bf16(ds) as register A operands
#pragma unroll
    for (int kk = 0; kk < PK; ++kk) pack_a(da[kk], &sc[kk * 8], &sc[kk * 8 + 4]);

    // dq += ds . K, contracting the stage's keys (K read MN-major)
    const uint64_t desc_kc = desc_cols(s, NK);
    fence_regs(acc);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PK; ++kk) wgmma_pv<D>(acc, da[kk], desc_add(desc_kc, kk * 2 * 128));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(da);  // da stays da's until the product has read it

    if (lane == 0 && last_warp_done(&done[st]) && j + NS < n_tiles) fetch(j + NS);
  }

  store_rows<D>(acc, dq + b * dq_sb + h * dq_sh, dq_sl, r_lo, Lq, tig, scale);
}

template <int D>
cudaError_t launch(const void* qs, const void* k, const void* v, const void* g, const void* o, const float* lse,
                   float* delta, void* dq, int B, int H, int Lq, int Lk, const long long* st, float scale,
                   cudaStream_t stream) {
  using C = DqCfg<D>;
  static bool ready[MAX_DEVICES];
  cudaError_t err = prepare(flash_bwd_dq_kernel<D>, C::SMEM, ready);
  CUtensorMap mq, mk, mv, mg;
  if (err == cudaSuccess) err = bhld_map<D>(&mq, qs, B, H, Lq, st[0], st[1], st[2], BLOCK_M);
  if (err == cudaSuccess) err = bhld_map<D>(&mk, k, B, H, Lk, st[3], st[4], st[5], C::NK);
  if (err == cudaSuccess) err = bhld_map<D>(&mv, v, B, H, Lk, st[6], st[7], st[8], C::NK);
  if (err == cudaSuccess) err = bhld_map<D>(&mg, g, B, H, Lq, st[9], st[10], st[11], BLOCK_M);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + BLOCK_M - 1) / BLOCK_M, B * H);
  flash_bwd_dq_kernel<D><<<grid, NUM_THREADS, C::SMEM, stream>>>(
      mq, mk, mv, mg, static_cast<const __nv_bfloat16*>(o), lse, delta, static_cast<__nv_bfloat16*>(dq), H, Lq,
      Lk, st[12], st[13], st[14], st[15], st[16], st[17], scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). qs is q pre-scaled by
// bf16(scale*log2e) in q's dtype; o is the forward's output. strides: 18
// element strides, (batch, head, row) for qs, k, v, dO, o, dq in that
// order; lse (read) and delta (written) are contiguous [B, H, Lq] float32
// buffers. Returns the CUDA error of the launch (0 on success); D must be
// 40, 80 or 160.
extern "C" int flash_bwd_dq(const void* qs, const void* k, const void* v, const void* g, const void* o,
                            const void* lse, void* delta, void* dq, int B, int H, int Lq, int Lk, int D,
                            const long long* strides, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (D) {
    case 40: return (int)launch<40>(qs, k, v, g, o, l, dl, dq, B, H, Lq, Lk, strides, scale, s);
    case 80: return (int)launch<80>(qs, k, v, g, o, l, dl, dq, B, H, Lq, Lk, strides, scale, s);
    case 160: return (int)launch<160>(qs, k, v, g, o, l, dl, dq, B, H, Lq, Lk, strides, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
