// flash_bwd_dkv: the key and value gradients of non-causal softmax
// attention from the forward's logsumexp, for the UNet's long
// self-attention. Written for Hopper (sm_90a).
//
// Replaces diffmining_tpu/ops/flash_attention.py:609 _bwd_dkv_kernel (via
// _bwd_pallas, :659). The arithmetic, what bounds it and the design shared
// with the dq kernel are in flash_bwd.cuh.
//
// Design. On the TPU the q blocks are the sequential grid axis and dk/dv
// accumulate in VMEM scratch. Here each block owns 128 keys (64 to each
// warpgroup) and loops over all q tiles itself: dk and dv stay in registers
// and no atomics are needed. K and V are brought once by the TMA unit and
// stay in shared memory as the A operands of the transposed products
//   s^T  = K . qs^T,  dp^T = V . dO^T   (wgmma, both operands in shared memory),
// so p^T and ds^T land in the accumulator layout, which is the register A
// layout of
//   dV  += bf16(p^T) . dO,  dK += ds^T . qs   (wgmma, A in registers),
// with dO and qs read MN-major from the same [chunk][row] tiles. qs, dO and
// the q tile's lse and delta rows (a 1-D map over the flat [B*H*Lq] rows)
// stream through a ring of NSTAGE stages. Registers a thread are about
// D (dk and dv) + NQ (s^T and dp^T): NQ = 48 q rows a stage at D=40, 64 at
// D=80 and 32 at D=160.

#include "flash_bwd.cuh"

namespace {

constexpr int BLOCK_N = 128;  // keys a block: two warpgroups of 64

template <int D>
struct DkvCfg {
  using Dm = BwdDims<D>;
  // q rows a stage: 48 at D=40 keeps two blocks an SM within 128 registers
  // without spills (64 spilled), 32 at D=160 keeps the accumulators and s^T,
  // dp^T within 255
  static constexpr int NQ = D == 40 ? 48 : D == 80 ? 64 : 32;
  static constexpr int NSTAGE = D == 40 ? 6 : 3;
  static constexpr int MIN_BLOCKS = D == 40 ? 2 : 1;
  static constexpr int KV_BYTES = BLOCK_N * Dm::DP * 2;  // the K tile, and the V tile
  static constexpr int Q_BYTES = NQ * Dm::DP * 2;        // qs of a stage, and dO
  // lse of a stage, and delta: the box starts at the 16-byte boundary at or
  // before the tile's first row (a TMA box starts 16-byte aligned), so it
  // holds NQ + 4 rows; each slot is rounded to 128 bytes
  static constexpr int ROW_BOX = NQ + 4;
  static constexpr int ROW_BYTES = (ROW_BOX * 4 + 127) / 128 * 128;
  static constexpr int STAGE_BYTES = 2 * Q_BYTES + 2 * ROW_BYTES;
  static constexpr uint32_t KV_TX = 2 * BLOCK_N * D * 2;  // what the TMA unit brings: k and v
  static constexpr uint32_t STAGE_TX = 2 * NQ * D * 2 + 2 * ROW_BOX * 4;
  // K, V, the stages, then a full barrier for each stage and for K/V, and a
  // count of warps done for each stage
  static constexpr int SMEM = 2 * KV_BYTES + NSTAGE * STAGE_BYTES + (NSTAGE + 1) * 8 + NSTAGE * 4;
};

template <int D>
__global__ void __launch_bounds__(NUM_THREADS, DkvCfg<D>::MIN_BLOCKS)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_g,
                         const __grid_constant__ CUtensorMap map_l, const __grid_constant__ CUtensorMap map_d,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H, int Lq, int Lk,
                         long long dk_sb, long long dk_sh, long long dk_sl, long long dv_sb, long long dv_sh,
                         long long dv_sl) {
  using C = DkvCfg<D>;
  using Dm = BwdDims<D>;
  constexpr int NS = C::NSTAGE;
  constexpr int NQ = C::NQ;
  constexpr int PK = NQ / 16;  // k16 steps of dV and dK
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sK = smem;
  unsigned char* sV = sK + C::KV_BYTES;
  unsigned char* sS = sV + C::KV_BYTES;  // [NSTAGE][qs | dO | lse | delta]
  uint64_t* full = reinterpret_cast<uint64_t*>(sS + NS * C::STAGE_BYTES);  // [NSTAGE], then K/V's
  uint64_t* kv_full = full + NS;
  int* done = reinterpret_cast<int*>(kv_full + 1);  // [NSTAGE] warps done with the stage

  const int tid = threadIdx.x;
  const int wg = tid / 128;  // this thread's warpgroup: keys n0 + 64 wg ..
  const int lane = tid % 32;
  const int tig = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int n0 = blockIdx.x * BLOCK_N;
  const int row0 = bh * Lq;  // this head's first row of lse and delta
  const int n_tiles = (Lq + NQ - 1) / NQ;

  auto fetch = [&](int t) {  // by one thread: q tile t into stage t % NS
    const int st = t % NS;
    unsigned char* s = sS + st * C::STAGE_BYTES;
    mbar_expect_tx(&full[st], C::STAGE_TX);
    tma_load_5d(s, &map_q, &full[st], 0, t * NQ, 0, h, b);
    tma_load_5d(s + C::Q_BYTES, &map_g, &full[st], 0, t * NQ, 0, h, b);
    tma_load_1d(s + 2 * C::Q_BYTES, &map_l, &full[st], (row0 + t * NQ) & ~3);
    tma_load_1d(s + 2 * C::Q_BYTES + C::ROW_BYTES, &map_d, &full[st], (row0 + t * NQ) & ~3);
  };
  if (tid == 0) {
    for (int s = 0; s <= NS; ++s) mbar_init(&full[s], 1);
    for (int s = 0; s < NS; ++s) done[s] = 0;
    fence_mbar_init();
  }
  zero_pad_chunks<D>(sK, BLOCK_N, 2, C::KV_BYTES, tid);          // K and V
  zero_pad_chunks<D>(sS, NQ, NS, C::STAGE_BYTES, tid);           // qs of every stage
  zero_pad_chunks<D>(sS + C::Q_BYTES, NQ, NS, C::STAGE_BYTES, tid);  // dO of every stage
  fence_proxy_async();  // the pads, visible to wgmma
  __syncthreads();      // ... and the barriers initialised
  if (tid == 0) {
    mbar_expect_tx(kv_full, C::KV_TX);
    tma_load_5d(sK, &map_k, kv_full, 0, n0, 0, h, b);
    tma_load_5d(sV, &map_v, kv_full, 0, n0, 0, h, b);
    for (int t = 0; t < NS && t < n_tiles; ++t) fetch(t);
  }

  // this warpgroup's 64 keys of K and V, K-major A operands
  const uint64_t desc_k = desc_rows(sK + wg * 64 * 16, BLOCK_N);
  const uint64_t desc_v = desc_rows(sV + wg * 64 * 16, BLOCK_N);
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  mbar_wait(kv_full, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % NS;
    unsigned char* s = sS + st * C::STAGE_BYTES;
    mbar_wait(&full[st], (i / NS) & 1);

    // s^T = K . qs^T and dp^T = V . dO^T for this warpgroup's 64 keys; the
    // first k16 step of each does not read the accumulator (scale-d 0)
    float s_t[NQ / 2], dp_t[NQ / 2];
    const uint64_t desc_q = desc_rows(s, NQ), desc_g = desc_rows(s + C::Q_BYTES, NQ);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Dm::QK; ++kk)
      wgmma_ss<NQ>(s_t, desc_add(desc_k, kk * 2 * BLOCK_N * 16), desc_add(desc_q, kk * 2 * NQ * 16), kk);
#pragma unroll
    for (int kk = 0; kk < Dm::QK; ++kk)
      wgmma_ss<NQ>(dp_t, desc_add(desc_v, kk * 2 * BLOCK_N * 16), desc_add(desc_g, kk * 2 * NQ * 16), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s_t);
    fence_regs(dp_t);

    // p^T = exp2(s^T - lse2) and ds^T = p^T (dp^T - delta): the columns are
    // q rows, so a thread reads lse and delta of its columns 8j + 2 tig + {0, 1};
    // q rows past Lq get s = -1e30, so p = 0
    const int q0 = i * NQ;
    const float* lrow = reinterpret_cast<const float*>(s + 2 * C::Q_BYTES) + ((row0 + q0) & 3);
    const float* drow = lrow + C::ROW_BYTES / 4;
    if (q0 + NQ > Lq) {
#pragma unroll
      for (int e = 0; e < NQ / 2; ++e)
        if (q0 + (e / 4) * 8 + tig * 2 + (e & 1) >= Lq) s_t[e] = NEG_INF;
    }
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j) {
      const int c = j * 8 + tig * 2;
      const float l0 = lrow[c] * LOG2E, l1 = lrow[c + 1] * LOG2E;
      const float d0 = drow[c], d1 = drow[c + 1];
      s_t[4 * j] = ex2_ftz(s_t[4 * j] - l0);
      s_t[4 * j + 1] = ex2_ftz(s_t[4 * j + 1] - l1);
      s_t[4 * j + 2] = ex2_ftz(s_t[4 * j + 2] - l0);
      s_t[4 * j + 3] = ex2_ftz(s_t[4 * j + 3] - l1);
      dp_t[4 * j] = s_t[4 * j] * (dp_t[4 * j] - d0);
      dp_t[4 * j + 1] = s_t[4 * j + 1] * (dp_t[4 * j + 1] - d1);
      dp_t[4 * j + 2] = s_t[4 * j + 2] * (dp_t[4 * j + 2] - d0);
      dp_t[4 * j + 3] = s_t[4 * j + 3] * (dp_t[4 * j + 3] - d1);
    }
    uint32_t pa[PK][4], da[PK][4];  // bf16(p^T), bf16(ds^T) as register A operands
#pragma unroll
    for (int kk = 0; kk < PK; ++kk) {
      pack_a(pa[kk], &s_t[kk * 8], &s_t[kk * 8 + 4]);
      pack_a(da[kk], &dp_t[kk * 8], &dp_t[kk * 8 + 4]);
    }

    // dV += p^T . dO and dK += ds^T . qs, contracting the stage's q rows
    const uint64_t desc_gc = desc_cols(s + C::Q_BYTES, NQ), desc_qc = desc_cols(s, NQ);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PK; ++kk) wgmma_pv<D>(dv_acc, pa[kk], desc_add(desc_gc, kk * 2 * 128));
#pragma unroll
    for (int kk = 0; kk < PK; ++kk) wgmma_pv<D>(dk_acc, da[kk], desc_add(desc_qc, kk * 2 * 128));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(pa);  // pa and da stay theirs until the products have read them
    fence_regs(da);

    if (lane == 0 && last_warp_done(&done[st]) && i + NS < n_tiles) fetch(i + NS);
  }

  const int r_lo = n0 + (tid / 32) * 16 + lane / 4;
  store_rows<D>(dk_acc, dk + b * dk_sb + h * dk_sh, dk_sl, r_lo, Lk, tig, LN2);
  store_rows<D>(dv_acc, dv + b * dv_sb + h * dv_sh, dv_sl, r_lo, Lk, tig, 1.0f);
}

template <int D>
cudaError_t launch(const void* qs, const void* k, const void* v, const void* g, const float* lse,
                   const float* delta, void* dk, void* dv, int B, int H, int Lq, int Lk, const long long* st,
                   cudaStream_t stream) {
  using C = DkvCfg<D>;
  static bool ready[MAX_DEVICES];
  cudaError_t err = prepare(flash_bwd_dkv_kernel<D>, C::SMEM, ready);
  CUtensorMap mq, mk, mv, mg, ml, md;
  if (err == cudaSuccess) err = bhld_map<D>(&mq, qs, B, H, Lq, st[0], st[1], st[2], C::NQ);
  if (err == cudaSuccess) err = bhld_map<D>(&mk, k, B, H, Lk, st[3], st[4], st[5], BLOCK_N);
  if (err == cudaSuccess) err = bhld_map<D>(&mv, v, B, H, Lk, st[6], st[7], st[8], BLOCK_N);
  if (err == cudaSuccess) err = bhld_map<D>(&mg, g, B, H, Lq, st[9], st[10], st[11], C::NQ);
  if (err == cudaSuccess) err = flat_map(&ml, lse, (long long)B * H * Lq, C::ROW_BOX);
  if (err == cudaSuccess) err = flat_map(&md, delta, (long long)B * H * Lq, C::ROW_BOX);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lk + BLOCK_N - 1) / BLOCK_N, B * H);
  flash_bwd_dkv_kernel<D><<<grid, NUM_THREADS, C::SMEM, stream>>>(
      mq, mk, mv, mg, ml, md, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, Lq, Lk,
      st[12], st[13], st[14], st[15], st[16], st[17]);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). qs is q pre-scaled by
// bf16(scale*log2e) in q's dtype. strides: 18 element strides, (batch,
// head, row) for qs, k, v, dO, dk, dv in that order; lse and delta are
// contiguous [B, H, Lq] float32 buffers. Returns the CUDA error of the
// launch (0 on success); D must be 40, 80 or 160.
extern "C" int flash_bwd_dkv(const void* qs, const void* k, const void* v, const void* g, const void* lse,
                             const void* delta, void* dk, void* dv, int B, int H, int Lq, int Lk, int D,
                             const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (D) {
    case 40: return (int)launch<40>(qs, k, v, g, l, dl, dk, dv, B, H, Lq, Lk, strides, s);
    case 80: return (int)launch<80>(qs, k, v, g, l, dl, dk, dv, B, H, Lq, Lk, strides, s);
    case 160: return (int)launch<160>(qs, k, v, g, l, dl, dk, dv, B, H, Lq, Lk, strides, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
