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
// The q rows are summed in order.
//
// What bounds it on an H100 SXM: 8 Lq Lk D fp32 operations a head (the
// four products) against 67 TFLOP/s outside the tensor cores: at B4 H8
// L4096 D40 1.72e11 operations, 2.56 ms; its bytes take 0.01 ms. It is
// bound by its operations, so the design spends as few issue slots as it
// can on anything but FFMA.
//
// Design: the float32 forward's loop turned round (flash_f32.cuh has the
// shared parts). One block of 8 warps (4 at D = 160) a (key tile, head,
// batch), each warp owning ROWS keys (32 at D = 40, else 16) from the first
// product to dk and dv, looping over every q tile itself: dk and dv stay in
// registers and need no atomics, and no block barrier sits in the loop.
//   * Before the loop a warp copies its keys of K and V chunk-major into
//     shared memory.
//   * A q tile's S^T = K . qs^T and dP^T = V . dO^T are RI x T register
//     tiles a lane (keys rg + 4i, q rows cg + 8t; 8 x 8 at D = 40). p^T goes
//     to the warp's slab, dv += p^T . dO is an RI-key x D/8-column register
//     tile; then ds^T = p^T (dp^T - delta), from the lane's own p^T read
//     back from the slab (so S^T and dP^T are never live together), takes
//     the slab for dk += ds^T . qs.
//   * qs and dO are contracted two ways, over the head dim in S^T and dP^T
//     and over q rows in the accumulating products; one copy of each serves
//     both: a stage's qs and dO are chunk-major boxes of BQ + 1 rows (chunk
//     stride 4 (BQ + 1) floats, so the 8 chunks a row group reads of one q
//     row lie on 8 bank groups).
//   * A stage holds a q tile's qs, dO, lse and delta (1-D boxes of BQ + 4
//     rows from the 16-byte boundary at or before the tile's first row),
//     brought by TMA with one mbarrier; two stages, so the next q tile lands
//     during this one's products. The last warp done with a stage has the
//     TMA unit refill it (flash_f32.cuh release_stage).
//   * One block an SM. dk and dv take 2 RI D/8 registers a lane (80 at
//     D = 40 and 80, 160 at D = 160); 254 registers at D = 40 and 160, 208
//     and 214 at 64 and 80, no spill. Shared memory: 187 KB at D = 40,
//     163 KB at 64, 195 KB at 80; at D = 160 four warps (64 keys) with
//     32-row q tiles (4 x 4 register tiles), 172 KB, as eight warps' K and
//     V (160 KB) leave no room for two stages (eight warps and one stage
//     ran 8% faster at B4 H8 L1024 and 8% slower at B2 H8 L1100, which is
//     1.1 waves of eight-warp blocks).
//   * The ragged last key tiles come after the whole ones and run only the
//     warps that hold a key; a launch takes half the warps where a second
//     wave of blocks would be less than half full, and fewer still while
//     the grid stays within one wave (flash_f32.cuh block_warps).

#include "flash_f32.cuh"

namespace {

using namespace f32attn;

template <int D>
struct DkvCfg {
  static constexpr int RI = D == 40 ? 8 : 4;  // keys a lane holds: rg + 4i of its warp's ROWS
  static constexpr int ROWS = 4 * RI;          // keys a warp owns
  static constexpr int MAX_WARPS = D == 160 ? 4 : 8;  // a launch takes MAX_WARPS or fewer
  static constexpr int THREADS = 32 * MAX_WARPS;
  static constexpr int BQ = D == 160 ? 32 : 64;  // q rows a stage
  static constexpr int T = BQ / 8;               // q columns of a lane's register tile
  static constexpr int NS = 2;                   // stages
  static constexpr int QS = BQ + 1;              // rows of a stage's qs and dO: chunks lie 4 QS floats apart
  static constexpr int ROW_BOX = BQ + 4;         // lse and delta rows a stage
  static constexpr int Q_FLOATS = align32(QS * D);
  static constexpr int ROW_FLOATS = align32(ROW_BOX);
  static constexpr int STAGE_FLOATS = 2 * Q_FLOATS + 2 * ROW_FLOATS;  // qs, dO, lse, delta
  static constexpr uint32_t STAGE_TX = (2 * QS * D + 2 * ROW_BOX) * 4;
  static constexpr int SLAB = ROWS * BQ;  // a warp's p^T, then ds^T, [ROWS][BQ]
  // bytes at `warps` warps: K and V [D/4][ROWS warps][4], the stages, the slabs, the stages' full
  // barriers and counts of warps done
  static constexpr int smem(int warps) {
    return (2 * ROWS * warps * D + NS * STAGE_FLOATS + warps * SLAB) * 4 + NS * (8 + 4);
  }
};

template <int D>
__global__ void __launch_bounds__(DkvCfg<D>::THREADS, 1)
    flash_bwd_dkv_f32_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_g,
                             const __grid_constant__ CUtensorMap map_l, const __grid_constant__ CUtensorMap map_d,
                             const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ dk,
                             float* __restrict__ dv, int H, int Lq, int Lk, Strides st) {
  using C = DkvCfg<D>;
  constexpr int NS = C::NS, BQ = C::BQ, T = C::T, QS = C::QS, RI = C::RI, ROWS = C::ROWS;
  const int warps = blockDim.x / 32, BN = ROWS * warps;  // keys a block

  extern __shared__ __align__(128) float smem[];
  float* sK = smem;                   // [D/4][BN][4]
  float* sV = sK + BN * D;            // [D/4][BN][4]
  float* sS = sV + BN * D;            // [NS] stages: qs, dO [D/4][QS][4], lse, delta [ROW_BOX]
  float* sP = sS + NS * C::STAGE_FLOATS;  // [warps] slabs [ROWS][BQ]
  uint64_t* full = reinterpret_cast<uint64_t*>(sP + warps * C::SLAB);
  int* done = reinterpret_cast<int*>(full + NS);  // warps done with each stage

  const int whole = Lk / BN, bhs = gridDim.x / ((Lk + BN - 1) / BN);
  int tile, bh;
  block_tile(blockIdx.x, whole, bhs, tile, bh);
  const int h = bh % H, b = bh / H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = lane / 8, cg = lane % 8;  // row group (keys rg + 4i of the warp's ROWS); q row or column group
  const int k0 = tile * BN;
  const int n_tiles = (Lq + BQ - 1) / BQ;
  const int active = min(warps, (Lk - k0 + ROWS - 1) / ROWS);  // warps that hold a key
  const int row0 = bh * Lq;                            // this head's first row of lse and delta

  auto fetch = [&](int t) {  // q tile t into stage t % NS
    float* s = sS + (t % NS) * C::STAGE_FLOATS;
    uint64_t* bar = &full[t % NS];
    mbar_expect_tx(bar, C::STAGE_TX);
    tma_load_5d(s, &map_q, bar, 0, t * BQ, 0, h, b);
    tma_load_5d(s + C::Q_FLOATS, &map_g, bar, 0, t * BQ, 0, h, b);
    tma_load_1d(s + 2 * C::Q_FLOATS, &map_l, bar, (row0 + t * BQ) & ~3);
    tma_load_1d(s + 2 * C::Q_FLOATS + C::ROW_FLOATS, &map_d, bar, (row0 + t * BQ) & ~3);
  };

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      done[s] = 0;
    }
    fence_mbar_init();
  }
  __syncthreads();  // the barriers are initialised
  if (warp >= active) return;
  if (tid == 0)
    for (int t = 0; t < NS && t < n_tiles; ++t) fetch(t);

  // this warp's keys of K and V, chunk-major; keys past Lk are zeros and
  // their dk and dv are never stored
  {
    const float* kb = k + b * st.s[3] + h * st.s[4];
    const float* vb = v + b * st.s[6] + h * st.s[7];
    for (int f = lane; f < ROWS * (D / 4); f += 32) {
      const int row = warp * ROWS + f % ROWS, c4 = f / ROWS;
      const int r = k0 + row;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
      if (r < Lk) {
        x = *reinterpret_cast<const float4*>(kb + r * st.s[5] + 4 * c4);
        y = *reinterpret_cast<const float4*>(vb + r * st.s[8] + 4 * c4);
      }
      *reinterpret_cast<float4*>(sK + (c4 * BN + row) * 4) = x;
      *reinterpret_cast<float4*>(sV + (c4 * BN + row) * 4) = y;
    }
    __syncwarp();
  }

  float dka[RI][Cols<D>::N], dva[RI][Cols<D>::N];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < Cols<D>::N; ++c) dka[i][c] = dva[i][c] = 0.f;
  const float4* k4 = reinterpret_cast<const float4*>(sK) + warp * ROWS + rg;  // + c4 BN + 4i
  const float4* v4 = reinterpret_cast<const float4*>(sV) + warp * ROWS + rg;
  // this warp's slab: row r's 16-byte groups XOR-ed with 8 (r % 4) floats
  // (r % 4 = rg), so neither the writes nor the 16-byte reads of a row
  // group's four rows meet on a bank
  float* pw = sP + warp * C::SLAB;
  const int swz = rg * 8;

  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = j * BQ, s = j % NS;
    const float* sq = sS + s * C::STAGE_FLOATS;
    const float* sg = sq + C::Q_FLOATS;
    const float* sl = sg + C::Q_FLOATS + ((row0 + q0) & 3);  // lse of the tile's first row
    const float* sd = sl + C::ROW_FLOATS;                    // and its delta
    mbar_wait(&full[s], (j / NS) & 1);

    float sc[RI][T];
    logit_tile<D, RI, T>(sc, k4, BN, reinterpret_cast<const float4*>(sq) + cg, QS);  // s^T
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int c = cg + 8 * t;
      const bool in = q0 + c < Lq;  // rows past Lq: p = 0 (their lse may be another head's)
      const float l2 = __fmul_rn(sl[c], LOG2E);
#pragma unroll
      for (int i = 0; i < RI; ++i) pw[(rg + 4 * i) * BQ + (c ^ swz)] = in ? exp2_ftz(sc[i][t] - l2) : 0.f;
    }
    float dp[RI][T];
    logit_tile<D, RI, T>(dp, v4, BN, reinterpret_cast<const float4*>(sg) + cg, QS);  // dp^T
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int c = cg + 8 * t;
      const float dl = sd[c];
#pragma unroll
      for (int i = 0; i < RI; ++i) dp[i][t] = pw[(rg + 4 * i) * BQ + (c ^ swz)] * (dp[i][t] - dl);  // ds^T
    }
    __syncwarp();  // the warp's p^T is whole
    slab_product<D, RI, BQ>(dva, pw, swz, sg, 4 * QS, rg, cg);
    __syncwarp();  // p^T is read
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int i = 0; i < RI; ++i) pw[(rg + 4 * i) * BQ + ((cg + 8 * t) ^ swz)] = dp[i][t];
    __syncwarp();  // the warp's ds^T is whole
    slab_product<D, RI, BQ>(dka, pw, swz, sq, 4 * QS, rg, cg);

    // done with the stage (and the slab, for the next tile's writes)
    release_stage(&done[s], active, j + NS < n_tiles, [&] { fetch(j + NS); });
  }

  float* dkb = dk + b * st.s[12] + h * st.s[13];
  float* dvb = dv + b * st.s[15] + h * st.s[16];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = k0 + warp * ROWS + rg + 4 * i;
    if (r >= Lk) continue;
    store_cols<D>(dkb + r * st.s[14], dka[i], LN2, cg);
    store_cols<D>(dvb + r * st.s[17], dva[i], 1.f, cg);
  }
}

template <int D>
int launch(const void* qs, const void* k, const void* v, const void* g, const float* lse, const float* delta,
           void* dk, void* dv, int B, int H, int Lq, int Lk, const Strides& st, cudaStream_t stream) {
  using C = DkvCfg<D>;
  const auto kernel = flash_bwd_dkv_f32_kernel<D>;
  static bool ready[MAX_DEVICES];
  cudaError_t err = prepare(kernel, C::smem(C::MAX_WARPS), ready);
  CUtensorMap mq, mg, ml, md;
  if (err == cudaSuccess) err = chunk_map(&mq, qs, B, H, Lq, D, st.s[0], st.s[1], st.s[2], C::QS);
  if (err == cudaSuccess) err = chunk_map(&mg, g, B, H, Lq, D, st.s[9], st.s[10], st.s[11], C::QS);
  if (err == cudaSuccess) err = flat_map(&ml, lse, static_cast<long long>(B) * H * Lq, C::ROW_BOX);
  if (err == cudaSuccess) err = flat_map(&md, delta, static_cast<long long>(B) * H * Lq, C::ROW_BOX);
  if (err != cudaSuccess) return err;
  const long long bhs = static_cast<long long>(B) * H;
  if (bhs * Lq > 0x7fffffff) return cudaErrorInvalidValue;  // a 1-D box's start is an int
  const int warps = block_warps(bhs, Lk, C::ROWS, sm_count(), C::MAX_WARPS);
  const long long blocks = bhs * ((Lk + C::ROWS * warps - 1) / (C::ROWS * warps));
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<unsigned(blocks), 32 * warps, C::smem(warps), stream>>>(
      mq, mg, ml, md, static_cast<const float*>(k), static_cast<const float*>(v), static_cast<float*>(dk),
      static_cast<float*>(dv), H, Lq, Lk, st);
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
