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
//   s     = qs . k^T (qs = q * fp32(scale*log2e)); keys past Lk get p = 0
//   p     = exp2(s - lse*log2e)       (no max; subnormal results flush to 0)
//   dp    = dO . v^T
//   ds    = p * (dp - delta)          (no rounding of p or ds)
//   dq    = (sum over keys of ds . k) * scale, the keys summed in order
//
// What bounds it on an H100 SXM: 6 Lq Lk D fp32 operations a head (the
// three products) against 67 TFLOP/s outside the tensor cores: at B4 H8
// L4096 D40 1.29e11 operations, 1.92 ms; its bytes (qs, k, v, dO, o, dq,
// lse, delta) take 0.01 ms. It is bound by its operations, so the design
// spends as few issue slots and stalls as it can on anything but FFMA:
// shared-memory reads, exp2, waits for data.
//
// Design: the float32 forward's loop with one more product (flash_f32.cuh
// has the shared parts). One block of 8 warps (4 at D = 160) a (q tile,
// head, batch), each warp owning ROWS q rows (32 at D = 40, else 16) from
// the first product to dq, looping over every key tile itself: dq stays in
// registers and needs no atomics, and no block barrier sits in the loop.
//   * Before the loop a warp copies its rows of qs and dO chunk-major into
//     shared memory, and forms delta (from dO and o, read once) and the
//     base-2 lse of its rows.
//   * A key tile's dP = dO . V^T and S = qs . K^T are RI x 8 register tiles
//     a lane (8 x 8 at D = 40: 16 16-byte reads for 256 FMA; 4 x 8
//     elsewhere: 12 for 128); ds = p (dp - delta) goes to the warp's slab,
//     and dq += ds . K is an RI-row x D/8-column register tile (no padded
//     column at D = 40 or 80).
//   * K is contracted two ways, over the head dim in S and over keys in
//     ds . K. One copy serves both: a K stage is a chunk-major box of 65
//     keys, whose chunk stride of 260 floats spreads the 8 chunks a row
//     group reads in ds . K over 8 bank groups (a 64-key box would put them
//     on one), while S reads it as the forward reads K. V is read in dP
//     alone, as a 64-key chunk-major box.
//   * K and V come by TMA through two rings of 64-key stages with an
//     mbarrier each: V is released after dP, so its next tile lands during
//     S and ds . K; K after ds . K, so its next lands during the next dP.
//     The last warp done with a stage has the TMA unit refill it
//     (flash_f32.cuh release_stage), so a warp waits for data only.
//   * One block an SM. Shared memory: 185 KB at D = 40, 161 KB at 64 and
//     193 KB at 80 (two stages a ring), 177 KB at D = 160 (four warps, one
//     stage a ring). Registers: 255 at D = 40 (a 64-byte spill that costs
//     no time measured: parking dp - delta in the slab takes it away and
//     runs no faster), 232-254 elsewhere. 32 rows a warp at D = 40 ran
//     7-8% faster than 16 rows with two blocks an SM at 128 registers (on
//     an H100); at D = 80 the dq tile (RI x 10 columns) leaves no room.
//   * The ragged last q tiles come after the whole ones and run only the
//     warps that hold a row; a launch takes half the warps where a second
//     wave of blocks would be less than half full, and fewer still while
//     the grid stays within one wave (flash_f32.cuh block_warps).

#include "flash_f32.cuh"

namespace {

using namespace f32attn;

template <int D>
struct DqCfg {
  static constexpr int RI = D == 40 ? 8 : 4;  // q rows a lane holds: rg + 4i of its warp's ROWS
  static constexpr int ROWS = 4 * RI;          // q rows a warp owns
  static constexpr int MAX_WARPS = D == 160 ? 4 : 8;  // a launch takes MAX_WARPS or fewer
  static constexpr int THREADS = 32 * MAX_WARPS;
  static constexpr int NS = D == 160 ? 1 : 2;  // stages of the K ring and of the V ring
  static constexpr int BK = 64;                // keys a tile
  static constexpr int T = BK / 8;             // key columns of a lane's register tiles
  static constexpr int KS = BK + 1;            // keys a K stage holds: its chunks lie 4 KS floats apart
  static constexpr int K_FLOATS = align32(KS * D);
  static constexpr int V_FLOATS = BK * D;
  static constexpr int SLAB = ROWS * BK;  // a warp's ds [ROWS][BK]
  static constexpr uint32_t K_TX = KS * D * 4, V_TX = BK * D * 4;
  // bytes at `warps` warps: qs and dO [D/4][ROWS warps][4], the rings, the slabs, then each ring's
  // stages' full barriers and counts of warps done
  static constexpr int smem(int warps) {
    return (2 * ROWS * warps * D + NS * (K_FLOATS + V_FLOATS) + warps * SLAB) * 4 + 2 * NS * (8 + 4);
  }
};

template <int D>
__global__ void __launch_bounds__(DqCfg<D>::THREADS, 1)
    flash_bwd_dq_f32_kernel(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                            const float* __restrict__ qs, const float* __restrict__ g, const float* __restrict__ o,
                            const float* __restrict__ lse, float* __restrict__ delta, float* __restrict__ dq, int H,
                            int Lq, int Lk, Strides st, float scale) {
  using C = DqCfg<D>;
  constexpr int NS = C::NS, BK = C::BK, KS = C::KS, T = C::T, RI = C::RI, ROWS = C::ROWS;
  const int warps = blockDim.x / 32, BQ = ROWS * warps;

  extern __shared__ __align__(128) float smem[];
  float* sQ = smem;                      // [D/4][BQ][4]
  float* sG = sQ + BQ * D;               // dO, [D/4][BQ][4]
  float* sK = sG + BQ * D;               // [NS] stages [D/4][KS][4]
  float* sV = sK + NS * C::K_FLOATS;     // [NS] stages [D/4][BK][4]
  float* sP = sV + NS * C::V_FLOATS;     // [warps] slabs [ROWS][BK]
  uint64_t* full_k = reinterpret_cast<uint64_t*>(sP + warps * C::SLAB);
  uint64_t* full_v = full_k + NS;
  int* done_k = reinterpret_cast<int*>(full_v + NS);  // warps done with each stage
  int* done_v = done_k + NS;

  const int whole = Lq / BQ, bhs = gridDim.x / ((Lq + BQ - 1) / BQ);
  int tile, bh;
  block_tile(blockIdx.x, whole, bhs, tile, bh);
  const int h = bh % H, b = bh / H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = lane / 8, cg = lane % 8;  // row group (rows rg + 4i of the warp's ROWS); key or column group
  const int q0 = tile * BQ;
  const int n_tiles = (Lk + BK - 1) / BK;
  const int active = min(warps, (Lq - q0 + ROWS - 1) / ROWS);  // warps that hold a q row

  auto fetch_k = [&](int t) {
    const int s = t % NS;
    mbar_expect_tx(&full_k[s], C::K_TX);
    tma_load_5d(sK + s * C::K_FLOATS, &map_k, &full_k[s], 0, t * BK, 0, h, b);
  };
  auto fetch_v = [&](int t) {
    const int s = t % NS;
    mbar_expect_tx(&full_v[s], C::V_TX);
    tma_load_5d(sV + s * C::V_FLOATS, &map_v, &full_v[s], 0, t * BK, 0, h, b);
  };
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      done_k[s] = 0;
      done_v[s] = 0;
    }
    fence_mbar_init();
  }
  __syncthreads();  // the barriers are initialised
  if (warp >= active) return;
  if (tid == 0) {
    for (int t = 0; t < NS && t < n_tiles; ++t) {
      fetch_v(t);
      fetch_k(t);
    }
  }

  // this warp's rows of qs and dO, chunk-major (rows past Lq are zeros and
  // are never stored), and this lane's part of delta = sum_d dO . o for row
  // lane % ROWS: at 16 rows the even chunks on lanes 0-15, the odd ones on
  // 16-31
  const long long row0 = static_cast<long long>(bh) * Lq;  // this head's lse and delta rows
  float dl_row;
  {
    const float* qb = qs + b * st.s[0] + h * st.s[1];
    const float* gb = g + b * st.s[9] + h * st.s[10];
    const float* ob = o + b * st.s[12] + h * st.s[13];
    float part = 0.f;
    for (int f = lane; f < ROWS * (D / 4); f += 32) {
      const int row = warp * ROWS + f % ROWS, c4 = f / ROWS;
      const int r = q0 + row;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
      if (r < Lq) {
        x = *reinterpret_cast<const float4*>(qb + r * st.s[2] + 4 * c4);
        y = *reinterpret_cast<const float4*>(gb + r * st.s[11] + 4 * c4);
        const float4 z = *reinterpret_cast<const float4*>(ob + r * st.s[14] + 4 * c4);
        part = fmaf(y.x, z.x, part);
        part = fmaf(y.y, z.y, part);
        part = fmaf(y.z, z.z, part);
        part = fmaf(y.w, z.w, part);
      }
      *reinterpret_cast<float4*>(sQ + (c4 * BQ + row) * 4) = x;
      *reinterpret_cast<float4*>(sG + (c4 * BQ + row) * 4) = y;
    }
    dl_row = ROWS == 16 ? part + __shfl_xor_sync(0xffffffffu, part, 16) : part;
    const int r = q0 + warp * ROWS + lane;
    if (lane < ROWS && r < Lq) delta[row0 + r] = dl_row;
    __syncwarp();
  }
  float lse2[RI], dl[RI];  // of rows rg + 4i
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + warp * ROWS + rg + 4 * i;
    dl[i] = __shfl_sync(0xffffffffu, dl_row, rg + 4 * i);
    lse2[i] = r < Lq ? __fmul_rn(lse[row0 + r], LOG2E) : 0.f;
  }

  float acc[RI][Cols<D>::N];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < Cols<D>::N; ++c) acc[i][c] = 0.f;
  const float4* q4 = reinterpret_cast<const float4*>(sQ) + warp * ROWS + rg;  // + c4 BQ + 4i
  const float4* g4 = reinterpret_cast<const float4*>(sG) + warp * ROWS + rg;
  // this warp's ds slab: row r's 16-byte groups XOR-ed with 8 (r % 4)
  // floats (r % 4 = rg), so neither the writes nor the 16-byte reads of a
  // row group's four rows meet on a bank
  float* pw = sP + warp * C::SLAB;
  const int swz = rg * 8;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK, s = j % NS;
    const uint32_t parity = (j / NS) & 1;

    mbar_wait(&full_v[s], parity);
    float dp[RI][T];
    logit_tile<D, RI, T>(dp, g4, BQ, reinterpret_cast<const float4*>(sV + s * C::V_FLOATS) + cg, BK);
    release_stage(&done_v[s], active, j + NS < n_tiles, [&] { fetch_v(j + NS); });

    mbar_wait(&full_k[s], parity);
    const float* kt = sK + s * C::K_FLOATS;
    float sc[RI][T];
    logit_tile<D, RI, T>(sc, q4, BQ, reinterpret_cast<const float4*>(kt) + cg, KS);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const bool in = k0 + cg + 8 * t < Lk;  // K's rows past Lk read as zeros: their p is set to 0
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = in ? exp2_ftz(sc[i][t] - lse2[i]) : 0.f;
        pw[(rg + 4 * i) * BK + ((cg + 8 * t) ^ swz)] = p * (dp[i][t] - dl[i]);
      }
    }
    __syncwarp();  // the warp's ds is whole
    slab_product<D, RI, BK>(acc, pw, swz, kt, 4 * KS, rg, cg);
    // also orders the slab reads before the next tile's writes
    release_stage(&done_k[s], active, j + NS < n_tiles, [&] { fetch_k(j + NS); });
  }

  float* dqb = dq + b * st.s[15] + h * st.s[16];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + warp * ROWS + rg + 4 * i;
    if (r < Lq) store_cols<D>(dqb + r * st.s[17], acc[i], scale, cg);
  }
}

template <int D>
int launch(const void* qs, const void* k, const void* v, const void* g, const void* o, const float* lse, float* delta,
           void* dq, int B, int H, int Lq, int Lk, const Strides& st, float scale, cudaStream_t stream) {
  using C = DqCfg<D>;
  const auto kernel = flash_bwd_dq_f32_kernel<D>;
  static bool ready[MAX_DEVICES];
  cudaError_t err = prepare(kernel, C::smem(C::MAX_WARPS), ready);
  CUtensorMap mk, mv;
  if (err == cudaSuccess) err = chunk_map(&mk, k, B, H, Lk, D, st.s[3], st.s[4], st.s[5], C::KS);
  if (err == cudaSuccess) err = chunk_map(&mv, v, B, H, Lk, D, st.s[6], st.s[7], st.s[8], C::BK);
  if (err != cudaSuccess) return err;
  const long long bhs = static_cast<long long>(B) * H;
  const int warps = block_warps(bhs, Lq, C::ROWS, sm_count(), C::MAX_WARPS);
  const long long blocks = bhs * ((Lq + C::ROWS * warps - 1) / (C::ROWS * warps));
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<unsigned(blocks), 32 * warps, C::smem(warps), stream>>>(
      mk, mv, static_cast<const float*>(qs), static_cast<const float*>(g), static_cast<const float*>(o), lse, delta,
      static_cast<float*>(dq), H, Lq, Lk, st, scale);
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
