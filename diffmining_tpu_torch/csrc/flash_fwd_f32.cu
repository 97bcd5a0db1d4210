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
// What bounds it on an H100 SXM: a call is 4 B H Lq Lk D fp32 operations
// for the two products (the exp2 and the row sums are a few more a logit),
// against 67 TFLOP/s outside the tensor cores: at B4 H8 L4096 D40 8.6e10
// operations, 1.28 ms; q, k, v and o are 84 MB, 0.025 ms at 3.35 TB/s. It is
// bound by its operations at every shape the paths give it. An SM issues one
// warp's FFMA a clock on each of its four schedulers, so the products run
// near that rate only while shared-memory reads, exp2, shuffles and waits
// take few of the issue slots.
//
// Design. One block of eight warps a (128-row q tile, head, batch); each
// warp owns 16 q rows from S to O, so nothing but the K/V ring is shared
// and no instruction waits for the whole block:
//   * S = qs . K^T: a lane holds a 4 x 8 register tile of S (rows r + 4i of
//     the warp's 16, keys c + 8t of the 64-key tile; lane = 8r + c). A
//     16-byte read of q and of k feeds 4 FMA each: 12 reads for 128 FMA.
//     q is pre-scaled once into shared memory, K comes chunk-major ([D/4]
//     [64 keys][4]), so a warp's reads cover 64 and 128 contiguous bytes:
//     no bank conflicts.
//   * P goes through a per-warp slab ([16][64], its 16-byte groups XOR-ed
//     with the row, only __syncwarp), and a lane's O tile is the same 4
//     rows x D/8 columns (32j + 4c .. and, at D = 40 and 80, 32 J + c or
//     2c ..: no padded column), so P . V reads a row of P 16 bytes at a
//     time and 16 bytes of each V row: 12 reads for 128 FMA at D = 64, 24
//     for 320 at D = 160. The row max is three shuffles; the row sum is
//     carried per lane and reduced once at the end.
//   * K and V come by TMA (a 5-D map of the strided view for K's
//     chunk-major tile, a 4-D one for V's row-major tile; rows past Lk read
//     as zeros) into two rings of 64-key stages with an mbarrier each. The
//     last of the block's warps done with a stage (K after its S, V after
//     its P . V; counted in shared memory) has the TMA unit refill it, so a
//     warp waits for data only; K's next tile lands during P . V, V's during
//     the next S.
//   * Shared memory decides the rest: at D = 40 (two stages each, 92 KB)
//     and D = 64 (one each, 96 KB) two blocks share an SM at 128 registers
//     a thread; at D = 80 (two each, 152 KB) and D = 160 (one each, 192 KB)
//     one block an SM, at 168 and 254 registers.
//   * Ragged grids: the blocks of every head's whole q tiles come first and
//     the ragged last tiles after them, and a last tile runs only the warps
//     that hold a row (L = 1025: one warp of eight), so it costs 16 rows of
//     work, not 128. Where 8 warps a block would leave a second wave of
//     blocks less than half full (B2 H8 L1100 at D = 80 and 160: 144 blocks
//     for 132 slots), a block takes 4 warps (64 rows): 288 blocks.
//
// The channel-major layout (CM; the online and no-max modes, the
// counterparts of _flash_forward_cbl, flash_attention.py:499 and :517): q,
// k, v and o are [B, H, L, D] views whose L stride is 1 and whose B, H and
// D strides are multiples of 4, such as [B, H*D, L] or the JAX package's
// [H*D, B, L], read in place. The blocks, warps, rings and register tiles
// stay; K and V come by one 4-D map (L, D, H, B) each as [D][keys] tiles
// (keys past Lk read as zeros). A lane's 8 logit columns are keys 4 cg ..
// 4 cg + 3 and 32 + 4 cg .. + 3 (two 16-byte reads of a K row a head-dim
// element, the 8 lanes of a row group on 8 bank groups); its output
// columns are cg + 8 j, and P . V reads 4 keys of one V row at a time from
// rows padded to 68 floats (a box of 68 keys), so the 8 lanes of a row
// group read 8 bank groups there too. q is loaded 4 rows of one column at
// a time into the same chunk-major tile, and o is stored column by column.
// Each logit and each output sum adds the same terms in the same order as
// the other layout; only the per-lane parts of l are summed in another.

#include "flash_f32.cuh"

namespace {

using namespace f32attn;
using namespace hopper;

constexpr int BK = TILE;  // keys a K/V tile (F32_BLOCK_K: the online mode's max is per tile)

template <int D>
struct FwdCfg {
  static constexpr int MAX_WARPS = 8;  // 16 q rows each; a launch takes 8 or 4
  static constexpr int THREADS = 32 * MAX_WARPS;
  static constexpr int NSK = D == 40 || D == 80 ? 2 : 1;  // stages of the K ring
  static constexpr int NSV = NSK;                         // and of the V ring
  static constexpr int MIN_BLOCKS = D <= 64 ? 2 : 1;
  static constexpr int J = Cols<D>::J;      // 16-byte column groups a lane holds in O
  static constexpr int R = Cols<D>::R;      // and single columns past them (0, 1 or 2)
  static constexpr int CPL = Cols<D>::N;    // columns a lane holds: D / 8
  static constexpr int KV_FLOATS = BK * D;  // a K stage [D/4][BK][4] or a V stage [BK][D]
  static constexpr int VROW_CM = BK + 4;    // a channel-major V row: 64 keys and 4 of the next tile
  static constexpr int V_FLOATS_CM = VROW_CM * D;  // a channel-major V stage [D][VROW_CM]
  static constexpr int P_FLOATS = 16 * BK;  // a warp's P slab [16][BK], 16-byte groups swizzled by row
  // bytes of shared memory at `warps` warps: q [D/4][16 warps][4], the rings, the slabs, the barriers
  static constexpr int smem(int warps, bool cm) {
    return (16 * warps * D + NSK * KV_FLOATS + NSV * (cm ? V_FLOATS_CM : KV_FLOATS) + warps * P_FLOATS) * 4 +
           (NSK + NSV) * int(sizeof(uint64_t) + sizeof(int));
  }
};

// over the 8 lanes of a row group (lane = 8r + c)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D, int MODE, bool CM = false>
__global__ void __launch_bounds__(FwdCfg<D>::THREADS, FwdCfg<D>::MIN_BLOCKS)
    flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                         const float* __restrict__ q, float* __restrict__ o, float* __restrict__ lse, int H, int Lq,
                         int Lk, long long q_sb, long long q_sh, long long q_sl, long long o_sb, long long o_sh,
                         long long o_sl, float q_scale) {
  using C = FwdCfg<D>;
  constexpr bool NOMAX = MODE == 1;
  constexpr int CPL = C::CPL, J = C::J;
  constexpr uint32_t KV_BYTES = C::KV_FLOATS * 4;
  constexpr int V_FLOATS = CM ? C::V_FLOATS_CM : C::KV_FLOATS;  // a V stage
  const int warps = blockDim.x / 32, BQ = 16 * warps;

  extern __shared__ __align__(128) float smem[];
  float* sQ = smem;                          // [D/4][BQ][4], pre-scaled
  float* sK = sQ + BQ * D;                   // [NSK] stages [D/4][BK][4] (CM: [D][BK])
  float* sV = sK + C::NSK * C::KV_FLOATS;    // [NSV] stages [BK][D] (CM: [D][VROW_CM])
  float* sP = sV + C::NSV * V_FLOATS;        // [warps] slabs [16][BK]
  uint64_t* full_k = reinterpret_cast<uint64_t*>(sP + warps * C::P_FLOATS);
  uint64_t* full_v = full_k + C::NSK;
  int* done_k = reinterpret_cast<int*>(full_v + C::NSV);  // warps done with each stage
  int* done_v = done_k + C::NSK;

  // the block's (q tile, head, batch): every head's whole tiles first, then
  // the ragged last tiles, so the cheap blocks fill the last wave
  const int whole = Lq / BQ, bhs = gridDim.x / ((Lq + BQ - 1) / BQ);
  const int bid = blockIdx.x;
  const int tile = bid < whole * bhs ? bid % whole : whole;
  const int bh = bid < whole * bhs ? bid / whole : bid - whole * bhs;
  const int h = bh % H, b = bh / H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = lane / 8, cg = lane % 8;  // row group (rows rg + 4i of the warp's 16); key or column group
  const int q0 = tile * BQ;
  const int n_tiles = (Lk + BK - 1) / BK;
  const int active = min(warps, (Lq - q0 + 15) / 16);  // warps that hold a q row

  auto fetch_k = [&](int t) {
    const int st = t % C::NSK;
    mbar_expect_tx(&full_k[st], KV_BYTES);
    if constexpr (CM)
      tma_load_4d(sK + st * C::KV_FLOATS, &map_k, &full_k[st], t * BK, 0, h, b);
    else
      tma_load_5d(sK + st * C::KV_FLOATS, &map_k, &full_k[st], 0, t * BK, 0, h, b);
  };
  auto fetch_v = [&](int t) {
    const int st = t % C::NSV;
    mbar_expect_tx(&full_v[st], V_FLOATS * 4);
    if constexpr (CM)
      tma_load_4d(sV + st * V_FLOATS, &map_v, &full_v[st], t * BK, 0, h, b);
    else
      tma_load_4d(sV + st * C::KV_FLOATS, &map_v, &full_v[st], 0, t * BK, h, b);
  };
  // this warp is done reading a stage; the last active warp refills it with tile t
  auto release = [&](int* done, int st, int t, bool k_ring) {
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(&done[st], 1) == active - 1) {
        done[st] = 0;
        __threadfence_block();
        if (t < n_tiles) {
          fence_proxy_async();
          if (k_ring)
            fetch_k(t);
          else
            fetch_v(t);
        }
      }
    }
  };

  if (tid == 0) {
    for (int s = 0; s < C::NSK; ++s) {
      mbar_init(&full_k[s], 1);
      done_k[s] = 0;
    }
    for (int s = 0; s < C::NSV; ++s) {
      mbar_init(&full_v[s], 1);
      done_v[s] = 0;
    }
    fence_mbar_init();
  }
  __syncthreads();  // the barriers are initialised
  if (warp >= active) return;
  if (tid == 0) {
    for (int t = 0; t < C::NSK && t < n_tiles; ++t) fetch_k(t);
    for (int t = 0; t < C::NSV && t < n_tiles; ++t) fetch_v(t);
  }

  // this warp's 16 q rows, pre-scaled, chunk-major; rows past Lq are zeros and are never stored
  if constexpr (CM) {  // 4 rows of one column a lane at a time (q_sl is the head-dim stride)
    const float* qb = q + b * q_sb + h * q_sh;
    for (int f = lane; f < 4 * D; f += 32) {
      const int row = warp * 16 + (f % 4) * 4, d = f / 4;
      const int r = q0 + row;
      const float* col = qb + d * q_sl + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r + 4 <= Lq) {
        x = *reinterpret_cast<const float4*>(col);
      } else {
        if (r < Lq) x.x = col[0];
        if (r + 1 < Lq) x.y = col[1];
        if (r + 2 < Lq) x.z = col[2];
      }
      float* cell = sQ + ((d / 4) * BQ + row) * 4 + d % 4;
      cell[0] = x.x * q_scale;
      cell[4] = x.y * q_scale;
      cell[8] = x.z * q_scale;
      cell[12] = x.w * q_scale;
    }
    __syncwarp();
  } else {
    const float* qb = q + b * q_sb + h * q_sh;
    for (int f = lane; f < 16 * (D / 4); f += 32) {
      const int row = warp * 16 + f % 16, c4 = f / 16;
      const int r = q0 + row;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < Lq) {
        x = *reinterpret_cast<const float4*>(qb + r * q_sl + 4 * c4);
        x.x *= q_scale;
        x.y *= q_scale;
        x.z *= q_scale;
        x.w *= q_scale;
      }
      *reinterpret_cast<float4*>(sQ + (c4 * BQ + row) * 4) = x;
    }
    __syncwarp();
  }

  // the head-dim column of the lane's c-th output value in the channel-major
  // layout (the other layout's are Cols')
  auto out_col = [&](int c) { return cg + 8 * c; };
  float acc[4][CPL], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[i][c] = 0.f;
  }
  const float4* q4 = reinterpret_cast<const float4*>(sQ) + warp * 16 + rg;  // + c4 BQ + 4i
  // this warp's P slab: row r's 16-byte groups XOR-ed with (r % 4) * 4 floats
  // (r % 4 = rg), so the row group's 16-byte reads of four rows hit four
  // bank groups
  float* pw = sP + warp * C::P_FLOATS;
  const int swz = rg * 4;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    const int ks = j % C::NSK;
    mbar_wait(&full_k[ks], (j / C::NSK) & 1);
    const float4* k4 = reinterpret_cast<const float4*>(sK + ks * C::KV_FLOATS) + cg;  // + c4 BK + 8t
    // the lane's 8 logit columns: keys cg + 8t, or in the channel-major
    // layout 4 cg + t and 32 + 4 cg + t - 4
    auto key_of = [&](int t) { return CM ? (t < 4 ? 0 : 32) + 4 * cg + (t & 3) : cg + 8 * t; };

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int t = 0; t < 8; ++t) s[i][t] = 0.f;
    if constexpr (CM) {
#pragma unroll 2
      for (int c4 = 0; c4 < D / 4; ++c4) {
        float4 a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = q4[c4 * BQ + 4 * i];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 lo = k4[(4 * c4 + e) * (BK / 4)], hi = k4[(4 * c4 + e) * (BK / 4) + 8];
          const float kv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float qe = lane_of(a[i], e);
#pragma unroll
            for (int t = 0; t < 8; ++t) s[i][t] = fmaf(qe, kv[t], s[i][t]);
          }
        }
      }
    } else {
#pragma unroll 2
    for (int c4 = 0; c4 < D / 4; ++c4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q4[c4 * BQ + 4 * i];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float4 kv = k4[c4 * BK + 8 * t];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][t] = fmaf(a[i].x, kv.x, s[i][t]);
          s[i][t] = fmaf(a[i].y, kv.y, s[i][t]);
          s[i][t] = fmaf(a[i].z, kv.z, s[i][t]);
          s[i][t] = fmaf(a[i].w, kv.w, s[i][t]);
        }
      }
    }
    }
    release(done_k, ks, j + C::NSK, true);

    if (k0 + BK > Lk) {
#pragma unroll
      for (int t = 0; t < 8; ++t)
        if (k0 + key_of(t) >= Lk)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[i][t] = NEG_INF;
    }
    // p, the running max (online and lse modes) and the per-lane part of l
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float shift = 0.f;
      if (!NOMAX) {
        float mx = s[i][0];
#pragma unroll
        for (int t = 1; t < 8; ++t) mx = fmaxf(mx, s[i][t]);
        const float m_new = fmaxf(m[i], group_max(mx));
        const float alpha = exp2_ftz(m[i] - m_new);
        m[i] = m_new;
        shift = m_new;
        l[i] *= alpha;
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[i][c] *= alpha;
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float p = exp2_ftz(s[i][t] - shift);
        l[i] += p;
        pw[(rg + 4 * i) * BK + (key_of(t) ^ swz)] = p;
      }
    }
    __syncwarp();  // the warp's P is whole

    const int vs = j % C::NSV;
    mbar_wait(&full_v[vs], (j / C::NSV) & 1);
    const float* vt = sV + vs * V_FLOATS;
    if constexpr (CM) {
      // V as [D][BK]: 4 keys of one of the lane's columns a read, the keys
      // of each sum in the same order as below
#pragma unroll 2
      for (int kk = 0; kk < BK; kk += 4) {
        float4 pr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pr[i] = *reinterpret_cast<const float4*>(pw + (rg + 4 * i) * BK + (kk ^ swz));
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const float4 x = *reinterpret_cast<const float4*>(vt + out_col(c) * C::VROW_CM + kk);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float ve = lane_of(x, e);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(lane_of(pr[i], e), ve, acc[i][c]);
          }
        }
      }
    } else {
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = *reinterpret_cast<const float4*>(pw + (rg + 4 * i) * BK + (kk ^ swz));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = vt + (kk + e) * D;
        float vv[CPL];
#pragma unroll
        for (int g = 0; g < J; ++g) {
          const float4 x = *reinterpret_cast<const float4*>(vrow + 32 * g + 4 * cg);
          vv[4 * g] = x.x;
          vv[4 * g + 1] = x.y;
          vv[4 * g + 2] = x.z;
          vv[4 * g + 3] = x.w;
        }
        if constexpr (C::R == 1) {
          vv[4 * J] = vrow[32 * J + cg];
        } else if constexpr (C::R == 2) {
          const float2 x = *reinterpret_cast<const float2*>(vrow + 32 * J + 2 * cg);
          vv[4 * J] = x.x;
          vv[4 * J + 1] = x.y;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pe = lane_of(pr[i], e);
#pragma unroll
          for (int c = 0; c < CPL; ++c) acc[i][c] = fmaf(pe, vv[c], acc[i][c]);
        }
      }
    }
    }
    release(done_v, vs, j + C::NSV, false);  // also orders the P reads before the next tile's P writes
  }

  // l from the row group's parts; o = acc / max(l, 1e-30)
  float* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = fmaxf(group_sum(l[i]), 1e-30f);
    const float inv = 1.f / li;
    const int r = q0 + warp * 16 + rg + 4 * i;
    if (r >= Lq) continue;
    if (MODE == 2 && cg == 0) lse[(static_cast<long long>(b) * H + h) * Lq + r] = m[i] * LN2 + logf(li);
    if constexpr (CM) {  // column by column (o_sl is the head-dim stride)
#pragma unroll
      for (int c = 0; c < CPL; ++c) ob[out_col(c) * o_sl + r] = acc[i][c] * inv;
      continue;
    }
    float* row = ob + r * o_sl;
#pragma unroll
    for (int g = 0; g < J; ++g)
      *reinterpret_cast<float4*>(row + 32 * g + 4 * cg) =
          make_float4(acc[i][4 * g] * inv, acc[i][4 * g + 1] * inv, acc[i][4 * g + 2] * inv, acc[i][4 * g + 3] * inv);
    if constexpr (C::R == 1) {
      row[32 * J + cg] = acc[i][4 * J] * inv;
    } else if constexpr (C::R == 2) {
      *reinterpret_cast<float2*>(row + 32 * J + 2 * cg) = make_float2(acc[i][4 * J] * inv, acc[i][4 * J + 1] * inv);
    }
  }
}

// The 4-D map (L, D, H, B) of a channel-major [B, H, L, D] float32 view (L
// contiguous; element strides sb, sh, sd, multiples of 4) cut in [D][rows]
// tiles; keys past L read as zeros.
inline cudaError_t cm_map(CUtensorMap* map, const void* base, int B, int H, int L, int D, long long sb, long long sh,
                          long long sd, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)L, (cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sd * 4, (cuuint64_t)sh * 4, (cuuint64_t)sb * 4};
  const cuuint32_t box[4] = {(cuuint32_t)rows, (cuuint32_t)D, 1, 1};
  return encode_map(map, base, 4, dims, strides, box);
}

template <int D, int MODE, bool CM>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Lq, int Lk,
           const Strides& st, float q_scale, cudaStream_t stream) {
  using C = FwdCfg<D>;
  const auto kernel = flash_fwd_f32_kernel<D, MODE, CM>;
  static bool ready[MAX_DEVICES];
  cudaError_t err = prepare(kernel, C::smem(C::MAX_WARPS, CM), ready);
  CUtensorMap mk, mv;
  if constexpr (CM) {
    if (err == cudaSuccess) err = cm_map(&mk, k, B, H, Lk, D, st.s[3], st.s[4], st.s[5], BK);
    if (err == cudaSuccess) err = cm_map(&mv, v, B, H, Lk, D, st.s[6], st.s[7], st.s[8], C::VROW_CM);
  } else {
    if (err == cudaSuccess) err = chunk_map(&mk, k, B, H, Lk, D, st.s[3], st.s[4], st.s[5], BK);
    if (err == cudaSuccess) err = row_map(&mv, v, B, H, Lk, D, st.s[6], st.s[7], st.s[8], BK);
  }
  if (err != cudaSuccess) return err;
  // 8 warps (128 q rows), or 4 where 8 would leave the card a second wave
  // of blocks less than half full (B2 H8 L1100: 144 blocks of 8 warps for
  // 132 block slots at D = 80 and 160, 288 of 4 in 2.2 waves). 5 to 7 warps
  // put two warps on some of an SM's four schedulers: at D = 160 a block of
  // 5 ran as long as one of 8 (0.588 ms there against 0.508 with 4, on an
  // H100).
  const int warps =
      wave_warps(static_cast<long long>(B) * H * ((Lq + 127) / 128), C::MIN_BLOCKS * sm_count(), C::MAX_WARPS);
  const int rows = 16 * warps;
  const long long blocks = static_cast<long long>(B) * H * ((Lq + rows - 1) / rows);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<unsigned(blocks), 32 * warps, C::smem(warps, CM), stream>>>(
      mk, mv, static_cast<const float*>(q), static_cast<float*>(o), static_cast<float*>(lse), H, Lq, Lk, st.s[0],
      st.s[1], st.s[2], st.s[9], st.s[10], st.s[11], q_scale);
  return cudaGetLastError();
}

template <int D, bool CM>
int launch_mode(int mode, const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Lq,
                int Lk, const Strides& st, float q_scale, cudaStream_t s) {
  switch (mode) {
    case 0: return launch<D, 0, CM>(q, k, v, o, lse, B, H, Lq, Lk, st, q_scale, s);
    case 1: return launch<D, 1, CM>(q, k, v, o, lse, B, H, Lq, Lk, st, q_scale, s);
    case 2:
      if constexpr (CM) return cudaErrorInvalidValue;  // no lse mode in the channel-major layout
      else return launch<D, 2, false>(q, k, v, o, lse, B, H, Lq, Lk, st, q_scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool CM>
int launch_d(int D, int mode, const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Lq,
             int Lk, const long long* strides, float q_scale, void* stream) {
  Strides st;
  for (int i = 0; i < 12; ++i) st.s[i] = strides[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Lq <= 0 || Lk <= 0 || B <= 0 || H <= 0 || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  switch (D) {
    case 40: return launch_mode<40, CM>(mode, q, k, v, o, lse, B, H, Lq, Lk, st, q_scale, s);
    case 64: return launch_mode<64, CM>(mode, q, k, v, o, lse, B, H, Lq, Lk, st, q_scale, s);
    case 80: return launch_mode<80, CM>(mode, q, k, v, o, lse, B, H, Lq, Lk, st, q_scale, s);
    case 160: return launch_mode<160, CM>(mode, q, k, v, o, lse, B, H, Lq, Lk, st, q_scale, s);
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
  return launch_d<false>(D, mode, q, k, v, o, lse, B, H, Lq, Lk, strides, q_scale, stream);
}

// flash_fwd_f32_cm: the online (mode 0) and no-max (mode 1) modes on
// channel-major operands (_flash_forward_cbl's launches of K3 and K1,
// diffmining_tpu/ops/flash_attention.py:517 and :499, at float32): q, k,
// v and o are [B, H, L, D] views whose L stride is 1; strides: 12 element
// strides, (batch, head, head dim) for q, k, v, o in that order, each a
// multiple of 4 (L a multiple of 4 where L is a stride). Returns the CUDA
// error of the launch (0 on success); D must be 40, 64, 80 or 160.
extern "C" int flash_fwd_f32_cm(const void* q, const void* k, const void* v, void* o, int B, int H, int Lq, int Lk,
                                int D, int mode, const long long* strides, float q_scale, void* stream) {
  return launch_d<true>(D, mode, q, k, v, o, nullptr, B, H, Lq, Lk, strides, q_scale, stream);
}
