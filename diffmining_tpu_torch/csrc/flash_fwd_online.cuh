// The flash forward shared by flash_fwd_lse.cu (K4: the online softmax,
// also writing the per-row logsumexp), flash_fwd_online.cu (K3: the online
// softmax without it) and flash_fwd_nomax.cu (K1 and K2: exp2 without the
// running max). Written for Hopper (sm_90a): warpgroup wgmma for both
// products.
//
// Arithmetic of the online softmax, matching the TPU kernels step by step
// (flash_attention.py:59-87 for K4, :215-247 for K3; the two differ only in
// K4's lse output):
//   qs    = bf16(q * bf16(scale*log2e))               (the pre-scale, q's dtype)
//   s     = qs . k^T in fp32; keys past Lk get -1e30
//   m_new = max(m, rowmax(s)), alpha = exp2(m - m_new), m starts at -1e30
//   p     = exp2(s - m_new); pb = bf16(p)             (cast to v's dtype)
//   acc   = acc * alpha + pb . v,  l = l * alpha + sum pb   (l = the ones column)
//   o     = bf16(acc * (1 / max(l, 1e-30)))
//   lse   = m * ln2 + log(max(l, 1e-30))              (natural log, fp32; K4 only)
// The running max is taken per 128-key tile here (BLOCK_N, which
// ops/flash_attention.py names ONLINE_BLOCK_K) and per key block on the TPU
// (1024 keys, or the whole row up to 4096), so p is rounded to bf16 relative
// to a different max: the output agrees with the TPU kernels to a bf16 ulp
// or two, and exactly with the plain version run at block_k=128 up to
// summation order.
//
// The no-max mode (NOMAX, K1 and K2; flash_attention.py:250-330) drops the
// max, alpha and the rescale: p = exp2(s), masked keys 0, acc = sum pb . v,
// l = sum pb. With nothing carried but the sums, the tile size enters no
// rounding, so the plain version (flash_attention_nomax_plain) has no tile
// constant. A row whose natural logits are all below about -87 gets p = 0
// everywhere and outputs zeros: the designed underflow edge of the TPU
// kernels, kept (exp2 results below 2^-126 flush to zero as on the TPU).
//
// What bounds it on an H100 SXM: at B4 H8 L4096 D40 one call is 8.6e10
// tensor FLOP (QK^T and PV), 0.087 ms at the dense bf16 rate of 989
// TFLOP/s; each of its 5.4e8 logits takes one exp2 on the special-function
// units, 16 a clock per SM, ~0.13 ms at 132 SMs and 1.98 GHz, plus a max, a
// subtract, a conversion and a sum on the fp32 pipes; q, k, v, o and lse are
// 42 MB, 0.013 ms at 3.35 TB/s. At D=40 the exp2 and fp32 work per logit
// outweighs the products; at D=160 the products do. The no-max mode does
// the least exp2 work there is, one a logit; its measured time went with
// the K/V tiles the TMA unit brings, not with its exp2 or its products
// (flash_fwd_nomax.cu), so it brings each tile to more q rows.
//
// Design:
//   * one block of two warpgroups (256 threads) per (batch*head, 128-row q
//     tile); each warpgroup owns 64 q rows, so K and V are read from L2 once
//     per 128 q rows. The no-max mode runs four warpgroups a block at D=40
//     and three at D=80 (256 and 192 q rows, one block an SM);
//   * q is loaded once with 16-byte loads, pre-scaled in registers and
//     stored into shared memory; it stays there as wgmma's A operand;
//   * K and V stream through a ring of NSTAGE 128-key tiles that the TMA
//     unit fills (one thread issues a tile, an mbarrier per stage reports
//     its bytes). The 5-D tensor maps (8 elements, L, D/8, H, B) take the
//     views' own strides, so the UNet's [B, L, H*D] projections need no
//     copy, and cut each tile as [16-byte chunk][key], which is wgmma's
//     layout for both operands. The last of the block's warps to finish a
//     stage refills it: the warpgroups wait only for data, never for each
//     other, and no block-wide barrier runs in the loop;
//   * S = Q.K^T is wgmma m64n128k16 with both operands in shared memory
//     (K-major); the row max and p are computed in registers in the
//     accumulator layout (a row is held by the 4 threads of a quad); p is
//     rounded to bf16 and re-packed in registers as the A operand of
//     O += P.V, wgmma m64n{D}k16 with V MN-major in shared memory;
//   * only the ragged last key tile is masked;
//   * every tile uses wgmma's no-swizzle layout (hopper.cuh), which takes
//     head dim 40's 80-byte rows; q and k are padded with zeros to a
//     multiple of 16 along the head dim (40 -> 48) for the k16 steps, and
//     the pad is written once, since nothing else writes it;
//   * no producer warpgroup and no setmaxnreg: at D=40 two blocks of 256
//     threads (the no-max mode: one of 512) share an SM at 128 registers a
//     thread, which another warpgroup would not leave room for.
// Layout: q, k, v, o are [B, H, L, D] with arbitrary 16-byte-aligned
// element strides for B, H and L (head dim contiguous); lse is a contiguous
// [B, H, Lq] fp32 tensor.
//
// The channel-major layout (CM; K1 and K3 only, the counterparts of
// _flash_forward_cbl, flash_attention.py:499 and :517): q, k, v and o are
// [B, H, L, D] views whose L stride is 1 and whose B, H and D strides are
// 16-byte aligned, such as [B, H*D, L] (the UNet's channel-major world) or
// the JAX package's [H*D, B, L], read in place. The tiles, the ring and the
// loop stay; what changes is how the operands lie in shared memory:
//   * k comes by TMA as [key/8][DP][8 keys] (bdl_map: 16-byte chunks of
//     keys along L, the head-dim pad rows filled with zeros by the TMA
//     unit), which is wgmma's MN-major layout for the B operand of S = Q.K^T
//     (the descriptor's transpose bit);
//   * v comes as [key/8][D][8 keys], the K-major B operand of O = P.V;
//   * q is loaded along L, 8 rows of one head-dim column at a time,
//     pre-scaled and written element by element into the same K-major A
//     tile as the other layout's;
//   * o is stored from the accumulator's registers straight along its
//     columns: each warp store writes four 16-byte runs of 8 rows.
// The products and the softmax are the other layout's instruction for
// instruction, so the two layouts agree bit for bit on the same values.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int BLOCK_N = 128;  // keys a tile (ONLINE_BLOCK_K in ops/flash_attention.py)

template <int D, bool NOMAX>
struct OnlineCfg {
  static constexpr int DP = (D + 15) / 16 * 16;  // head dim padded to the k16 step
  static constexpr int CH = D / 8;               // 16-byte chunks of a row in device memory
  static constexpr int DPC = DP / 8;             // ... of a padded q or k row in shared memory
  // The online softmax: two warpgroups a block; D=40 at 78 KB of shared
  // memory and 128 registers a thread runs two blocks an SM, D=80 and D=160
  // take more registers and run one; rings of three tiles at D=40, two at
  // D=80 and D=160. The no-max mode brings each K/V tile to more q rows
  // instead (its time went with the tiles brought): four warpgroups at D=40
  // (128 registers a thread), three at D=80, one block an SM, each with a
  // ring of three tiles (rings of 4, 6 and 8 were slower), two at D=160.
  static constexpr int WARPGROUPS = NOMAX ? (D == 40 ? 4 : D == 80 ? 3 : 2) : 2;
  static constexpr int BLOCK_M = 64 * WARPGROUPS;  // q rows a block
  static constexpr int THREADS = 128 * WARPGROUPS;
  static constexpr int NSTAGE = NOMAX ? (D == 160 ? 2 : 3) : (D == 40 ? 3 : 2);
  static constexpr int MIN_BLOCKS = !NOMAX && D == 40 ? 2 : 1;
  static constexpr int Q_BYTES = BLOCK_M * DP * 2;
  static constexpr int K_BYTES = BLOCK_N * DP * 2;  // one stage of the ring
  static constexpr int V_BYTES = BLOCK_N * D * 2;
  static constexpr uint32_t TILE_BYTES = 2 * BLOCK_N * D * 2;  // what the TMA unit brings a stage: k and v
  // the stages, then a full barrier and a count of warps done for each
  static constexpr int SMEM = Q_BYTES + NSTAGE * (K_BYTES + V_BYTES) + NSTAGE * 16;
  // descriptor strides (hopper.cuh): q as [row/8][chunk][row%8] cells, k
  // and v as [chunk][key] cells, 16 bytes each
  static constexpr uint32_t Q_LBO = 128, Q_SBO = DPC * 128;
  static constexpr uint32_t K_LBO = BLOCK_N * 16, K_SBO = 128;
  static constexpr uint32_t V_LBO = 128, V_SBO = BLOCK_N * 16;
  // the channel-major layout: k as [key/8][DP][8 keys] cells (MN-major B),
  // v as [key/8][D][8 keys] (K-major B); the TMA unit brings the pad rows
  // of k as zeros
  static constexpr uint32_t KC_LBO = 128, KC_SBO = DP * 16;
  static constexpr uint32_t VC_LBO = D * 16, VC_SBO = 128;
  static constexpr uint32_t TILE_BYTES_CM = BLOCK_N * (DP + D) * 2;
};

// q rows [m0, m0 + BLOCK_M) pre-scaled in q's dtype, bf16(q * q_scale), into
// the K-major tile; rows past Lq and the pad chunk are zeros. In that layout
// the i-th 16-byte cell of the tile is simply at byte 16 i.
template <int D, bool NOMAX>
__device__ __forceinline__ void load_q_scaled(unsigned char* sq, const __nv_bfloat16* qb, long long q_sl, int m0,
                                              int Lq, float q_scale, int tid) {
  using C = OnlineCfg<D, NOMAX>;
  constexpr int TOTAL = C::BLOCK_M * C::DPC;
#pragma unroll
  for (int it = 0; it < (TOTAL + C::THREADS - 1) / C::THREADS; ++it) {
    const int i = tid + it * C::THREADS;
    if (TOTAL % C::THREADS == 0 || i < TOTAL) {
      const int c = (i / 8) % C::DPC;
      const int row = (i / (8 * C::DPC)) * 8 + i % 8;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (c < C::CH && m0 + row < Lq) {
        x = __ldg(reinterpret_cast<const uint4*>(qb + (long long)(m0 + row) * q_sl + c * 8));
        uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = unpack_bf16x2(w[e]);
          w[e] = pack_bf16x2(f.x * q_scale, f.y * q_scale);
        }
      }
      *reinterpret_cast<uint4*>(sq + i * 16) = x;
    }
  }
}

// The same tile from a channel-major q (L contiguous; sd its head-dim
// stride): each thread loads 8 rows of one head-dim column (16 bytes along
// L where all 8 lie below Lq) and writes them into the K-major tile one
// element at a time. Consecutive threads take consecutive row groups, so a
// warp reads 512 contiguous bytes of a column.
template <int D, bool NOMAX>
__device__ __forceinline__ void load_q_scaled_cm(unsigned char* sq, const __nv_bfloat16* qb, long long q_sd, int m0,
                                                 int Lq, float q_scale, int tid) {
  using C = OnlineCfg<D, NOMAX>;
  constexpr int RG = C::BLOCK_M / 8;  // 8-row groups of the tile
  constexpr int TOTAL = RG * C::DP;
#pragma unroll
  for (int it = 0; it < (TOTAL + C::THREADS - 1) / C::THREADS; ++it) {
    const int i = tid + it * C::THREADS;
    if (TOTAL % C::THREADS == 0 || i < TOTAL) {
      const int g = i % RG, d = i / RG;
      const int r0 = m0 + g * 8;
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
      if (d < D) {
        const __nv_bfloat16* col = qb + (long long)d * q_sd + r0;
        if (r0 + 8 <= Lq) {
          uint4 u = __ldg(reinterpret_cast<const uint4*>(col));
          const uint32_t* w = reinterpret_cast<const uint32_t*>(&u);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = unpack_bf16x2(w[e]);
            x[2 * e] = f.x;
            x[2 * e + 1] = f.y;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (r0 + e < Lq) x[e] = __bfloat162float(col[e]);
        }
      }
      __nv_bfloat16* cell = reinterpret_cast<__nv_bfloat16*>(sq + g * C::Q_SBO + (d / 8) * C::Q_LBO) + d % 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) cell[e * 8] = __float2bfloat16_rn(x[e] * q_scale);
    }
  }
}

// One 128-key tile of the online softmax for this warpgroup's 64 rows:
// S = Qs . K^T, the mask of keys past Lk, the running max and denominators
// (in the no-max mode none: p = exp2(s)), p rounded to bf16, O += P . V.
// Returns once both products have completed, so the tile's stage is free.
template <int D, bool NOMAX, bool CM>
__device__ __forceinline__ void online_tile(float (&acc)[D / 2], float& m_lo, float& m_hi, float& l_lo, float& l_hi,
                                            uint64_t desc_q, uint64_t dk, uint64_t dv, int key0, int Lk,
                                            int tig) {
  using C = OnlineCfg<D, NOMAX>;
  constexpr int NT = BLOCK_N / 8;   // 8-column blocks of S
  constexpr int PK = BLOCK_N / 16;  // k16 steps of P.V
  constexpr int QK = C::DP / 16;    // k16 steps of Q.K^T: two 16-byte chunks of q and k each
  // s is fresh each tile: the first k16 step does not read it (scale-d 0),
  // so no old value is kept alive
  float s[BLOCK_N / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < QK; ++kk)
    if constexpr (CM)
      wgmma_m64n128k16_ss<1>(s, desc_add(desc_q, kk * 2 * C::Q_LBO), desc_add(dk, kk * 2 * C::KC_LBO), kk);
    else
      wgmma_m64n128k16_ss(s, desc_add(desc_q, kk * 2 * C::Q_LBO), desc_add(dk, kk * 2 * C::K_LBO), kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);

  if (key0 + BLOCK_N > Lk) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (key0 + nt * 8 + tig * 2 + (e & 1) >= Lk) s[nt * 4 + e] = NEG_INF;
  }

  if constexpr (NOMAX) {
#pragma unroll
    for (int i = 0; i < BLOCK_N / 2; ++i) s[i] = ex2_ftz(s[i]);
  } else {
    // the tile's row max, over the quad that holds the row
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt * 4], s[nt * 4 + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt * 4 + 2], s[nt * 4 + 3]));
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float alpha_lo = ex2_ftz(m_lo - mx_lo);
    const float alpha_hi = ex2_ftz(m_hi - mx_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;

#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt * 4] = ex2_ftz(s[nt * 4] - m_lo);
      s[nt * 4 + 1] = ex2_ftz(s[nt * 4 + 1] - m_lo);
      s[nt * 4 + 2] = ex2_ftz(s[nt * 4 + 2] - m_hi);
      s[nt * 4 + 3] = ex2_ftz(s[nt * 4 + 3] - m_hi);
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt * 4] *= alpha_lo;
      acc[dt * 4 + 1] *= alpha_lo;
      acc[dt * 4 + 2] *= alpha_hi;
      acc[dt * 4 + 3] *= alpha_hi;
    }
    l_lo *= alpha_lo;
    l_hi *= alpha_hi;
  }

  // p rounded to bf16 as P.V's A operand; l sums the ROUNDED p, as the
  // ones column of the TPU kernel's PV product does
  uint32_t p[PK][4];
#pragma unroll
  for (int kk = 0; kk < PK; ++kk) {
    pack_a(p[kk], &s[kk * 8], &s[kk * 8 + 4]);
    const float2 a0 = unpack_bf16x2(p[kk][0]);
    const float2 a1 = unpack_bf16x2(p[kk][1]);
    const float2 a2 = unpack_bf16x2(p[kk][2]);
    const float2 a3 = unpack_bf16x2(p[kk][3]);
    l_lo += (a0.x + a0.y) + (a2.x + a2.y);
    l_hi += (a1.x + a1.y) + (a3.x + a3.y);
  }

  fence_regs(acc);
  fence_regs(p);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < PK; ++kk) {
    if constexpr (CM)
      wgmma_pv<D, 0>(acc, p[kk], desc_add(dv, kk * 2 * C::VC_LBO));
    else
      wgmma_pv<D>(acc, p[kk], desc_add(dv, kk * 2 * C::V_LBO));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(p);  // p's registers stay p's until the products have read them
}

// o = acc / l for rows r_lo and r_lo + 8 (those below Lq), and K4's lse.
template <int D, bool WRITE_LSE>
__device__ __forceinline__ void online_store(const float (&acc)[D / 2], float m_lo, float m_hi, float l_lo,
                                             float l_hi, __nv_bfloat16* ob, long long o_sl, float* lb, int r_lo,
                                             int Lq, int tig) {
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float ls_lo = fmaxf(l_lo, 1e-30f);
  const float ls_hi = fmaxf(l_hi, 1e-30f);
  const float inv_lo = 1.0f / ls_lo;
  const float inv_hi = 1.0f / ls_hi;
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + tig * 2;
    if (r_lo < Lq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r_lo * o_sl + col) =
          pack_bf16x2(acc[dt * 4] * inv_lo, acc[dt * 4 + 1] * inv_lo);
    if (r_hi < Lq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r_hi * o_sl + col) =
          pack_bf16x2(acc[dt * 4 + 2] * inv_hi, acc[dt * 4 + 3] * inv_hi);
  }
  if (WRITE_LSE && tig == 0) {
    if (r_lo < Lq) lb[r_lo] = m_lo * LN2 + logf(ls_lo);
    if (r_hi < Lq) lb[r_hi] = m_hi * LN2 + logf(ls_hi);
  }
}

// The same for a channel-major o (L contiguous; o_sd its head-dim stride):
// element stores along the columns the thread holds.
template <int D>
__device__ __forceinline__ void online_store_cm(const float (&acc)[D / 2], float l_lo, float l_hi,
                                                __nv_bfloat16* ob, long long o_sd, int r_lo, int Lq, int tig) {
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.0f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.0f / fmaxf(l_hi, 1e-30f);
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    __nv_bfloat16* col = ob + (long long)(dt * 8 + tig * 2) * o_sd;
    if (r_lo < Lq) {
      col[r_lo] = __float2bfloat16_rn(acc[dt * 4] * inv_lo);
      col[o_sd + r_lo] = __float2bfloat16_rn(acc[dt * 4 + 1] * inv_lo);
    }
    if (r_hi < Lq) {
      col[r_hi] = __float2bfloat16_rn(acc[dt * 4 + 2] * inv_hi);
      col[o_sd + r_hi] = __float2bfloat16_rn(acc[dt * 4 + 3] * inv_hi);
    }
  }
}

// One block: WARPGROUPS warpgroups, 64 q rows each, of one (batch, head);
// the key loop inside. The last of the block's warps done with a stage
// (counted in shared memory) has the TMA unit refill it, so a warpgroup
// waits only for its data, never for another warpgroup. The kernels below
// are this body under their own names (K3/K4's and K1/K2's, and the
// channel-major K3's and K1's), so a trace tells them apart. In the
// channel-major layout (CM) the third stride of q and o is the head dim's.
template <int D, bool WRITE_LSE, bool NOMAX, bool CM>
__device__ __forceinline__ void flash_fwd_block(const CUtensorMap& map_k, const CUtensorMap& map_v,
                                                const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o,
                                                float* __restrict__ lse, int H, int Lq, int Lk, long long q_sb,
                                                long long q_sh, long long q_sl, long long o_sb, long long o_sh,
                                                long long o_sl, float q_scale) {
  using C = OnlineCfg<D, NOMAX>;
  constexpr int NS = C::NSTAGE;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sQ = smem;
  unsigned char* sK = sQ + C::Q_BYTES;       // [NSTAGE][K_BYTES]
  unsigned char* sV = sK + NS * C::K_BYTES;  // [NSTAGE][V_BYTES]
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + NS * C::V_BYTES);  // [NSTAGE]
  int* done = reinterpret_cast<int*>(full + NS);                        // [NSTAGE] warps done with the stage

  const int tid = threadIdx.x;
  const int wg = tid / 128;  // this thread's warpgroup: q rows 64 wg ..
  const int lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int m0 = blockIdx.x * C::BLOCK_M;
  const int n_tiles = (Lk + BLOCK_N - 1) / BLOCK_N;

  auto fetch = [&](int t) {  // by one thread: tile t into stage t % NS
    const int st = t % NS;
    if constexpr (CM) {
      mbar_expect_tx(&full[st], C::TILE_BYTES_CM);
      tma_load_5d(sK + st * C::K_BYTES, &map_k, &full[st], 0, 0, t * (BLOCK_N / 8), h, b);
      tma_load_5d(sV + st * C::V_BYTES, &map_v, &full[st], 0, 0, t * (BLOCK_N / 8), h, b);
    } else {
      mbar_expect_tx(&full[st], C::TILE_BYTES);
      tma_load_5d(sK + st * C::K_BYTES, &map_k, &full[st], 0, t * BLOCK_N, 0, h, b);
      tma_load_5d(sV + st * C::V_BYTES, &map_v, &full[st], 0, t * BLOCK_N, 0, h, b);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      done[s] = 0;
    }
    fence_mbar_init();
  }
  if constexpr (!CM && C::DPC > C::CH) {  // k's zero pad chunks, [CH, DPC) of every stage
    constexpr int PAD = (C::DPC - C::CH) * BLOCK_N;
    for (int i = tid; i < NS * PAD; i += C::THREADS)
      *reinterpret_cast<uint4*>(sK + (i / PAD) * C::K_BYTES + C::CH * C::K_LBO + (i % PAD) * 16) =
          make_uint4(0, 0, 0, 0);
  }
  __syncthreads();  // the barriers are initialised
  if (tid == 0)
    for (int t = 0; t < NS && t < n_tiles; ++t) fetch(t);
  if constexpr (CM)
    load_q_scaled_cm<D, NOMAX>(sQ, q + b * q_sb + h * q_sh, q_sl, m0, Lq, q_scale, tid);
  else
    load_q_scaled<D, NOMAX>(sQ, q + b * q_sb + h * q_sh, q_sl, m0, Lq, q_scale, tid);
  fence_proxy_async();  // q and the pad, visible to wgmma
  __syncthreads();

  const uint64_t desc_q = make_desc(sQ + wg * 64 * C::DP * 2, C::Q_LBO, C::Q_SBO);
  const uint64_t desc_k = CM ? make_desc(sK, C::KC_LBO, C::KC_SBO) : make_desc(sK, C::K_LBO, C::K_SBO);
  const uint64_t desc_v = CM ? make_desc(sV, C::VC_LBO, C::VC_SBO) : make_desc(sV, C::V_LBO, C::V_SBO);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // running max (base 2; equal across the quad; unused without the max) and
  // partial denominators (this thread's columns) of rows lane/4 and
  // lane/4 + 8 of the warp's 16
  float m_lo = NEG_INF, m_hi = NEG_INF;
  float l_lo = 0.f, l_hi = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j % NS;
    mbar_wait(&full[stage], (j / NS) & 1);
    online_tile<D, NOMAX, CM>(acc, m_lo, m_hi, l_lo, l_hi, desc_q, desc_add(desc_k, stage * C::K_BYTES),
                          desc_add(desc_v, stage * C::V_BYTES), j * BLOCK_N, Lk, lane & 3);
    if (lane == 0) {  // this warp's reads of the stage are done
      __threadfence_block();
      if (atomicAdd(&done[stage], 1) == C::THREADS / 32 - 1) {
        done[stage] = 0;
        __threadfence_block();
        if (j + NS < n_tiles) fetch(j + NS);
      }
    }
  }
  const int r_lo = m0 + (tid / 32) * 16 + lane / 4;
  if constexpr (CM)
    online_store_cm<D>(acc, l_lo, l_hi, o + b * o_sb + h * o_sh, o_sl, r_lo, Lq, lane & 3);
  else
    online_store<D, WRITE_LSE>(acc, m_lo, m_hi, l_lo, l_hi, o + b * o_sb + h * o_sh, o_sl,
                               lse + (long long)bh * Lq, r_lo, Lq, lane & 3);
}

template <int D, bool WRITE_LSE>
__global__ void __launch_bounds__(OnlineCfg<D, false>::THREADS, OnlineCfg<D, false>::MIN_BLOCKS)
    flash_fwd_online_kernel(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                            const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int H, int Lq, int Lk, long long q_sb, long long q_sh,
                            long long q_sl, long long o_sb, long long o_sh, long long o_sl, float q_scale) {
  flash_fwd_block<D, WRITE_LSE, false, false>(map_k, map_v, q, o, lse, H, Lq, Lk, q_sb, q_sh, q_sl, o_sb, o_sh,
                                              o_sl, q_scale);
}

template <int D>
__global__ void __launch_bounds__(OnlineCfg<D, true>::THREADS, OnlineCfg<D, true>::MIN_BLOCKS)
    flash_fwd_nomax_kernel(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                           const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int H, int Lq, int Lk, long long q_sb, long long q_sh,
                           long long q_sl, long long o_sb, long long o_sh, long long o_sl, float q_scale) {
  flash_fwd_block<D, false, true, false>(map_k, map_v, q, o, lse, H, Lq, Lk, q_sb, q_sh, q_sl, o_sb, o_sh, o_sl,
                                         q_scale);
}

template <int D>
__global__ void __launch_bounds__(OnlineCfg<D, false>::THREADS, OnlineCfg<D, false>::MIN_BLOCKS)
    flash_fwd_online_cm_kernel(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                               const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o,
                               float* __restrict__ lse, int H, int Lq, int Lk, long long q_sb, long long q_sh,
                               long long q_sd, long long o_sb, long long o_sh, long long o_sd, float q_scale) {
  flash_fwd_block<D, false, false, true>(map_k, map_v, q, o, lse, H, Lq, Lk, q_sb, q_sh, q_sd, o_sb, o_sh, o_sd,
                                         q_scale);
}

template <int D>
__global__ void __launch_bounds__(OnlineCfg<D, true>::THREADS, OnlineCfg<D, true>::MIN_BLOCKS)
    flash_fwd_nomax_cm_kernel(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                              const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o,
                              float* __restrict__ lse, int H, int Lq, int Lk, long long q_sb, long long q_sh,
                              long long q_sd, long long o_sb, long long o_sh, long long o_sd, float q_scale) {
  flash_fwd_block<D, false, true, true>(map_k, map_v, q, o, lse, H, Lq, Lk, q_sb, q_sh, q_sd, o_sb, o_sh, o_sd,
                                        q_scale);
}

template <int D, bool WRITE_LSE, bool NOMAX, bool CM>
cudaError_t launch_online(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int Lq,
                          int Lk, const long long* st, float q_scale, cudaStream_t stream) {
  using C = OnlineCfg<D, NOMAX>;
  static_assert(!(CM && WRITE_LSE), "the channel-major layout has no lse mode");
  const auto kernel = [] {  // only the mode's own kernel is instantiated
    if constexpr (CM && NOMAX)
      return flash_fwd_nomax_cm_kernel<D>;
    else if constexpr (CM)
      return flash_fwd_online_cm_kernel<D>;
    else if constexpr (NOMAX)
      return flash_fwd_nomax_kernel<D>;
    else
      return flash_fwd_online_kernel<D, WRITE_LSE>;
  }();
  static bool ready[MAX_DEVICES];
  cudaError_t err = prepare(kernel, C::SMEM, ready);
  CUtensorMap mk, mv;
  if constexpr (CM) {
    if (err == cudaSuccess) err = bdl_map<D>(&mk, k, B, H, Lk, st[3], st[4], st[5], BLOCK_N, C::DP);
    if (err == cudaSuccess) err = bdl_map<D>(&mv, v, B, H, Lk, st[6], st[7], st[8], BLOCK_N, D);
  } else {
    if (err == cudaSuccess) err = bhld_map<D>(&mk, k, B, H, Lk, st[3], st[4], st[5], BLOCK_N);
    if (err == cudaSuccess) err = bhld_map<D>(&mv, v, B, H, Lk, st[6], st[7], st[8], BLOCK_N);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + C::BLOCK_M - 1) / C::BLOCK_M, B * H);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      mk, mv, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(o), lse, H, Lq, Lk, st[0], st[1],
      st[2], st[9], st[10], st[11], q_scale);
  return cudaGetLastError();
}

// D -> its instantiation; cudaErrorInvalidValue for another D.
template <bool WRITE_LSE, bool NOMAX = false, bool CM = false>
int launch_online_d(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int Lq, int Lk,
                    int D, const long long* st, float q_scale, cudaStream_t s) {
  switch (D) {
    case 40: return (int)launch_online<40, WRITE_LSE, NOMAX, CM>(q, k, v, o, lse, B, H, Lq, Lk, st, q_scale, s);
    case 80: return (int)launch_online<80, WRITE_LSE, NOMAX, CM>(q, k, v, o, lse, B, H, Lq, Lk, st, q_scale, s);
    case 160: return (int)launch_online<160, WRITE_LSE, NOMAX, CM>(q, k, v, o, lse, B, H, Lq, Lk, st, q_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
