// flash_fwd_nomax: non-causal softmax(q.k^T * scale).v without the running
// max, for the UNet's long self-attention without grad under the default
// modes. Written for Hopper (sm_90a).
//
// Replaces two TPU kernels of diffmining_tpu/ops/flash_attention.py:
//   * _flash_kernel_t_1shot (:290, K1) — the whole key row in one VMEM
//     block, exp2 with scale*log2e folded into q, no max subtraction, the
//     denominator from a ones column appended to v;
//   * _flash_kernel_t_nomax (:250, K2) — the same arithmetic over several
//     key blocks, acc += exp2(q.k^T).[v|1] being the only carried state.
// A Hopper block cannot hold a key row (K+V at L=4096, D=40 in bf16 are
// 655 KB; a block has 227 KB), so the kernel loops over 128-key tiles;
// with no running max that loop is exactly the multi-block computation, so
// one kernel serves both.
//
// Arithmetic, matching the TPU kernels step by step:
//   qs = bf16(q * bf16(scale*log2e))      (the pre-scale, in q's dtype)
//   s  = qs . k^T                         (bf16 products, fp32 sum)
//   p  = exp2(s), results below 2^-126 -> 0, masked keys 0
//   pb = bf16(p)                          (cast to v's dtype before PV)
//   o  = bf16((sum pb . v) / max(sum pb, 1e-30))   (the sum of pb = the ones column)
// A row whose natural logits are all below about -87 outputs zeros: the
// designed underflow edge of the TPU kernels, kept.
//
// What bounds it on an H100 SXM (132 SMs, 1,980 MHz, 700 W): at B16 H8
// L4096 D40 one call is 2.1e9 logits. Its products are 3.4e11 tensor FLOP,
// 0.35 ms at the dense bf16 rate of 989 TFLOP/s (0.38 ms with q and k
// padded 40 -> 48); one exp2 a logit on the special-function units, 16 a
// clock per SM, is 0.51 ms; q, k, v and o are 168 MB, 0.05 ms at 3.35 TB/s.
// On paper the exp2 unit is the floor at D=40 and the products at D=80 and
// D=160. Measured, the two-warpgroup loop took 1.14 ms there with or
// without its exp2, and with or without its products, and 0.87 ms when the
// TMA unit brought K alone: the time went with the K/V tiles brought from
// L2 (20 KB a 128-key tile, cut into 16-byte rows), not with the
// arithmetic. Taking a share of the exp2 onto the FMA pipes lost time.
//
// Design: the online forward's kernel (flash_fwd_online.cuh) in its no-max
// mode, which drops the running max, its quad shuffles, alpha and the
// rescale; K and V in 128-key tiles through a TMA ring cut by 5-D tensor
// maps of the strided [B, L, H*D] views (no copy); S by wgmma m64n128k16;
// p rounded to bf16 in registers as the A operand of the wgmma P.V; l
// summed from the rounded p; masking only on the ragged last tile; the
// kernel's attributes set once per card. To bring each K/V tile to more q
// rows, a block runs four warpgroups (256 q rows) at D=40 and three (192)
// at D=80, one block an SM with a ring of three tiles; D=160 runs two, as
// the online forward does.

#include "flash_fwd_online.cuh"

// Plain C entry point (loaded with ctypes). strides: 12 element strides,
// (batch, head, row) for q, k, v, o in that order. Returns the CUDA error of
// the launch (0 on success); D must be 40, 80 or 160 (SD-v1.5's head dims).
extern "C" int flash_fwd_nomax(const void* q, const void* k, const void* v, void* o, int B, int H, int Lq, int Lk,
                               int D, const long long* strides, float q_scale, void* stream) {
  return launch_online_d<false, true>(q, k, v, o, nullptr, B, H, Lq, Lk, D, strides, q_scale,
                                      static_cast<cudaStream_t>(stream));
}

// flash_fwd_nomax_cm: K1 on channel-major operands
// (diffmining_tpu/ops/flash_attention.py:499, _flash_forward_cbl's one-shot
// launch), for the channel-major transformer world (DIFFMINING_TF_CMAJOR=1).
// q, k, v and o are [B, H, L, D] views whose L stride is 1; strides: 12
// element strides, (batch, head, head dim) for q, k, v, o in that order, each
// a multiple of 8. L need not be a multiple of 8 if the caller keeps the
// elements up to the next multiple readable (a padded buffer); they are
// masked. Returns the CUDA error of the launch (0 on success); D must be 40,
// 80 or 160.
extern "C" int flash_fwd_nomax_cm(const void* q, const void* k, const void* v, void* o, int B, int H, int Lq, int Lk,
                                   int D, const long long* strides, float q_scale, void* stream) {
  return launch_online_d<false, true, true>(q, k, v, o, nullptr, B, H, Lq, Lk, D, strides, q_scale,
                                           static_cast<cudaStream_t>(stream));
}
