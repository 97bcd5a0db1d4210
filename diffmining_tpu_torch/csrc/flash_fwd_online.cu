// flash_fwd_online: non-causal softmax(q.k^T * scale).v with the running max
// (online softmax) and no lse, for the UNet's long self-attention without
// grad when the no-max modes are off (DIFFMINING_FLASH_ONESHOT=0 and
// DIFFMINING_FLASH_NOMAX=0), and wherever the key row spans several TPU key
// blocks below L=4096. Written for Hopper (sm_90a).
//
// Replaces diffmining_tpu/ops/flash_attention.py:199 _flash_kernel_t (via
// _flash_forward_t, :417, and _flash_forward_cbl, :517). Unlike the no-max
// kernel (flash_fwd_nomax.cu) it stays the softmax beyond the no-max
// envelope: where every natural logit of a row is below about -87, exp2
// without the max underflows to zero there, and here the running max keeps
// p = 1 at the row's largest logit.
//
// The arithmetic, what bounds it and the design are in flash_fwd_online.cuh,
// whose kernel this source instantiates with the lse output off (K4's
// kernel, flash_fwd_lse.cu, is the same loop with it on).

#include "flash_fwd_online.cuh"

// Plain C entry point (loaded with ctypes). strides: 12 element strides,
// (batch, head, row) for q, k, v, o in that order. Returns the CUDA error of
// the launch (0 on success); D must be 40, 80 or 160.
extern "C" int flash_fwd_online(const void* q, const void* k, const void* v, void* o, int B, int H, int Lq, int Lk,
                                int D, const long long* strides, float q_scale, void* stream) {
  return launch_online_d<false>(q, k, v, o, nullptr, B, H, Lq, Lk, D, strides, q_scale,
                                static_cast<cudaStream_t>(stream));
}

// flash_fwd_online_cm: K3 on channel-major operands
// (diffmining_tpu/ops/flash_attention.py:517, _flash_forward_cbl's multi-
// block launch), for the channel-major transformer world
// (DIFFMINING_TF_CMAJOR=1). q, k, v and o are [B, H, L, D] views whose L
// stride is 1; strides: 12 element strides, (batch, head, head dim) for q, k,
// v, o in that order, each a multiple of 8. L need not be a multiple of 8 if
// the caller keeps the elements up to the next multiple readable (a padded
// buffer); they are masked. Returns the CUDA error of the launch (0 on
// success); D must be 40, 80 or 160.
extern "C" int flash_fwd_online_cm(const void* q, const void* k, const void* v, void* o, int B, int H, int Lq, int Lk,
                                    int D, const long long* strides, float q_scale, void* stream) {
  return launch_online_d<false, false, true>(q, k, v, o, nullptr, B, H, Lq, Lk, D, strides, q_scale,
                                            static_cast<cudaStream_t>(stream));
}
