// flash_fwd_lse: non-causal softmax(q.k^T * scale).v with the running max,
// that also writes the per-row natural-log logsumexp, for the UNet's long
// self-attention under differentiation. Written for Hopper (sm_90a).
//
// Replaces diffmining_tpu/ops/flash_attention.py:37 _flash_kernel (via
// _flash_forward(..., return_lse=True), :142): the forward rule of the
// custom_vjp, whose lse the backward kernels (flash_bwd_dq.cu,
// flash_bwd_dkv.cu) re-form the softmax from.
//
// The arithmetic, what bounds it and the design are in flash_fwd_online.cuh,
// whose kernel this source instantiates with the lse output on.

#include "flash_fwd_online.cuh"

// Plain C entry point (loaded with ctypes). strides: 12 element strides,
// (batch, head, row) for q, k, v, o in that order; lse is a contiguous
// [B, H, Lq] float32 buffer. Returns the CUDA error of the launch (0 on
// success); D must be 40, 80 or 160.
extern "C" int flash_fwd_lse(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Lq,
                             int Lk, int D, const long long* strides, float q_scale, void* stream) {
  return launch_online_d<true>(q, k, v, o, static_cast<float*>(lse), B, H, Lq, Lk, D, strides, q_scale,
                               static_cast<cudaStream_t>(stream));
}
