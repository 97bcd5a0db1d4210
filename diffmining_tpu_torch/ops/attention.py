"""Attention dispatch (counterpart of diffmining_tpu/ops/attention.py).

``sdpa`` sends the UNet's long self-attention to the hand-written flash
kernels and everything else to ``sdpa_plain``, the counterpart of
``sdpa_xla``. The gate is the JAX package's (attention.py:75-94: self-
attention with Lq == Lk >= 1024, head dim <= 160, no mask) on CUDA
tensors. A gated call with grad enabled and an input that requires grad
goes to ``flash_attention`` (forward K4, backward K5/K6), as the JAX
custom_vjp's fwd rule does. Every other gated call takes the forward the
JAX primal takes under the same settings (``flash_attention.forward_route``:
``DIFFMINING_FLASH_ONESHOT``, ``DIFFMINING_FLASH_NOMAX``,
``DIFFMINING_ATTN_TLAYOUT``, the block policy): K1 and K2 run
``flash_fwd_nomax``, K3 ``flash_fwd_online`` and K4 ``flash_fwd_lse`` with
the lse dropped. Under the default settings at 512px every gated call is
K1. Cross-attention (Lk = 77), L <= 256, the VAE's single-head D = 512,
CLIP's causal mask and every CPU tensor take the plain path. A float32 CUDA
forward without grad at head dim 64 (the CLIP vision towers at crops of 448
px and more: L = 1025 takes K3, L = 4097 K2, as in JAX) runs the float32
kernel in the same mode; every other float32 CUDA tensor at a gated shape
raises in the wrapper (so ``--mixed_precision no`` training raises on the
card at the first gated attention), and float32 UNet validation runs on the
CPU.

Unlike the JAX ``sdpa`` there is no try/except around the kernel: a gated
call launches it or raises.
"""
from __future__ import annotations

import torch

from diffmining_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_fwd_lse,
    flash_fwd_nomax,
    flash_fwd_online,
    forward_route,
)


def sdpa_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """q [B,H,Lq,D], k/v [B,H,Lk,D] -> [B,H,Lq,D]. fp32 logits and softmax,
    weights cast to q's dtype before PV, as ``sdpa_xla`` does; ``mask`` is
    boolean, True where attention is allowed. Autocast is off inside, so the
    logits stay fp32 under mixed-precision training too."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d**0.5)
    with torch.autocast(q.device.type, enabled=False):
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
        weights = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.matmul(weights, v.to(q.dtype))


def use_kernel(q_shape, k_shape, masked: bool, device: torch.device) -> bool:
    """The dispatch gate, on metadata only."""
    return (
        not masked
        and device.type == "cuda"
        and q_shape[2] >= 1024
        and q_shape[2] == k_shape[2]
        and q_shape[3] <= 160
    )


def _lse_dropped(q, k, v, scale):
    return flash_fwd_lse(q, k, v, scale)[0]


# the port's wrapper for each TPU forward kernel
FORWARD = {"K1": flash_fwd_nomax, "K2": flash_fwd_nomax, "K3": flash_fwd_online, "K4": _lse_dropped}


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    if use_kernel(q.shape, k.shape, mask is not None, q.device):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return flash_attention(q, k, v, scale)
        return FORWARD[forward_route(q.shape[2], k.shape[2])](q, k, v, scale)
    return sdpa_plain(q, k, v, mask=mask, scale=scale)
