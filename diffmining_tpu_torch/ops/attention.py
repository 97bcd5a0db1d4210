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
CLIP's causal mask and every CPU tensor take the plain path.

``kernel_route`` names, on metadata only, the wrappers a gated CUDA call
runs (each wrapper picks its bf16 or float32 kernel by the same
``flash_attention.variant``): bf16 operands at SD-v1.5's head dims (40, 80,
160) take the bf16 kernels; float32 operands at those and the CLIP towers'
64 take the float32 kernels
(``flash_fwd_f32`` in the mode the route names, and under grad its lse mode
with ``flash_bwd_dq_f32`` and ``flash_bwd_dkv_f32``), as the JAX kernels
compute in their operands' dtype: so ``--dtype fp32`` runs and ``finetune
--mixed_precision no`` run on the card. Any other dtype or head dim at a
gated shape raises.

Unlike the JAX ``sdpa`` there is no try/except around the kernel: a gated
call launches it or raises; nothing casts to bf16 or pads the head dim.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from diffmining_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_fwd_lse,
    flash_fwd_nomax,
    flash_fwd_online,
    forward_route,
    variant,
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


class Route(NamedTuple):
    """The TPU kernels a gated call replaces and the port's wrappers that
    launch their counterparts, in order."""
    kinds: Tuple[str, ...]
    wrappers: Tuple[str, ...]


# the wrapper (bf16 name; the float32 one adds "_f32") of each TPU kernel
WRAPPER = {"K1": "flash_fwd_nomax", "K2": "flash_fwd_nomax", "K3": "flash_fwd_online", "K4": "flash_fwd_lse",
           "K5": "flash_bwd_dq", "K6": "flash_bwd_dkv"}


def kernel_route(dtype: torch.dtype, head_dim: int, lq: int, lk: int, grad: bool) -> Route:
    """The kernels a gated call launches, on metadata only: under grad the
    forward with the lse (K4), then K5 and K6 in the backward; without grad
    the forward ``forward_route`` names. bf16 at ``HEAD_DIMS`` names the
    bf16 wrappers, float32 at ``F32_HEAD_DIMS`` the float32 ones
    (``flash_attention.variant``); any other dtype or head dim raises."""
    suffix = variant(dtype, head_dim)
    kinds = ("K4", "K5", "K6") if grad else (forward_route(lq, lk),)
    return Route(kinds, tuple(WRAPPER[k] + suffix for k in kinds))


def _lse_dropped(q, k, v, scale):
    return flash_fwd_lse(q, k, v, scale)[0]


# the port's wrapper for each TPU forward kernel (each hands float32 CUDA
# tensors to its float32 counterpart)
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
