"""Attention dispatch (counterpart of diffmining_tpu/ops/attention.py).

``sdpa`` sends the UNet's long self-attention to the hand-written no-max
flash kernel and everything else to ``sdpa_plain``, the counterpart of
``sdpa_xla``. The gate is the JAX package's (attention.py:75-94: self-
attention with Lq == Lk >= 1024, head dim <= 160, no mask) on CUDA
tensors. Cross-attention (Lk = 77), L <= 256, the VAE's single-head
D = 512, CLIP's causal mask and every CPU tensor take the plain path. The
kernel is bf16 only: a float32 CUDA tensor at a gated shape raises in the
wrapper, so float32 validation runs on the CPU.

Unlike the JAX ``sdpa`` there is no try/except around the kernel: a gated
call launches it or raises.
"""
from __future__ import annotations

import torch

from diffmining_tpu_torch.ops.flash_attention import flash_fwd_nomax


def sdpa_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """q [B,H,Lq,D], k/v [B,H,Lk,D] -> [B,H,Lq,D]. fp32 logits and softmax,
    weights cast to q's dtype before PV, as ``sdpa_xla`` does; ``mask`` is
    boolean, True where attention is allowed."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d**0.5)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(weights, v)


def use_kernel(q_shape, k_shape, masked: bool, device: torch.device) -> bool:
    """The dispatch gate, on metadata only."""
    return (
        not masked
        and device.type == "cuda"
        and q_shape[2] >= 1024
        and q_shape[2] == k_shape[2]
        and q_shape[3] <= 160
    )


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    if use_kernel(q.shape, k.shape, mask is not None, q.device):
        return flash_fwd_nomax(q, k, v, scale)
    return sdpa_plain(q, k, v, mask=mask, scale=scale)
