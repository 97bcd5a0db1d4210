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

``sdpa_cbl`` is the channel-major counterpart (JAX attention.py:132-184,
the ``DIFFMINING_TF_CMAJOR=1`` transformer world): q [B, H*D, Lq], k/v [B,
H*D, Lk] -> [B, H*D, Lq] (the JAX package holds them [H*D, B, L]; the
port's NCHW activations make [B, C, L] a free view). The same gate sends a
call to the channel-major kernels (``flash_attention.forward_route_cbl``:
K1 or K3, reading the operands in place; under grad
``flash_attention_cbl``), everything else to ``sdpa_cbl_plain``;
``kernel_route_cbl`` names the wrappers on metadata.

``DIFFMINING_ATTN_BACKEND`` (JAX attention.py:24-45) is read once at
import, ``xla``, ``pallas`` or ``auto`` (the default; any other value
raises ValueError); ``set_attention_backend`` changes it. ``xla`` sends
every call of ``sdpa`` and ``sdpa_cbl`` to the plain path; ``pallas`` every
unmasked CUDA call whose dtype and head dim the kernels take
(``flash_attention.variant``) to the kernels, at its own lengths
(cross-attention and short levels included); ``auto`` applies the gate
above.

Unlike the JAX ``sdpa`` there is no try/except around the kernel: a gated
call launches it or raises; nothing casts to bf16 or pads the head dim.
Under ``pallas`` a call the kernels do not take (another dtype or head
dim) goes to the plain path by that metadata check, before any launch.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import torch

from diffmining_tpu_torch.ops.flash_attention import (
    FORWARD_CM,
    flash_attention,
    flash_attention_cbl,
    flash_fwd_lse,
    flash_fwd_nomax,
    flash_fwd_online,
    forward_route,
    forward_route_cbl,
    variant,
)

BACKENDS = ("xla", "pallas", "auto")
_BACKEND = os.environ.get("DIFFMINING_ATTN_BACKEND", "auto")
if _BACKEND not in BACKENDS:
    raise ValueError(f"DIFFMINING_ATTN_BACKEND={_BACKEND!r}: expected xla|pallas|auto")


def set_attention_backend(name: str) -> None:
    """Set the process-wide attention backend: 'xla' | 'pallas' | 'auto'."""
    global _BACKEND
    if name not in BACKENDS:
        raise ValueError(f"attention backend {name!r}: expected xla|pallas|auto")
    _BACKEND = name


def get_attention_backend() -> str:
    return _BACKEND


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
    """The dispatch gate on [B,H,L,D] metadata under the attention backend:
    never under ``xla`` or for a masked or CPU call; every other call under
    ``pallas`` (``kernels_take`` then checks its dtype and head dim); under
    ``auto`` self-attention with Lq == Lk >= 1024 at a head dim <= 160."""
    if masked or device.type != "cuda" or _BACKEND == "xla":
        return False
    if _BACKEND == "pallas":
        return True
    return q_shape[2] >= 1024 and q_shape[2] == k_shape[2] and q_shape[3] <= 160


def kernels_take(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether a call that passed the gate goes to the kernels: under
    ``pallas`` only where a kernel computes its dtype and head dim (the
    others take the plain path); under ``auto`` always (the wrappers raise
    on what no kernel computes, as before)."""
    if _BACKEND != "pallas":
        return True
    try:
        variant(dtype, head_dim)
    except ValueError:
        return False
    return True


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


# the wrapper (bf16 name; the float32 one adds "_f32") of each TPU kernel
# that _flash_forward_cbl launches, in the channel-major layout
WRAPPER_CBL = {"K1": "flash_fwd_nomax_cm", "K3": "flash_fwd_online_cm"}


def kernel_route_cbl(dtype: torch.dtype, head_dim: int, lq: int, lk: int, grad: bool) -> Route:
    """``kernel_route`` for a channel-major call (``sdpa_cbl``): under grad
    K4, K5 and K6 on head-dim-contiguous copies (JAX ``_fwd_cbl``/
    ``_bwd_cbl``), without grad the channel-major K1 or K3
    ``forward_route_cbl`` names."""
    suffix = variant(dtype, head_dim)
    if grad:
        kinds = ("K4", "K5", "K6")
        return Route(kinds, tuple(WRAPPER[k] + suffix for k in kinds))
    kind = forward_route_cbl(lq, lk)
    return Route((kind,), (WRAPPER_CBL[kind] + suffix,))


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
    if use_kernel(q.shape, k.shape, mask is not None, q.device) and kernels_take(q.dtype, q.shape[3]):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return flash_attention(q, k, v, scale)
        return FORWARD[forward_route(q.shape[2], k.shape[2])](q, k, v, scale)
    return sdpa_plain(q, k, v, mask=mask, scale=scale)


def split_cm(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, H*D, L] -> its [B, H, L, D] view (L stride 1 where x's is)."""
    return x.unflatten(1, (heads, x.shape[1] // heads)).transpose(2, 3)


def merge_cm(o: torch.Tensor) -> torch.Tensor:
    """[B, H, L, D] -> [B, H*D, L]: free for the channel-major kernels'
    output, a copy otherwise."""
    b, h, l, d = o.shape
    return o.transpose(2, 3).reshape(b, h * d, l)


def sdpa_cbl_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: float | None = None,
) -> torch.Tensor:
    """Channel-major attention, plain (counterpart of ``sdpa_cbl_xla``,
    attention.py:132-155): q [B, H*D, Lq], k/v [B, H*D, Lk] -> [B, H*D, Lq].
    fp32 logits and softmax over the head-split channel axis, weights cast to
    q's dtype before PV, autocast off, as ``sdpa_plain``."""
    b, hd, lq = q.shape
    d = hd // heads
    scale = scale if scale is not None else 1.0 / (d**0.5)
    with torch.autocast(q.device.type, enabled=False):
        qh, kh = q.float().unflatten(1, (heads, d)), k.float().unflatten(1, (heads, d))
        logits = torch.matmul(qh.transpose(2, 3), kh) * scale  # [B, H, Lq, Lk]
        weights = torch.softmax(logits, dim=-1).to(q.dtype)
        o = torch.matmul(v.to(q.dtype).unflatten(1, (heads, d)), weights.transpose(2, 3))  # [B, H, D, Lq]
        return o.reshape(b, hd, lq)


# the port's channel-major wrapper for each TPU kernel _flash_forward_cbl
# launches (each hands float32 CUDA tensors to its float32 counterpart);
# flash_attention_cbl's own table
FORWARD_CBL = FORWARD_CM


def sdpa_cbl(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: float | None = None,
) -> torch.Tensor:
    """Channel-major sdpa: q [B, H*D, Lq], k/v [B, H*D, Lk] -> [B, H*D, Lq],
    through the gate and backend of ``sdpa`` (JAX sdpa_cbl,
    attention.py:157-184): the channel-major K1 or K3 on the operands in
    place, ``flash_attention_cbl`` under grad, else ``sdpa_cbl_plain``."""
    qh, kh, vh = (split_cm(t, heads) for t in (q, k, v))
    if use_kernel(qh.shape, kh.shape, False, q.device) and kernels_take(q.dtype, qh.shape[3]):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return merge_cm(flash_attention_cbl(qh, kh, vh, scale))
        return merge_cm(FORWARD_CBL[forward_route_cbl(qh.shape[2], kh.shape[2])](qh, kh, vh, scale))
    return sdpa_cbl_plain(q, k, v, heads, scale=scale)
