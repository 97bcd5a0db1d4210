"""Fused GroupNorm → optional SiLU → 1x1 projection (counterpart of
diffmining_tpu/ops/fused_norm.py), the entry of every SpatialTransformer on
the inference paths when ``DIFFMINING_FUSED_NORM=1``.

  gn_act_proj        the wrapper: per-(batch, group) statistics in fp32 with
                     plain torch (as XLA computes them in JAX, fused_norm.py:
                     68-77), then the hand-written CUDA kernel
                     ``csrc/gn_act_proj.cu`` (TPU ``_gn_act_matmul_kernel``,
                     K7) for a CUDA tensor, or ``gn_act_proj_plain`` for a
                     CPU tensor;
  gn_act_proj_plain  the kernel's arithmetic step by step in PyTorch;
  gn_act_proj_xla    the reference chain (fused_norm.py:107).

x is [B, H, W, C] as in JAX. The kernel reads it in place in either
layout the UNet hands it: the NCHW activations viewed as NHWC
(``x.permute(0, 2, 3, 1)``, pixels contiguous) or channels-last ones (after
a transformer's proj_out, channels contiguous); it writes [B, H, W, Cout]
contiguous, so the transformer's [B, L, C] input needs no copy. Forward
only, as in JAX (:60-62): the wrapper raises under grad.
"""
from __future__ import annotations

from typing import Tuple

import torch

from diffmining_tpu_torch.ops.flash_attention import _launch, _requires_grad

ACTS = ("none", "silu")
K_CHUNK, COUT_TILE = 32, 64  # the kernel's input-channel chunk and output-channel tile


def group_stats(x: torch.Tensor, groups: int, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, rsigma) [B, C] float32 of x [B, H, W, C]: the
    fp32 mean and population variance over each (batch, group), rsqrt(var +
    eps), repeated over the group's channels (fused_norm.py:68-76)."""
    b, hh, ww, c = x.shape
    xg = x.permute(0, 3, 1, 2).float().reshape(b, groups, (c // groups) * hh * ww)
    var, mean = torch.var_mean(xg, dim=2, correction=0)
    rsig = torch.rsqrt(var + eps)

    def per_channel(s):  # [B, G] -> [B, C], each group's value over its channels
        return s[:, :, None].expand(b, groups, c // groups).reshape(b, c)

    return per_channel(mean), per_channel(rsig)


def gn_act_proj_plain(x, gamma, beta, w, bias, groups: int, eps: float = 1e-6, act: str = "none") -> torch.Tensor:
    """K7's arithmetic (fused_norm.py:30-41, :103): h = ((x - mean)·rsig)·γ +
    β in fp32, then h·sigmoid(h) for act="silu", h rounded to w's dtype, the
    product accumulated in fp32 and cast to x's dtype, the bias added in that
    dtype. x [B, H, W, C], w [C, Cout] -> [B, H, W, Cout]."""
    mean, rsig = group_stats(x, groups, eps)
    h = (x.float() - mean[:, None, None]) * rsig[:, None, None] * gamma.float() + beta.float()
    if act == "silu":
        h = h * torch.sigmoid(h)
    out = torch.matmul(h.to(w.dtype).float(), w.float()).to(x.dtype)
    return out + bias.to(out.dtype)


def gn_act_proj_xla(x, gamma, beta, w, bias, groups: int, eps: float = 1e-6, act: str = "none") -> torch.Tensor:
    """The reference chain (fused_norm.py:107-118): GroupNorm in fp32, γ/β,
    optional SiLU, cast to x's dtype, then the projection and bias in x's
    dtype. x [B, H, W, C] -> [B, H·W, Cout]."""
    b, hh, ww, c = x.shape
    xf = x.float().reshape(b, hh * ww, groups, c // groups)
    var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, correction=0)
    h = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, hh, ww, c)
    h = h * gamma.float() + beta.float()
    if act == "silu":
        h = h * torch.sigmoid(h)
    h = h.to(x.dtype)
    return torch.matmul(h.reshape(b, hh * ww, c), w) + bias[None, None]


def _check(x, gamma, beta, w, bias, groups: int) -> None:
    ts = (x, gamma, beta, w, bias)
    if not all(t.is_cuda for t in ts) or len({t.device for t in ts}) != 1:
        raise ValueError("gn_act_proj: every operand must be a CUDA tensor on one device")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"gn_act_proj: bf16 x and w only, got {x.dtype}, {w.dtype} (float32 runs on the CPU)")
    b, hh, ww, c = x.shape
    if w.ndim != 2 or w.shape[0] != c or gamma.shape != (c,) or beta.shape != (c,) or bias.shape != (w.shape[1],):
        raise ValueError(f"gn_act_proj: x {tuple(x.shape)}, w {tuple(w.shape)}, gamma/beta/bias do not agree")
    if c % groups or c % K_CHUNK or w.shape[1] % COUT_TILE:
        raise ValueError(f"gn_act_proj: C={c} must divide into {groups} groups and be a multiple of {K_CHUNK}, "
                         f"Cout={w.shape[1]} a multiple of {COUT_TILE}")


def kernel_strides(x: torch.Tensor) -> Tuple[int, int, int]:
    """(batch, pixel, channel) element strides of x [B, H, W, C] for the
    kernel, which takes the H·W pixels as one axis and either the pixels
    (NCHW viewed as NHWC) or the channels (channels-last) contiguous."""
    _, hh, ww, _ = x.shape
    sn, sc = x.stride(2), x.stride(3)
    if (hh > 1 and x.stride(1) != ww * sn) or (sn != 1 and sc != 1):
        raise ValueError(f"gn_act_proj: strides {x.stride()} of x {tuple(x.shape)}: the kernel takes an NCHW or a "
                         "channels-last tensor viewed as NHWC")
    return x.stride(0), sn, sc


def gn_act_proj(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                groups: int, eps: float = 1e-6, act: str = "none") -> torch.Tensor:
    """GroupNorm(groups, eps) → optional SiLU → 1x1 projection. x [B, H, W,
    C], gamma/beta [C], w [C, Cout], bias [Cout] -> [B, H, W, Cout] in x's
    dtype. CPU tensors take ``gn_act_proj_plain``; ``gn_act_proj.launches``
    counts launches of the kernel."""
    if act not in ACTS:
        raise ValueError(f"act={act!r}: expected one of {ACTS}")
    if _requires_grad(x, gamma, beta, w, bias):
        raise RuntimeError("gn_act_proj has no backward (forward only, as in JAX); train with fused_norm off")
    if x.device.type == "cpu":
        return gn_act_proj_plain(x, gamma, beta, w, bias, groups, eps, act)
    _check(x, gamma, beta, w, bias, groups)
    sb, sn, sc = kernel_strides(x)
    b, hh, ww, c = x.shape
    cout = w.shape[1]
    mean, rsig = group_stats(x, groups, eps)
    gamma32, beta32 = gamma.float().contiguous(), beta.float().contiguous()
    wt = w.t().contiguous()  # [Cout, C]: the conv weight's own layout, so no copy in the UNet
    bias_x = bias.to(x.dtype).contiguous()
    out = torch.empty((b, hh, ww, cout), device=x.device, dtype=x.dtype)
    _launch("gn_act_proj", x, x.data_ptr(), mean.data_ptr(), rsig.data_ptr(), gamma32.data_ptr(),
            beta32.data_ptr(), wt.data_ptr(), bias_x.data_ptr(), out.data_ptr(), b, hh * ww, c, cout,
            sb, sn, sc, int(act == "silu"))
    gn_act_proj.launches += 1
    return out


gn_act_proj.launches = 0
