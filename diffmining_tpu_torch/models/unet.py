"""SD-v1.5 UNet2DCondition, eps path, in PyTorch (counterpart of
diffmining_tpu/models/unet.py).

NCHW tensors and diffusers state-dict keys (``down_blocks.0.attentions.1.
transformer_blocks.0.attn1.to_q.weight``), so a diffusers checkpoint loads
with ``load_state_dict`` and no renaming. Carries the JAX module's semantics:
the timestep embedding (flip_sin_to_cos, freq_shift), GroupNorm eps 1e-5 in
the resnets and 1e-6 in the transformers, torch nearest upsampling to the
skip's size, GEGLU with the exact erf GELU, and the sweep's ``ctx_tile``
prefix dedup (unet.py:541-569). All attention goes through ops.attention.sdpa,
which sends the long self-attention to the flash kernels.

``set_gradient_checkpointing`` is the reference's --gradient_checkpointing
with the JAX package's remat policies (unet.py:80-91, 570-600), through
``torch.utils.checkpoint``: "full" recomputes every resnet and transformer
block in the backward, "attn" only the transformer blocks, "dots" both but
saves every matmul and convolution output (a selective-checkpoint policy).

``up_ft_indices`` returns the DIFT taps, each up block's output after its
upsampler, as the JAX dict (unet.py:687-703). ``UNetConfig.fused_norm``
(set by the SD bundle on CUDA under ``DIFFMINING_FUSED_NORM=1``) sends
every SpatialTransformer entry, GroupNorm → proj_in, through
``ops.fused_norm.gn_act_proj`` with the same state-dict keys; it is
forward only.

PnP's injection and collection contract (JAX unet.py:14-28, 48-54):
``forward(..., collect_injection=True)`` returns the taps under "taps", and
``forward(..., injection={...})`` replaces them. Keys:

  "up.{i}.res.{j}"      resnet j of up block i: its residual branch (after
                        conv2, before the shortcut add), [B, C, H, W];
  "{path}.attn1.q/.k"   a transformer block's self-attention q and k after
                        the head split, canonical [B, H, L, D], where
                        {path} is "down.{i}.tf.{j}.{k}", "mid.tf.{k}" or
                        "up.{i}.tf.{j}.{k}" (k the block in the transformer).

A value broadcasts over the batch (a batch-1 source tap feeds every row)
and is cast to the activation's dtype; a ``(value, gate)`` tuple replaces
the activation only where the scalar boolean ``gate`` (a Python bool or a
0-d tensor) is true. Injection composes with ``ctx_tile`` for batch-1
values; collection needs ``ctx_tile=1``.

The channel-major transformer world (JAX unet.py:181-229, :409-439), under
``DIFFMINING_TF_CMAJOR=1``, read per call in ``Transformer2DModel.forward``
as the JAX package reads it (the fused norm wins: with
``UNetConfig.fused_norm`` the normal world runs). The transformer blocks
then hold their activations [B, C, L] with L contiguous (the JAX package
holds them [C, B, L]): proj_in's NCHW output and proj_out's NCHW input are
free views of it, every projection contracts the channel axis with the same
(LoRA-merged) weight (``Attention._proj_cm``), the context [B, Lk, C_ctx]
is contracted on its last axis, GEGLU splits the channel axis, and the
self-attention runs through ``ops.attention.sdpa_cbl``, whose kernels read
q, k and v in that layout. The LayerNorms normalise the channel axis
through ``F.layer_norm`` on the transposed view (PyTorch has no channel-axis
LayerNorm, so each copies its input once). Taps are collected in the
canonical [B, H, L, D] and injected values converted to [B, H*D, L], so
taps cross worlds; the state-dict keys are the same.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffmining_tpu_torch.ops.attention import sdpa, sdpa_cbl, split_cm
from diffmining_tpu_torch.ops.fused_norm import gn_act_proj

REMAT_POLICIES = ("full", "attn", "dots")

Injection = Dict[str, Any]  # key -> value, or (value, scalar bool gate)


def _apply_injection(current: torch.Tensor, injected) -> torch.Tensor:
    """``current`` replaced by the injected value broadcast to its shape, in
    its dtype; a ``(value, gate)`` tuple replaces it only where the gate is
    true. The broadcast is materialised (a dense tensor, never a stride-0
    batch view), so injected q/k reach the attention kernels in a layout
    they are tested on."""
    gate = True
    if isinstance(injected, tuple):
        injected, gate = injected
    value = injected.to(current.dtype).expand(current.shape)
    if isinstance(gate, torch.Tensor):
        return torch.where(gate.to(current.device), value, current)
    return value.contiguous() if gate else current


def _tap(h: torch.Tensor, tap: str, injection: Optional[Injection], collect: Optional[Dict[str, torch.Tensor]]):
    """Inject into and collect the activation named ``tap``."""
    if injection is not None and tap in injection:
        h = _apply_injection(h, injection[tap])
    if collect is not None:
        collect[tap] = h
    return h


def _canonical_to_cm(a: torch.Tensor) -> torch.Tensor:
    """[S, H, L, D] -> [S, H*D, L] (S may be 1 for a broadcast injection)."""
    s, h, l, d = a.shape
    return a.transpose(2, 3).reshape(s, h * d, l)


def _injection_to_cm(injected):
    """A canonical injected q/k (a value or a (value, gate) tuple) in the
    channel-major layout."""
    if isinstance(injected, tuple):
        value, gate = injected
        return _canonical_to_cm(value), gate
    return _canonical_to_cm(injected)


def _tap_cm(h: torch.Tensor, tap: str, heads: int, injection: Optional[Injection],
            collect: Optional[Dict[str, torch.Tensor]]):
    """``_tap`` for a channel-major [B, H*D, L] q or k: the injected value
    converted from the canonical layout, the collected one viewed in it."""
    if injection is not None and tap in injection:
        h = _apply_injection(h, _injection_to_cm(injection[tap]))
    if collect is not None:
        collect[tap] = split_cm(h, heads)
    return h


def _channel_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``ln`` over the channel axis of channel-major [B, C, L] activations:
    ``F.layer_norm`` on the [B, L, C] view (which copies it once), handed
    back as a [B, C, L] view."""
    return F.layer_norm(x.transpose(1, 2), ln.normalized_shape, ln.weight, ln.bias, ln.eps).transpose(1, 2)


def _linear_cm(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``F.linear`` for channel-major x [B, C, L] -> [B, F, L] (L
    contiguous), w [F, C]: one batched GEMM whose weight operand repeats
    with a zero batch stride (``torch.matmul`` would copy the weight once an
    image; under autocast both are cast before the weight is expanded, so it
    is cast once), the bias added in the product's dtype."""
    dev = x.device.type
    if torch.is_autocast_enabled(dev):
        dtype = torch.get_autocast_dtype(dev)
        w, x = w.to(dtype), x.to(dtype)
    y = torch.bmm(w.expand(x.shape[0], *w.shape), x)
    return y if bias is None else y + bias.to(y.dtype)[:, None]


def cmajor_world() -> bool:
    """Whether the transformers run channel-major: DIFFMINING_TF_CMAJOR=1,
    read per call as the JAX package does (unet.py:409)."""
    return os.environ.get("DIFFMINING_TF_CMAJOR", "0") == "1"


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    num_attention_heads: int = 8
    down_block_has_attn: Tuple[bool, ...] = (True, True, True, False)
    transformer_layers: int = 1
    norm_num_groups: int = 32
    freq_shift: int = 0
    flip_sin_to_cos: bool = True
    sample_size: int = 64
    # the transformer entry GroupNorm → proj_in as one fused kernel pass
    # (ops/fused_norm.py, unet.py:92-96 in JAX); forward only, the same
    # state dict either way
    fused_norm: bool = False

    @property
    def up_block_has_attn(self) -> Tuple[bool, ...]:
        return tuple(reversed(self.down_block_has_attn))


SD15_UNET = UNetConfig()

TINY_UNET = UNetConfig(
    block_out_channels=(32, 64),
    layers_per_block=1,
    cross_attention_dim=32,
    num_attention_heads=2,
    down_block_has_attn=(True, False),
    norm_num_groups=8,
    sample_size=8,
)


def timestep_embedding(timesteps: torch.Tensor, dim: int, flip_sin_to_cos: bool = True, freq_shift: int = 0,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding (diffusers Timesteps): [B] -> [B, dim] float32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(exponent / (half - freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    """GN -> SiLU -> conv1 (+ time_emb_proj(SiLU(temb))) -> GN -> SiLU -> conv2
    -> + shortcut. ``temb_ch=None`` is the VAE's variant."""

    def __init__(self, in_ch: int, out_ch: int, temb_ch: Optional[int], groups: int, eps: float):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_ch, eps=eps)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_ch, out_ch) if temb_ch is not None else None
        self.norm2 = nn.GroupNorm(groups, out_ch, eps=eps)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x, temb=None, tap: str = "", injection: Optional[Injection] = None, collect=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if tap:
            # PnP's residual-branch tap: each row then adds its own shortcut
            h = _tap(h, tap, injection, collect)
        sc = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return sc + h


class Attention(nn.Module):
    """Multi-head attention, diffusers layout: bias-free to_q/k/v, to_out.0.

    ``lora`` (set by finetuning/lora.py ``attach``) maps a projection's name
    ("to_q", "to_k", "to_v", "to_out.0") to its factors (a [in, r], b [r,
    out]): the projection then uses W + (a@b)ᵀ, merged here in the forward
    (in float32, outside autocast), so a block that gradient checkpointing
    recomputes merges again from the same factors."""

    def __init__(self, query_dim: int, cross_dim: Optional[int], heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(cross_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(cross_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])
        self.lora: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None

    def _weight(self, name: str, lin: nn.Linear, device_type: str) -> torch.Tensor:
        """The projection's weight, with its LoRA factors merged if it has
        any."""
        factors = self.lora.get(name) if self.lora else None
        if factors is None:
            return lin.weight
        a, b = factors
        with torch.autocast(device_type, enabled=False):
            return lin.weight + (a @ b).t().to(lin.weight.dtype)

    def _proj(self, name: str, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        if not (self.lora and name in self.lora):
            return lin(x)
        return F.linear(x, self._weight(name, lin, x.device.type), lin.bias)

    def _proj_cm(self, name: str, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """The projection of channel-major [B, C, L] input -> [B, F, L] with
        the same weight (JAX DenseT, unet.py:181-208)."""
        return _linear_cm(x, self._weight(name, lin, x.device.type), lin.bias)

    def forward(self, x, context=None, tap: str = "", injection: Optional[Injection] = None, collect=None,
                cmajor: bool = False):
        if cmajor:
            # x [B, C, L]; the context keeps its [B, Lk, C_ctx] and is
            # contracted on its last axis
            ctx = x if context is None else context.transpose(1, 2)
            q = self._proj_cm("to_q", self.to_q, x)
            k = self._proj_cm("to_k", self.to_k, ctx)
            v = self._proj_cm("to_v", self.to_v, ctx)
            if tap:
                q = _tap_cm(q, f"{tap}.q", self.heads, injection, collect)
                k = _tap_cm(k, f"{tap}.k", self.heads, injection, collect)
            return self._proj_cm("to_out.0", self.to_out[0], sdpa_cbl(q, k, v, self.heads))
        ctx = x if context is None else context
        b, lq, _ = x.shape
        lk = ctx.shape[1]
        # [B, L, H*D] -> strided [B, H, L, D] views: no copy on the way in,
        # and the kernel's output is already laid out [B, L, H, D]
        q = self._proj("to_q", self.to_q, x).view(b, lq, self.heads, self.dim_head).transpose(1, 2)
        k = self._proj("to_k", self.to_k, ctx).view(b, lk, self.heads, self.dim_head).transpose(1, 2)
        v = self._proj("to_v", self.to_v, ctx).view(b, lk, self.heads, self.dim_head).transpose(1, 2)
        if tap:
            q = _tap(q, f"{tap}.q", injection, collect)
            k = _tap(k, f"{tap}.k", injection, collect)
        out = sdpa(q, k, v).transpose(1, 2).reshape(b, lq, self.heads * self.dim_head)
        return self._proj("to_out.0", self.to_out[0], out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact erf GELU, as diffusers



class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        # index 1 is diffusers' Dropout(0.0): kept so the keys read net.0 / net.2
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)])

    def forward(self, x, cmajor: bool = False):
        if cmajor:  # [B, C, L]: GEGLU splits the channel axis
            proj, out = self.net[0].proj, self.net[2]
            h, gate = _linear_cm(x, proj.weight, proj.bias).chunk(2, dim=1)
            return _linear_cm(h * F.gelu(gate), out.weight, out.bias)
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, cross_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, None, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, cross_dim, heads, dim_head)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context, ctx_tile: int = 1, tap: str = "", injection: Optional[Injection] = None,
                collect=None, cmajor: bool = False):
        # channel-major world: x is [B, C, L] and the LayerNorms normalise
        # the channel axis; the batch axis is 0 in both worlds
        norm = _channel_norm if cmajor else _call
        x = x + self.attn1(norm(self.norm1, x), tap=f"{tap}.attn1" if tap else "", injection=injection,
                           collect=collect, cmajor=cmajor)
        if ctx_tile > 1:
            # sweep prefix dedup: conditions first matter at the cross-
            # attention, so tile the batch here — entry i -> rows
            # [i*ctx_tile, (i+1)*ctx_tile), the engine's conditions-adjacent layout
            x = x.repeat_interleave(ctx_tile, dim=0)
        x = x + self.attn2(norm(self.norm2, x), context, cmajor=cmajor)
        return x + self.ff(norm(self.norm3, x), cmajor=cmajor)


class Transformer2DModel(nn.Module):
    """GN (eps 1e-6) -> 1x1 proj_in -> blocks -> 1x1 proj_out -> + residual."""

    def __init__(self, ch: int, heads: int, cross_dim: int, depth: int, groups: int):
        super().__init__()
        self.norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.proj_in = nn.Conv2d(ch, ch, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(ch, heads, ch // heads, cross_dim) for _ in range(depth)]
        )
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x, context, ctx_tile: int = 1, fused_norm: bool = False, tap: str = "",
                injection: Optional[Injection] = None, collect=None):
        b, c, h, w = x.shape
        res = x
        if not fused_norm and cmajor_world():
            # the channel-major world: [B, C, L] is a free view of proj_in's
            # NCHW output and of proj_out's NCHW input
            y = self.proj_in(self.norm(x)).reshape(b, c, h * w)
            for i, blk in enumerate(self.transformer_blocks):
                y = blk(y, context, ctx_tile=ctx_tile if i == 0 else 1, tap=f"{tap}.{i}" if tap else "",
                        injection=injection, collect=collect, cmajor=True)
            if ctx_tile > 1:
                b = b * ctx_tile
                res = res.repeat_interleave(ctx_tile, dim=0)
            return self.proj_out(y.reshape(b, c, h, w)) + res
        if fused_norm:
            # one fused pass (no activation between them in diffusers); it
            # writes [B, H, W, C] directly, the blocks' [B, L, C] input
            y = gn_act_proj(
                x.permute(0, 2, 3, 1), self.norm.weight, self.norm.bias, self.proj_in.weight[:, :, 0, 0].t(),
                self.proj_in.bias, self.norm.num_groups, eps=self.norm.eps,
            ).reshape(b, h * w, c)
        else:
            y = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(b, h * w, c)
        for i, blk in enumerate(self.transformer_blocks):
            y = blk(y, context, ctx_tile=ctx_tile if i == 0 else 1, tap=f"{tap}.{i}" if tap else "",
                    injection=injection, collect=collect)
        if ctx_tile > 1:
            # the first block tiled the batch; tile the entry residual to match
            b = b * ctx_tile
            res = res.repeat_interleave(ctx_tile, dim=0)
        y = y.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(y) + res


class Downsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x, out_size: Tuple[int, int]):
        # torch nearest: src = floor(dst * in / out), the sizing the JAX
        # package's nearest_resize reproduces (unet.py:484)
        return self.conv(F.interpolate(x, size=tuple(out_size), mode="nearest"))


class _DownBlock(nn.Module):
    """CrossAttnDownBlock2D / DownBlock2D."""

    def __init__(self, in_ch, out_ch, temb_ch, layers, has_attn, heads, cross_dim, groups, add_downsample, depth):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, temb_ch, groups, 1e-5) for j in range(layers)]
        )
        self.attentions = (
            nn.ModuleList([Transformer2DModel(out_ch, heads, cross_dim, depth, groups) for _ in range(layers)])
            if has_attn else None
        )
        self.downsamplers = nn.ModuleList([Downsample2D(out_ch)]) if add_downsample else None


class _MidBlock(nn.Module):
    def __init__(self, ch, temb_ch, heads, cross_dim, groups, depth):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(ch, ch, temb_ch, groups, 1e-5), ResnetBlock2D(ch, ch, temb_ch, groups, 1e-5)]
        )
        self.attentions = nn.ModuleList([Transformer2DModel(ch, heads, cross_dim, depth, groups)])


class _UpBlock(nn.Module):
    """CrossAttnUpBlock2D / UpBlock2D; resnet j consumes a skip from the end
    of the down stack, with diffusers' channel plumbing."""

    def __init__(self, in_ch, prev_ch, out_ch, temb_ch, layers, has_attn, heads, cross_dim, groups, add_upsample, depth):
        super().__init__()
        resnets = []
        for j in range(layers):
            skip_ch = in_ch if j == layers - 1 else out_ch
            res_in = prev_ch if j == 0 else out_ch
            resnets.append(ResnetBlock2D(res_in + skip_ch, out_ch, temb_ch, groups, 1e-5))
        self.resnets = nn.ModuleList(resnets)
        self.attentions = (
            nn.ModuleList([Transformer2DModel(out_ch, heads, cross_dim, depth, groups) for _ in range(layers)])
            if has_attn else None
        )
        self.upsamplers = nn.ModuleList([Upsample2D(out_ch)]) if add_upsample else None


class UNet2DCondition(nn.Module):
    def __init__(self, config: UNetConfig = SD15_UNET):
        super().__init__()
        self.config = cfg = config
        bo = tuple(cfg.block_out_channels)
        temb_ch = bo[0] * 4
        n = len(bo)
        self.time_embedding = TimestepEmbedding(bo[0], temb_ch)
        self.conv_in = nn.Conv2d(cfg.in_channels, bo[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        ch = bo[0]
        for i, out_ch in enumerate(bo):
            self.down_blocks.append(_DownBlock(
                ch, out_ch, temb_ch, cfg.layers_per_block, cfg.down_block_has_attn[i],
                cfg.num_attention_heads, cfg.cross_attention_dim, cfg.norm_num_groups,
                add_downsample=i < n - 1, depth=cfg.transformer_layers,
            ))
            ch = out_ch
        self.mid_block = _MidBlock(
            bo[-1], temb_ch, cfg.num_attention_heads, cfg.cross_attention_dim, cfg.norm_num_groups,
            depth=cfg.transformer_layers,
        )
        self.up_blocks = nn.ModuleList()
        rev = bo[::-1]
        prev = rev[0]
        for i, out_ch in enumerate(rev):
            self.up_blocks.append(_UpBlock(
                rev[min(i + 1, n - 1)], prev, out_ch, temb_ch, cfg.layers_per_block + 1,
                cfg.up_block_has_attn[i], cfg.num_attention_heads, cfg.cross_attention_dim,
                cfg.norm_num_groups, add_upsample=i < n - 1, depth=cfg.transformer_layers,
            ))
            prev = out_ch
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, bo[0], eps=1e-5)
        self.conv_out = nn.Conv2d(bo[0], cfg.out_channels, 3, padding=1)
        self.remat_policy: Optional[str] = None

    def set_gradient_checkpointing(self, policy: Optional[str] = "full") -> None:
        """Recompute blocks in the backward under ``policy`` ("full", "attn"
        or "dots"; None turns it off). Applies to passes with grad enabled
        and no ctx_tile, as in the JAX UNet."""
        if policy is not None and policy not in REMAT_POLICIES:
            raise ValueError(f"remat policy {policy!r}: expected one of {REMAT_POLICIES}")
        self.remat_policy = policy

    def forward(
        self,
        sample: torch.Tensor,  # [B, C, H, W] noisy latents
        timesteps: torch.Tensor,  # [B] or []
        encoder_hidden_states: torch.Tensor,  # [B*ctx_tile, L, cross_dim]
        ctx_tile: int = 1,
        up_ft_indices: Tuple[int, ...] = (),
        injection: Optional[Injection] = None,
        collect_injection: bool = False,
    ):
        """eps prediction [B*ctx_tile, C, H, W]; with ``up_ft_indices`` or
        ``collect_injection`` the dict {"sample": eps}, plus "up_ft": {i: up
        block i's output} and "taps": {key: activation} (the PnP contract,
        module docstring).

        ctx_tile > 1 (sweep prefix dedup): ``sample``/``timesteps`` carry the
        B unique (image, sample) rows and ``encoder_hidden_states`` the
        B*ctx_tile rows, conditions adjacent. conv_in, the first resnet and
        the first (largest) self-attention run at batch B; the batch is
        tiled at the first cross-attention."""
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        collect: Optional[Dict[str, torch.Tensor]] = {} if collect_injection else None
        if ctx_tile > 1:
            if collect_injection:
                raise ValueError("tap collection sees the pre-tile batch layout; collect with ctx_tile=1")
            for key, val in (injection or {}).items():
                val = val[0] if isinstance(val, tuple) else val
                if val.shape[0] != 1:
                    # a batch-1 value is layout-independent: injecting before
                    # the tile equals injecting after it; a wider one is not
                    raise ValueError(f"injection[{key!r}] has batch {val.shape[0]}; with ctx_tile > 1 only "
                                     "batch-1 values compose")
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(sample.shape[0])
        t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0], cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = self.time_embedding(t_emb.to(dtype))
        context = encoder_hidden_states.to(dtype)
        x = self.conv_in(sample.to(dtype))
        pending = ctx_tile if ctx_tile > 1 else 0

        def tile_carry(temb, skips):
            return temb.repeat_interleave(pending, 0), [s.repeat_interleave(pending, 0) for s in skips]

        # remat applies to the plain eps path only, as in JAX
        plain = ctx_tile == 1 and injection is None and not collect_injection
        res_call, tf_call = _remat_calls(self.remat_policy if torch.is_grad_enabled() and plain else None)
        fused = cfg.fused_norm
        taps = dict(injection=injection, collect=collect)

        skips: List[torch.Tensor] = [x]
        for i, blk in enumerate(self.down_blocks):
            for j, res in enumerate(blk.resnets):
                x = res_call(res, x, temb)
                if blk.attentions is not None:
                    x = tf_call(blk.attentions[j], x, context, ctx_tile=pending or 1, fused_norm=fused,
                                tap=f"down.{i}.tf.{j}", **taps)
                    if pending:
                        # the first transformer tiled the batch inside; bring
                        # temb and the collected skips along
                        temb, skips = tile_carry(temb, skips)
                        pending = 0
                skips.append(x)
            if blk.downsamplers is not None:
                x = blk.downsamplers[0](x)
                skips.append(x)

        mid = self.mid_block
        x = res_call(mid.resnets[0], x, temb)
        x = tf_call(mid.attentions[0], x, context, ctx_tile=pending or 1, fused_norm=fused, tap="mid.tf", **taps)
        if pending:  # no down block carried attention: tile at mid
            temb, skips = tile_carry(temb, skips)
            pending = 0
        x = res_call(mid.resnets[1], x, temb)

        up_ft = {}
        for i, blk in enumerate(self.up_blocks):
            for j, res in enumerate(blk.resnets):
                x = res_call(res, torch.cat([x, skips.pop()], dim=1), temb, tap=f"up.{i}.res.{j}", **taps)
                if blk.attentions is not None:
                    x = tf_call(blk.attentions[j], x, context, fused_norm=fused, tap=f"up.{i}.tf.{j}", **taps)
            if blk.upsamplers is not None:
                x = blk.upsamplers[0](x, skips[-1].shape[2:])
            # DIFT taps the whole up block's output, after its upsampler
            # (reference dift.py:134-165)
            if i in up_ft_indices:
                up_ft[i] = x

        eps = self.conv_out(F.silu(self.conv_norm_out(x)))
        if not (up_ft_indices or collect_injection):
            return eps
        out = {"sample": eps}
        if up_ft_indices:
            out["up_ft"] = up_ft
        if collect_injection:
            out["taps"] = collect
        return out


def _call(mod, *args, **kwargs):
    return mod(*args, **kwargs)


def _save_dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpoint: keep matmul and convolution outputs, recompute
    the rest (the counterpart of JAX's dots-saveable policy, extended to the
    convolutions)."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    saved = (aten.mm.default, aten.addmm.default, aten.bmm.default, aten.convolution.default)
    return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_calls(policy: Optional[str]):
    """(resnet call, transformer call) under a remat policy; plain calls
    when it is None."""
    if policy is None:
        return _call, _call
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    kw = {"use_reentrant": False}
    if policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots_policy)
    remat = functools.partial(checkpoint, _call, **kw)
    return (_call if policy == "attn" else remat), remat
