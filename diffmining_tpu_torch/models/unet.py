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

The DIFT ``up_ft_indices`` taps and the PnP injection come with the mining
and PnP slices.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffmining_tpu_torch.ops.attention import sdpa

REMAT_POLICIES = ("full", "attn", "dots")


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

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        sc = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return sc + h


class Attention(nn.Module):
    """Multi-head attention, diffusers layout: bias-free to_q/k/v, to_out.0."""

    def __init__(self, query_dim: int, cross_dim: Optional[int], heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(cross_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(cross_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x, context=None):
        ctx = x if context is None else context
        b, lq, _ = x.shape
        lk = ctx.shape[1]
        # [B, L, H*D] -> strided [B, H, L, D] views: no copy on the way in,
        # and the kernel's output is already laid out [B, L, H, D]
        q = self.to_q(x).view(b, lq, self.heads, self.dim_head).transpose(1, 2)
        k = self.to_k(ctx).view(b, lk, self.heads, self.dim_head).transpose(1, 2)
        v = self.to_v(ctx).view(b, lk, self.heads, self.dim_head).transpose(1, 2)
        out = sdpa(q, k, v).transpose(1, 2).reshape(b, lq, self.heads * self.dim_head)
        return self.to_out[0](out)


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

    def forward(self, x):
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

    def forward(self, x, context, ctx_tile: int = 1):
        x = x + self.attn1(self.norm1(x))
        if ctx_tile > 1:
            # sweep prefix dedup: conditions first matter at the cross-
            # attention, so tile the batch here — entry i -> rows
            # [i*ctx_tile, (i+1)*ctx_tile), the engine's conditions-adjacent layout
            x = x.repeat_interleave(ctx_tile, dim=0)
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


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

    def forward(self, x, context, ctx_tile: int = 1):
        b, c, h, w = x.shape
        res = x
        y = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(b, h * w, c)
        for i, blk in enumerate(self.transformer_blocks):
            y = blk(y, context, ctx_tile=ctx_tile if i == 0 else 1)
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
    ) -> torch.Tensor:
        """eps prediction [B*ctx_tile, C, H, W].

        ctx_tile > 1 (sweep prefix dedup): ``sample``/``timesteps`` carry the
        B unique (image, sample) rows and ``encoder_hidden_states`` the
        B*ctx_tile rows, conditions adjacent. conv_in, the first resnet and
        the first (largest) self-attention run at batch B; the batch is
        tiled at the first cross-attention."""
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(sample.shape[0])
        t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0], cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = self.time_embedding(t_emb.to(dtype))
        context = encoder_hidden_states.to(dtype)
        x = self.conv_in(sample.to(dtype))
        pending = ctx_tile if ctx_tile > 1 else 0

        def tile_carry(temb, skips):
            return temb.repeat_interleave(pending, 0), [s.repeat_interleave(pending, 0) for s in skips]

        res_call, tf_call = _remat_calls(self.remat_policy if torch.is_grad_enabled() and ctx_tile == 1 else None)

        skips: List[torch.Tensor] = [x]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                x = res_call(res, x, temb)
                if blk.attentions is not None:
                    x = tf_call(blk.attentions[j], x, context, ctx_tile=pending or 1)
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
        x = tf_call(mid.attentions[0], x, context, ctx_tile=pending or 1)
        if pending:  # no down block carried attention: tile at mid
            temb, skips = tile_carry(temb, skips)
            pending = 0
        x = res_call(mid.resnets[1], x, temb)

        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                x = res_call(res, torch.cat([x, skips.pop()], dim=1), temb)
                if blk.attentions is not None:
                    x = tf_call(blk.attentions[j], x, context)
            if blk.upsamplers is not None:
                x = blk.upsamplers[0](x, skips[-1].shape[2:])

        return self.conv_out(F.silu(self.conv_norm_out(x)))


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
