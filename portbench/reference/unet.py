"""The Stable Diffusion v1.5 UNet (diffusers ``UNet2DConditionModel``, eps
prediction) in plain float32 PyTorch, from the published description and
the checkpoint's ``unet/config.json``.

Parameter names are the diffusers checkpoint's
(``down_blocks.0.attentions.1.transformer_blocks.0.attn1.to_q.weight``).
Resnets: GroupNorm (eps 1e-5), SiLU, 3x3 conv, plus the projected time
embedding, then again, plus the (1x1) shortcut. Transformers: GroupNorm
(eps 1e-6), 1x1 proj_in, one block of self-attention, cross-attention on
the text states and a GEGLU feed-forward (exact erf GELU), each after a
LayerNorm and added back, 1x1 proj_out, plus the input. Down: strided 3x3
conv; up: nearest x2, 3x3 conv. The time embedding is the sinusoidal one
with cos first (flip_sin_to_cos) and no frequency shift.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.common import Conv2d, GroupNorm, LayerNorm, Linear, Ref, attention


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool, freq_shift: float) -> torch.Tensor:
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / (half - freq_shift)
    args = t.float()[:, None] * torch.exp(exponent)[None]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    return torch.cat([emb[:, half:], emb[:, :half]], dim=-1) if flip_sin_to_cos else emb


class TimestepEmbedding(Ref):
    def __init__(self, n_in: int, dim: int):
        super().__init__()
        self.linear_1, self.linear_2 = Linear(n_in, dim), Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class Resnet(Ref):
    def __init__(self, c_in: int, c_out: int, temb: int | None, groups: int, eps: float):
        super().__init__()
        self.norm1 = GroupNorm(groups, c_in, eps)
        self.conv1 = Conv2d(c_in, c_out, 3, padding=1)
        if temb is not None:
            self.time_emb_proj = Linear(temb, c_out)
        self.norm2 = GroupNorm(groups, c_out, eps)
        self.conv2 = Conv2d(c_out, c_out, 3, padding=1)
        if c_in != c_out:
            self.conv_shortcut = Conv2d(c_in, c_out, 1)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return (self.conv_shortcut(x) if hasattr(self, "conv_shortcut") else x) + h


class Attention(Ref):
    def __init__(self, dim: int, ctx_dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q = Linear(dim, dim, bias=False)
        self.to_k = Linear(ctx_dim, dim, bias=False)
        self.to_v = Linear(ctx_dim, dim, bias=False)
        self.to_out = nn.ModuleList([Linear(dim, dim)])

    def forward(self, x, ctx=None):
        ctx = x if ctx is None else ctx
        b, n, c = x.shape
        split = lambda t: t.view(b, t.shape[1], self.heads, c // self.heads).transpose(1, 2)  # noqa: E731
        o = attention(self.prec, split(self.to_q(x)), split(self.to_k(ctx)), split(self.to_v(ctx)))
        return self.to_out[0](o.transpose(1, 2).reshape(b, n, c))


class GEGLU(Ref):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, 2 * inner)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(Ref):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(), Linear(4 * dim, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class TransformerBlock(Ref):
    def __init__(self, dim: int, ctx_dim: int, heads: int):
        super().__init__()
        self.norm1, self.attn1 = LayerNorm(dim, 1e-5), Attention(dim, dim, heads)
        self.norm2, self.attn2 = LayerNorm(dim, 1e-5), Attention(dim, ctx_dim, heads)
        self.norm3, self.ff = LayerNorm(dim, 1e-5), FeedForward(dim)

    def forward(self, x, ctx):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff(self.norm3(x))


class Transformer2D(Ref):
    def __init__(self, ch: int, ctx_dim: int, heads: int, groups: int):
        super().__init__()
        self.norm = GroupNorm(groups, ch, 1e-6)
        self.proj_in = Conv2d(ch, ch, 1)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(ch, ctx_dim, heads)])
        self.proj_out = Conv2d(ch, ch, 1)

    def forward(self, x, ctx):
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x)).flatten(2).transpose(1, 2)
        for blk in self.transformer_blocks:
            y = blk(y, ctx)
        return self.proj_out(y.transpose(1, 2).reshape(b, c, h, w)) + x


class _Conv(Ref):
    def __init__(self, ch: int, stride: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=stride, padding=1)


class Block(Ref):
    """A down or up block: resnets, transformers where the config has
    them, then the sampler."""

    def __init__(self, resnets: List[Resnet], attn: List[Transformer2D] | None, sampler: str | None, ch: int):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attn is not None:
            self.attentions = nn.ModuleList(attn)
        if sampler == "down":
            self.downsamplers = nn.ModuleList([_Conv(ch, 2)])
        elif sampler == "up":
            self.upsamplers = nn.ModuleList([_Conv(ch, 1)])


class UNet(Ref):
    """``forward(sample [B, 4, h, w], t [B], ctx [B, 77, 768]) -> eps``."""

    def __init__(self, cfg: Dict):
        super().__init__()
        bo = list(cfg["block_out_channels"])
        heads, groups, ctx_dim = cfg["attention_head_dim"], cfg["norm_num_groups"], cfg["cross_attention_dim"]
        layers, temb = cfg["layers_per_block"], 4 * bo[0]
        attn = ["CrossAttn" in t for t in cfg["down_block_types"]]
        self.flip, self.shift = cfg["flip_sin_to_cos"], cfg["freq_shift"]
        self.time_embedding = TimestepEmbedding(bo[0], temb)
        self.conv_in = Conv2d(cfg["in_channels"], bo[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        ch = bo[0]
        for i, out in enumerate(bo):
            res = [Resnet(ch if j == 0 else out, out, temb, groups, 1e-5) for j in range(layers)]
            tfs = [Transformer2D(out, ctx_dim, heads, groups) for _ in range(layers)] if attn[i] else None
            self.down_blocks.append(Block(res, tfs, "down" if i < len(bo) - 1 else None, out))
            ch = out
        mid = Block([Resnet(ch, ch, temb, groups, 1e-5), Resnet(ch, ch, temb, groups, 1e-5)],
                    [Transformer2D(ch, ctx_dim, heads, groups)], None, ch)
        self.mid_block = mid
        self.up_blocks = nn.ModuleList()
        rev, up_attn = bo[::-1], attn[::-1]
        prev = rev[0]
        for i, out in enumerate(rev):
            skip_in = rev[min(i + 1, len(bo) - 1)]
            res = [Resnet((prev if j == 0 else out) + (skip_in if j == layers else out), out, temb, groups, 1e-5)
                   for j in range(layers + 1)]
            tfs = [Transformer2D(out, ctx_dim, heads, groups) for _ in range(layers + 1)] if up_attn[i] else None
            self.up_blocks.append(Block(res, tfs, "up" if i < len(bo) - 1 else None, out))
            prev = out
        self.conv_norm_out = GroupNorm(groups, bo[0], 1e-5)
        self.conv_out = Conv2d(bo[0], cfg["out_channels"], 3, padding=1)

    def forward(self, sample, t, ctx):
        temb = self.time_embedding(timestep_embedding(t, self.conv_in.weight.shape[0], self.flip, self.shift))
        x = self.conv_in(sample.float())
        ctx = ctx.float()
        skips = [x]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                x = res(x, temb)
                if hasattr(blk, "attentions"):
                    x = blk.attentions[j](x, ctx)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0].conv(x)
                skips.append(x)
        x = self.mid_block.resnets[0](x, temb)
        x = self.mid_block.attentions[0](x, ctx)
        x = self.mid_block.resnets[1](x, temb)
        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                x = res(torch.cat([x, skips.pop()], dim=1), temb)
                if hasattr(blk, "attentions"):
                    x = blk.attentions[j](x, ctx)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0].conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(x)))
