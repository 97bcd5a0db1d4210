"""The Stable Diffusion v1.5 VAE encoder (diffusers ``AutoencoderKL``, the
encoder and ``quant_conv``) in plain float32 PyTorch, from the published
description and the checkpoint's ``vae/config.json``.

conv_in, down blocks of resnets (GroupNorm eps 1e-6, no time embedding)
each but the last ending in a 3x3 stride-2 conv on the input padded by one
row and column at the bottom and right, a mid block (resnet, single-head
self-attention over the map with its GroupNorm and residual, resnet),
GroupNorm, SiLU, conv_out to 2 x latent channels, then the 1x1 quant_conv.
The posterior's log-variance is clamped to [-30, 20]; a latent is (mean +
exp(logvar / 2) eps) times the scaling factor.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.common import Conv2d, GroupNorm, Linear, Ref, attention
from portbench.reference.unet import Resnet


class SelfAttention(Ref):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, ch, 1e-6)
        self.to_q, self.to_k, self.to_v = Linear(ch, ch), Linear(ch, ch), Linear(ch, ch)
        self.to_out = nn.ModuleList([Linear(ch, ch)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).flatten(2).transpose(1, 2)
        q, k, v = (m(y)[:, None] for m in (self.to_q, self.to_k, self.to_v))
        y = self.to_out[0](attention(self.prec, q, k, v)[:, 0])
        return x + y.transpose(1, 2).reshape(b, c, h, w)


class _Down(Ref):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class DownBlock(Ref):
    def __init__(self, c_in: int, c_out: int, layers: int, groups: int, down: bool):
        super().__init__()
        self.resnets = nn.ModuleList([Resnet(c_in if j == 0 else c_out, c_out, None, groups, 1e-6)
                                      for j in range(layers)])
        if down:
            self.downsamplers = nn.ModuleList([_Down(c_out)])


class Mid(Ref):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([Resnet(ch, ch, None, groups, 1e-6), Resnet(ch, ch, None, groups, 1e-6)])
        self.attentions = nn.ModuleList([SelfAttention(ch, groups)])


class Encoder(Ref):
    def __init__(self, cfg: Dict):
        super().__init__()
        bo, groups = list(cfg["block_out_channels"]), cfg["norm_num_groups"]
        self.conv_in = Conv2d(cfg["in_channels"], bo[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        ch = bo[0]
        for i, out in enumerate(bo):
            self.down_blocks.append(DownBlock(ch, out, cfg["layers_per_block"], groups, i < len(bo) - 1))
            ch = out
        self.mid_block = Mid(ch, groups)
        self.conv_norm_out = GroupNorm(groups, ch, 1e-6)
        self.conv_out = Conv2d(ch, 2 * cfg["latent_channels"], 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
        mid = self.mid_block
        x = mid.resnets[1](mid.attentions[0](mid.resnets[0](x)))
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VAEEncoder(Ref):
    """``encode(images [B, 3, H, W] in [-1, 1]) -> (mean, logvar)``."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.scaling_factor = cfg["scaling_factor"]
        self.encoder = Encoder(cfg)
        n = 2 * cfg["latent_channels"]
        self.quant_conv = Conv2d(n, n, 1)

    def encode(self, images) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, logvar = self.quant_conv(self.encoder(images.float())).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def latent(self, images, eps) -> torch.Tensor:
        mean, logvar = self.encode(images)
        return (mean + torch.exp(0.5 * logvar) * eps.float()) * self.scaling_factor
