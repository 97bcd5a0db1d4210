"""SD-v1.5 AutoencoderKL in PyTorch (counterpart of
diffmining_tpu/models/vae.py): the encoder, the posterior draw and the
decoder.

diffusers state-dict keys, NCHW. ``encode`` returns the posterior (mean,
clamped logvar); ``sample_latent`` draws from it with the noise passed in, so
the caller owns the random stream. ``decode`` maps scaled latents back to
images in [-1, 1] (post_quant_conv, then the decoder: a mid block, up blocks
with nearest x2 upsampling). The mid blocks' single-head attention (D = 512)
is off the flash kernels' gate, so ``sdpa`` runs ``sdpa_plain`` for it.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffmining_tpu_torch.models.unet import ResnetBlock2D
from diffmining_tpu_torch.ops.attention import sdpa

# the decoder's state-dict prefixes: load_state(..., ignore_prefixes=...)
# with these loads an encoder-only checkpoint
DECODER_PREFIXES = ("decoder.", "post_quant_conv.")


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


SD15_VAE = VAEConfig()

TINY_VAE = VAEConfig(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=4)


class VAEAttention(nn.Module):
    """Single-head self-attention over the spatial map (diffusers Attention)."""

    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = (m(y)[:, None] for m in (self.to_q, self.to_k, self.to_v))
        y = self.to_out[0](sdpa(q, k, v)[:, 0])
        return x + y.reshape(b, h, w, c).permute(0, 3, 1, 2)


class _Mid(nn.Module):
    def __init__(self, ch, groups):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(ch, ch, None, groups, 1e-6), ResnetBlock2D(ch, ch, None, groups, 1e-6)]
        )
        self.attentions = nn.ModuleList([VAEAttention(ch, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Downsample(nn.Module):
    """diffusers Downsample2D in the VAE: pad (0,1,0,1), then a VALID conv."""

    def __init__(self, ch):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _DownBlock(nn.Module):
    def __init__(self, in_ch, out_ch, layers, groups, add_downsample):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, None, groups, 1e-6) for j in range(layers)]
        )
        self.downsamplers = nn.ModuleList([_Downsample(out_ch)]) if add_downsample else None

    def forward(self, x):
        for res in self.resnets:
            x = res(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        bo = tuple(cfg.block_out_channels)
        self.conv_in = nn.Conv2d(cfg.in_channels, bo[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        ch = bo[0]
        for i, out_ch in enumerate(bo):
            self.down_blocks.append(
                _DownBlock(ch, out_ch, cfg.layers_per_block, cfg.norm_num_groups, add_downsample=i < len(bo) - 1)
            )
            ch = out_ch
        self.mid_block = _Mid(bo[-1], cfg.norm_num_groups)
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, bo[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(bo[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class _Upsample(nn.Module):
    """Nearest x2, then a 3x3 conv (diffusers Upsample2D in the VAE)."""

    def __init__(self, ch):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _UpBlock(nn.Module):
    def __init__(self, in_ch, out_ch, layers, groups, add_upsample):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, None, groups, 1e-6) for j in range(layers)]
        )
        self.upsamplers = nn.ModuleList([_Upsample(out_ch)]) if add_upsample else None

    def forward(self, x):
        for res in self.resnets:
            x = res(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class Decoder(nn.Module):
    """conv_in -> mid block -> up blocks (reversed widths, layers_per_block
    + 1 resnets each, x2 between levels) -> GN -> SiLU -> conv_out."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = tuple(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _Mid(rev[0], cfg.norm_num_groups)
        self.up_blocks = nn.ModuleList()
        ch = rev[0]
        for i, out_ch in enumerate(rev):
            self.up_blocks.append(
                _UpBlock(ch, out_ch, cfg.layers_per_block + 1, cfg.norm_num_groups, add_upsample=i < len(rev) - 1)
            )
            ch = out_ch
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            x = blk(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig = SD15_VAE):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.decoder = Decoder(config)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, 3, H, W] in [-1, 1] -> posterior (mean, logvar clamped to
        [-30, 20]), each [B, latent, H/f, W/f]."""
        moments = self.quant_conv(self.encoder(x.to(self.quant_conv.weight.dtype)))
        mean, logvar = moments.chunk(2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents [B, latent, h, w] -> images [B, 3, 8h, 8w] in the
        module's dtype (about [-1, 1])."""
        z = (z.float() / self.config.scaling_factor).to(self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(z))

    forward = encode


def sample_latent(mean: torch.Tensor, logvar: torch.Tensor, eps: torch.Tensor, scaling_factor: float = 0.18215) -> torch.Tensor:
    """Reparameterized draw (mean + std·eps)·scaling_factor in float32, in
    mean's dtype; ``eps`` is the caller's standard-normal draw."""
    std = torch.exp(0.5 * logvar.float())
    return ((mean.float() + std * eps.float()) * scaling_factor).to(mean.dtype)
