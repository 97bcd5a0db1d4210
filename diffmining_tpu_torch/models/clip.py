"""CLIP in PyTorch (counterpart of diffmining_tpu/models/clip.py): the text
encoder, the text tower with its projection and the ViT vision tower.

transformers state-dict keys (``text_model.encoder.layers.0.self_attn.q_proj
.weight``, ``vision_model.*``, ``visual_projection.weight``,
``text_projection.weight``). The output SD conditions on is
``last_hidden_state`` after the final LayerNorm, [B, 77, hidden], under a
causal mask. The vision tower (``CLIPVisionModel``) returns the pooled
embedding and every patch token, both through ``visual_projection``, which
is what the CLIP-mining baseline scores; off its native grid it interpolates
the learned position embeddings as torch's bicubic ``F.interpolate`` does.
The towers run in float32: at the native crops (ViT-L/14 at 336 px: L =
577; ViT-B/32 at 224: L = 50) every attention takes ``sdpa_plain``; from a
448 px crop on (L = 1025) the vision tower's self-attention passes the
flash gate and, on the card, runs the float32 flash forward (online at L =
1025, no-max from L = 4097, as the JAX package routes it).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffmining_tpu_torch.ops.attention import sdpa


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5


CLIP_VIT_L_TEXT = CLIPTextConfig()

TINY_CLIP_TEXT = CLIPTextConfig(vocab_size=1000, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    projection_dim: int = 768
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5


CLIP_VIT_L_VISION_336 = CLIPVisionConfig()

# openai/clip-vit-base-patch32's published vision config (the reference's
# default tower for cluster's clip modes)
CLIP_VIT_B32_VISION = CLIPVisionConfig(image_size=224, patch_size=32, hidden_size=768, intermediate_size=3072,
                                       num_layers=12, num_heads=12, projection_dim=512)

TINY_CLIP_VISION = CLIPVisionConfig(
    image_size=64, patch_size=8, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2, projection_dim=16,
)


def _torch_bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] float32 matrix of torch's ``F.interpolate(mode="bicubic",
    align_corners=False)`` along one axis (cubic kernel a = -0.75,
    half-pixel centres, border replicated), built as the JAX package builds
    it (clip.py:66)."""
    a = -0.75

    def k(x):
        x = abs(x)
        if x <= 1:
            return (a + 2) * x**3 - (a + 3) * x**2 + 1
        if x < 2:
            return a * (x**3 - 5 * x**2 + 8 * x - 4)
        return 0.0

    w = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        src = (i + 0.5) * in_size / out_size - 0.5
        j0 = int(np.floor(src))
        frac = src - j0
        for t in range(-1, 3):
            w[i, min(max(j0 + t, 0), in_size - 1)] += k(t - frac)
    return w


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu  # exact erf GELU
    raise ValueError(name)


class CLIPAttention(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.heads = cfg.num_heads
        self.q_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.k_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.v_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.out_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x, mask=None):
        b, l, c = x.shape
        q, k, v = (
            m(x).view(b, l, self.heads, c // self.heads).transpose(1, 2)
            for m in (self.q_proj, self.k_proj, self.v_proj)
        )
        return self.out_proj(sdpa(q, k, v, mask=mask).transpose(1, 2).reshape(b, l, c))


class CLIPMLP(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.act = _act(cfg.hidden_act)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x, mask=None):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextConfig = CLIP_VIT_L_TEXT):
        super().__init__()
        self.config = config
        self.text_model = _TextTransformer(config)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids [B, L] -> last_hidden_state [B, L, hidden]."""
        tm = self.text_model
        l = input_ids.shape[1]
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding.weight[:l]
        causal = torch.tril(torch.ones(l, l, dtype=torch.bool, device=input_ids.device))[None, None]
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        return tm.final_layer_norm(x)


class CLIPTextModelWithProjection(CLIPTextModel):
    """The text tower, its EOS-token pooling and ``text_projection``
    (transformers' CLIPTextModelWithProjection; JAX clip.py:208)."""

    def __init__(self, config: CLIPTextConfig = CLIP_VIT_L_TEXT, projection_dim: int = 768):
        super().__init__(config)
        self.text_projection = nn.Linear(config.hidden_size, projection_dim, bias=False)

    def forward(self, input_ids: torch.Tensor, eos_token_id: int = 49407) -> Tuple[torch.Tensor, torch.Tensor]:
        """input_ids [B, L] -> (last_hidden_state [B, L, hidden], projected
        pooled [B, projection_dim]); pooled is the hidden state at the first
        EOS token (position 0 when there is none, as JAX's argmax)."""
        hidden = super().forward(input_ids)
        eos = (input_ids == eos_token_id).int().argmax(dim=-1)
        pooled = hidden[torch.arange(hidden.shape[0], device=hidden.device), eos]
        return hidden, self.text_projection(pooled)


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        g = cfg.image_size // cfg.patch_size
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size, stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(g * g + 1, cfg.hidden_size)


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = _Encoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPVisionModel(nn.Module):
    """ViT vision tower (JAX clip.py:161): pixels [B, 3, H, W] (CLIP-
    normalised) -> (pooled_proj [B, P], patch_tokens_proj [B, N, P]), where
    the class token and every patch token go through post_layernorm and
    ``visual_projection``. A patch grid other than the native one
    interpolates the position embeddings bicubically (torch's kernel)."""

    def __init__(self, config: CLIPVisionConfig = CLIP_VIT_L_VISION_336):
        super().__init__()
        self.config = config
        self.vision_model = _VisionTransformer(config)
        self.visual_projection = nn.Linear(config.hidden_size, config.projection_dim, bias=False)

    def position_embeddings(self, gh: int, gw: int) -> torch.Tensor:
        cfg = self.config
        pos = self.vision_model.embeddings.position_embedding.weight
        g0 = cfg.image_size // cfg.patch_size
        if (gh, gw) == (g0, g0):
            return pos
        grid0 = pos[1:].reshape(g0, g0, cfg.hidden_size).float()
        wr = torch.from_numpy(_torch_bicubic_matrix(g0, gh)).to(pos.device)
        wc = torch.from_numpy(_torch_bicubic_matrix(g0, gw)).to(pos.device)
        grid = torch.einsum("ij,jkc->ikc", wr, torch.einsum("kl,jlc->jkc", wc, grid0))
        return torch.cat([pos[:1].float(), grid.reshape(gh * gw, cfg.hidden_size)], dim=0)

    def forward(self, pixels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg, vm = self.config, self.vision_model
        x = vm.embeddings.patch_embedding(pixels)  # [B, hidden, gh, gw]
        b, c, gh, gw = x.shape
        x = x.flatten(2).transpose(1, 2)
        cls = vm.embeddings.class_embedding.to(x.dtype).expand(b, 1, c)
        x = torch.cat([cls, x], dim=1) + self.position_embeddings(gh, gw)[None].to(x.dtype)
        x = vm.pre_layrnorm(x)
        for layer in vm.encoder.layers:
            x = layer(x)
        x = self.visual_projection(vm.post_layernorm(x))
        return x[:, 0], x[:, 1:]
