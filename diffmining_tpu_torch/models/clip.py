"""CLIP text encoder in PyTorch (counterpart of diffmining_tpu/models/clip.py
``CLIPTextModel``).

transformers state-dict keys (``text_model.encoder.layers.0.self_attn.q_proj
.weight``). The output SD conditions on is ``last_hidden_state`` after the
final LayerNorm, [B, 77, hidden], under a causal mask.
"""
from __future__ import annotations

import dataclasses

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


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu  # exact erf GELU
    raise ValueError(name)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.heads = cfg.num_heads
        self.q_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.k_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.v_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.out_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x, mask):
        b, l, c = x.shape
        q, k, v = (
            m(x).view(b, l, self.heads, c // self.heads).transpose(1, 2)
            for m in (self.q_proj, self.k_proj, self.v_proj)
        )
        return self.out_proj(sdpa(q, k, v, mask=mask).transpose(1, 2).reshape(b, l, c))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = _act(cfg.hidden_act)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
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
