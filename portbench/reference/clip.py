"""CLIP ViT-L/14 (the text encoder Stable Diffusion v1.5 conditions on, and
the vision and text towers of openai/clip-vit-large-patch14-336) in plain
float32 PyTorch, from the published description and the checkpoints'
``config.json``; transformers' parameter names.

Both towers are pre-LayerNorm transformer encoders: self-attention with
biased q/k/v/out projections, then an MLP with quick GELU (x sigmoid(1.702
x)), each added back. Text: token plus learned position embeddings, a
causal mask, the final LayerNorm; the pooled state is the one at the first
end-of-text token, through ``text_projection``. Vision: 14x14 patches by a
bias-free conv, a class token, learned position embeddings (bicubically
resized, align_corners False, when the patch grid is not the native one),
pre_layrnorm, the encoder, then post_layernorm and ``visual_projection`` on
every token, as the CLIP patch-ranking baseline scores them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.common import Conv2d, Embedding, LayerNorm, Linear, Ref, _param, attention

EOS = 49407


class SelfAttention(Ref):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (Linear(dim, dim) for _ in range(4))

    def forward(self, x, mask=None):
        b, n, c = x.shape
        split = lambda t: t.view(b, n, self.heads, c // self.heads).transpose(1, 2)  # noqa: E731
        o = attention(self.prec, split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x)), mask)
        return self.out_proj(o.transpose(1, 2).reshape(b, n, c))


class MLP(Ref):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.fc1, self.fc2 = Linear(dim, inner), Linear(inner, dim)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))


class Layer(Ref):
    def __init__(self, dim: int, inner: int, heads: int, eps: float):
        super().__init__()
        self.layer_norm1, self.self_attn = LayerNorm(dim, eps), SelfAttention(dim, heads)
        self.layer_norm2, self.mlp = LayerNorm(dim, eps), MLP(dim, inner)

    def forward(self, x, mask=None):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Encoder(Ref):
    def __init__(self, cfg: Dict):
        super().__init__()
        self.layers = nn.ModuleList([
            Layer(cfg["hidden_size"], cfg["intermediate_size"], cfg["num_attention_heads"], cfg["layer_norm_eps"])
            for _ in range(cfg["num_hidden_layers"])
        ])


class _TextEmbeddings(Ref):
    def __init__(self, cfg: Dict):
        super().__init__()
        self.token_embedding = Embedding(cfg["vocab_size"], cfg["hidden_size"])
        self.position_embedding = Embedding(cfg["max_position_embeddings"], cfg["hidden_size"])


class _TextModel(Ref):
    def __init__(self, cfg: Dict):
        super().__init__()
        self.embeddings = _TextEmbeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = LayerNorm(cfg["hidden_size"], cfg["layer_norm_eps"])


class TextEncoder(Ref):
    """``forward(ids [B, L]) -> last_hidden_state [B, L, hidden]``; with a
    ``projection_dim`` also ``pooled(ids)``."""

    def __init__(self, cfg: Dict, projection_dim: int | None = None):
        super().__init__()
        self.text_model = _TextModel(cfg)
        if projection_dim is not None:
            self.text_projection = Linear(cfg["hidden_size"], projection_dim, bias=False)

    def forward(self, ids):
        tm = self.text_model
        n = ids.shape[1]
        x = tm.embeddings.token_embedding.weight[ids] + tm.embeddings.position_embedding.weight[:n]
        causal = torch.tril(torch.ones(n, n, dtype=torch.bool, device=ids.device))
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        return tm.final_layer_norm(x)

    def pooled(self, ids):
        hidden = self(ids)
        eos = (ids == EOS).int().argmax(dim=-1)
        return self.text_projection(hidden[torch.arange(ids.shape[0], device=ids.device), eos])


class _VisionEmbeddings(Ref):
    INIT = {"class_embedding": (0.0, 0.02)}

    def __init__(self, cfg: Dict):
        super().__init__()
        g = cfg["image_size"] // cfg["patch_size"]
        self.class_embedding = _param(cfg["hidden_size"])
        self.patch_embedding = Conv2d(cfg["num_channels"], cfg["hidden_size"], cfg["patch_size"],
                                      stride=cfg["patch_size"], bias=False)
        self.position_embedding = Embedding(g * g + 1, cfg["hidden_size"])


class _VisionModel(Ref):
    def __init__(self, cfg: Dict):
        super().__init__()
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = LayerNorm(cfg["hidden_size"], cfg["layer_norm_eps"])
        self.encoder = _Encoder(cfg)
        self.post_layernorm = LayerNorm(cfg["hidden_size"], cfg["layer_norm_eps"])


class VisionTower(Ref):
    """``forward(pixels [B, 3, H, W], CLIP-normalised) -> (pooled [B, P],
    patch tokens [B, N, P])``, both through ``visual_projection``."""

    def __init__(self, cfg: Dict, projection_dim: int):
        super().__init__()
        self.grid = cfg["image_size"] // cfg["patch_size"]
        self.vision_model = _VisionModel(cfg)
        self.visual_projection = Linear(cfg["hidden_size"], projection_dim, bias=False)

    def positions(self, gh: int, gw: int) -> torch.Tensor:
        pos = self.vision_model.embeddings.position_embedding.weight
        if (gh, gw) == (self.grid, self.grid):
            return pos
        grid = pos[1:].reshape(1, self.grid, self.grid, -1).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(gh, gw), mode="bicubic", align_corners=False)
        return torch.cat([pos[:1], grid[0].flatten(1).t()], dim=0)

    def forward(self, pixels) -> Tuple[torch.Tensor, torch.Tensor]:
        vm = self.vision_model
        x = vm.embeddings.patch_embedding(pixels.float())
        b, c, gh, gw = x.shape
        x = torch.cat([vm.embeddings.class_embedding.expand(b, 1, c), x.flatten(2).transpose(1, 2)], dim=1)
        x = vm.pre_layrnorm(x + self.positions(gh, gw)[None])
        for layer in vm.encoder.layers:
            x = layer(x)
        x = self.visual_projection(vm.post_layernorm(x))
        return x[:, 0], x[:, 1:]
