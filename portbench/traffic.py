"""The general generator of the cells' inputs, read from each workload's
``traffic`` parameters: synthetic images, token ids and the per-image
random draws, all from the run's seed.

Images are smooth random fields (a coarse normal grid resized bicubically,
plus fine noise, squashed into [-1, 1]), so that encoders see structure at
every scale. Prompts become token ids by a fixed rule of this file (the
port's random-weight bundles have no vocabulary to tokenise with): the
start token, one id a word from a hash of the word, the end-of-text token,
then end-of-text padding to 77. The program and the reference get the same
images, ids and draws.
"""
from __future__ import annotations

import io
import os
import zlib
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from portbench.seeds import derive

BOS, EOS, CONTEXT = 49406, 49407, 77


def images(seed: int, stream: str, n: int, height: int, width: int, device) -> np.ndarray:
    """[n, height, width, 3] float32 in [-1, 1] on the host."""
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, "images", stream))
    coarse = torch.randn((n, 3, max(height // 16, 2), max(width // 16, 2)), generator=g, device=device)
    fine = torch.randn((n, 3, height, width), generator=g, device=device)
    x = F.interpolate(coarse, size=(height, width), mode="bicubic", align_corners=False) + 0.25 * fine
    return torch.tanh(0.8 * x).permute(0, 2, 3, 1).contiguous().cpu().numpy()


def to_uint8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.round((x + 1.0) * 127.5), 0, 255).astype(np.uint8)


def jpeg_bytes(x: np.ndarray, quality: int = 95) -> bytes:
    """One [H, W, 3] image in [-1, 1] as JPEG file bytes."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(to_uint8(x)).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


class Tokenizer:
    """``tokenizer(prompts) -> int64 [n, 77]``, the rule of the module
    docstring, with ``vocab_size`` ids."""

    def __init__(self, vocab_size: int = 49408):
        self.vocab_size = vocab_size

    def ids(self, prompt: str) -> List[int]:
        words = [zlib.crc32(w.encode()) % (self.vocab_size - 2) for w in prompt.lower().split()]
        ids = [self.vocab_size - 2] + words[:CONTEXT - 2] + [self.vocab_size - 1]
        return ids + [self.vocab_size - 1] * (CONTEXT - len(ids))

    def __call__(self, prompts: Sequence[str]) -> np.ndarray:
        return np.array([self.ids(p) for p in prompts], dtype=np.int64)


def uid(path: str) -> int:
    """The uid an image's draws are keyed by: the CRC-32 of its file's
    name, as the sweep engine keys them."""
    return zlib.crc32(os.path.basename(path).encode("utf-8"))


def draws(seed: int, uid: int, n: int, latent_shape, t_range, device):
    """One image's posterior eps [C, h, w], eps [n, C, h, w] and t [n]
    (uniform on [t_range[0], t_range[1]))."""
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, "draws", uid))
    posterior = torch.randn(tuple(latent_shape), generator=g, device=device)
    noise = torch.randn((n, *latent_shape), generator=g, device=device)
    t = torch.randint(int(t_range[0]), int(t_range[1]), (n,), generator=g, device=device)
    return posterior, noise, t
