"""Seeded random weights, made on the device in a few large calls.

A model's parameters are listed by its reference module (built on the meta
device, so nothing is allocated): name, shape and the normal draw its
module's ``INIT`` names, where ``None`` is the fan-in rule (standard
deviation fan_in^-1/2, as flax's lecun-normal). One ``torch.randn`` over a
flat float32 buffer from a generator on the card makes every value; each
parameter is a view of it, scaled and shifted in place, and the whole
buffer is cast once to the dtype the weights are served in. The same seed
and stream give the same weights to the program and to the reference.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.seeds import derive

Spec = List[Tuple[str, Tuple[int, ...], float, float]]  # name, shape, mean, std


def spec(model: torch.nn.Module) -> Spec:
    out: Spec = []
    for prefix, mod in model.named_modules():
        init = getattr(type(mod), "INIT", {})
        for pname, p in mod.named_parameters(recurse=False):
            rule = init[pname]
            if rule is None:
                fan_in = math.prod(p.shape[1:])
                mean, std = 0.0, fan_in ** -0.5
            else:
                mean, std = rule
            out.append((f"{prefix}.{pname}" if prefix else pname, tuple(p.shape), mean, std))
    return out


def make(model_spec: Spec, seed: int, stream: str, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """{name: tensor} views of one buffer in ``dtype`` on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, stream))
    total = sum(math.prod(s) for _, s, _, _ in model_spec)
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    views, off = [], 0
    for name, shape, mean, std in model_spec:
        n = math.prod(shape)
        flat[off:off + n].mul_(std).add_(mean)
        views.append((name, off, n, shape))
        off += n
    if dtype != torch.float32:
        flat = flat.to(dtype)
    return {name: flat[o:o + n].view(shape) for name, o, n, shape in views}
