"""LoRA finetuning of the UNet's attention projections (counterpart of
diffmining_tpu/finetuning/lora.py; the reference attaches peft adapters,
finetuning/base.py:199-205).

The sites are ``to_q``, ``to_k``, ``to_v`` and ``to_out.0`` of every
``attn1`` and ``attn2`` (JAX ``LORA_TARGETS``), in the JAX package's site
order (down blocks, mid block, up blocks; attn1 before attn2; q, k, v, out).
A site's factors are ``a`` [in, r] ~ N(0, 1)/r and ``b`` [r, out] = 0, and
its weight becomes W + (a@b)ᵀ on the port's [out, in] layout (``merge_lora``
takes JAX's ``scale``; training uses 1).

The merge happens where the weight is used: ``attach`` hands each
``Attention`` its factors and the module merges them in its own forward
(models/unet.py ``Attention._proj``). A merge swapped in around the forward
(``torch.func.functional_call``, or a context that puts the base back on
exit) would be undone before gradient checkpointing recomputes a block in
the backward, and the factors' gradients would be silently wrong.
``use_factors`` swaps factor sets for inference only (the EMA's, in the
trainer's previews).
"""
from __future__ import annotations

import contextlib
import re
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn as nn

LORA_TARGETS = ("to_q", "to_k", "to_v", "to_out.0")
_SITE = re.compile(r"^(.*\.attn[12])\.(" + "|".join(map(re.escape, LORA_TARGETS)) + ")$")

Factors = Dict[str, Dict[str, torch.Tensor]]  # site -> {"a": [in, r], "b": [r, out]}


def lora_sites(unet: nn.Module) -> List[Tuple[str, nn.Linear]]:
    """(name, linear) of every LoRA site, in the JAX package's ``_walk``
    order (module registration order: down, mid, up)."""
    return [(n, m) for n, m in unet.named_modules() if isinstance(m, nn.Linear) and _SITE.match(n)]


def init_lora_params(unet: nn.Module, rank: int, generator: torch.Generator) -> Factors:
    """a ~ N(0, 1)/rank [in, r] (one draw a site, in site order, from
    ``generator``), b = 0 [r, out]; float32 on the UNet's device."""
    out: Factors = {}
    for name, lin in lora_sites(unet):
        kout, kin = lin.weight.shape
        a = torch.randn((kin, rank), generator=generator, device=generator.device, dtype=torch.float32) / rank
        out[name] = {"a": a.to(lin.weight.device),
                     "b": torch.zeros((rank, kout), dtype=torch.float32, device=lin.weight.device)}
    return out


def merge_lora(params: Dict[str, torch.Tensor], lora: Factors, scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """The state dict ``params`` with weight + scale·(a@b)ᵀ at every site of
    ``lora`` (the JAX ``merge_lora`` on [out, in] weights)."""
    out = dict(params)
    for site, f in lora.items():
        w = params[f"{site}.weight"]
        out[f"{site}.weight"] = w + ((f["a"] @ f["b"]) * scale).t().to(w.dtype)
    return out


def count_lora_params(lora: Factors) -> int:
    return sum(t.numel() for f in lora.values() for t in f.values())


def flatten(lora: Factors) -> Dict[str, torch.Tensor]:
    """{site: {"a", "b"}} -> {"site.a": a, "site.b": b} (the train state's
    parameter dict)."""
    return {f"{site}.{k}": t for site, f in lora.items() for k, t in f.items()}


def unflatten(flat: Dict[str, torch.Tensor]) -> Factors:
    out: Factors = {}
    for key, t in flat.items():
        site, k = key.rsplit(".", 1)
        out.setdefault(site, {})[k] = t
    return out


def _attention_of(unet: nn.Module, site: str) -> Tuple[nn.Module, str]:
    path, proj = _SITE.match(site).groups()
    return unet.get_submodule(path), proj


def attach(unet: nn.Module, lora: Factors) -> None:
    """Hand every site's Attention its factors (and every other Attention
    none): from then on the module's forward merges them."""
    for name, m in unet.named_modules():
        if re.search(r"\.attn[12]$", name):
            m.lora = None
    for site, f in lora.items():
        attn, proj = _attention_of(unet, site)
        if attn.lora is None:
            attn.lora = {}
        attn.lora[proj] = (f["a"], f["b"])


@contextlib.contextmanager
def use_factors(unet: nn.Module, lora: Factors, restore: Factors) -> Iterator[None]:
    """Inference with other factors (e.g. the EMA's), ``restore`` attached
    again on exit. Not for a pass that is differentiated: see the module
    docstring."""
    attach(unet, lora)
    try:
        yield
    finally:
        attach(unet, restore)
