"""What the entries share: the program's modules built on the meta device
and given the benchmark's weights, the reference's modules with the same
weights, and the spans around the program's attention entry."""
from __future__ import annotations

import gc
from typing import Dict, Iterable, List, Tuple

import torch

from portbench import counts, tracing, weights
from portbench.reference.common import Precision, materialize

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def port_module(build, state: Dict[str, torch.Tensor], device, missing_ok: Tuple[str, ...] = ()):
    """``build()`` on the meta device, then on ``device`` holding ``state``
    (its tensors, not copies); parameters under ``missing_ok`` are zeros."""
    with torch.device("meta"):
        module = build()
    module = module.to_empty(device=device)
    missing, unexpected = module.load_state_dict(state, strict=False, assign=True)
    bad = [k for k in missing if not k.startswith(missing_ok)]
    if bad or unexpected:
        raise KeyError(f"{type(module).__name__}: missing {bad[:5]}, unexpected {unexpected[:5]}")
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name in missing:
                p.zero_()
    return module


def ref_spec(build):
    with torch.device("meta"):
        return weights.spec(build())


def reference(build, seed: int, stream: str, device, dtype: torch.dtype, precision: str):
    """The reference module with the weights the program was given (made in
    ``dtype`` from the same seed, then float32), computing in ``precision``."""
    with torch.device("meta"):
        model = build()
    state = weights.make(weights.spec(model), seed, stream, device, dtype)
    return materialize(model, state, device).set_precision(Precision(precision))


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b| over all elements, in float64."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-300))


def attention_spans(run, modules: Iterable, precision: str):
    """Patches of ``sdpa`` in the given program modules: every call with
    Lq = Lk >= 1024 and no mask runs inside a "pb.attn" span (its backward,
    under grad, inside "pb.attn.bwd"), and its work is recorded in
    ``run.work`` as ("attn", (b, h, l, d, elem, precision))."""
    patches: List = []

    def factory(orig):
        def sdpa(q, k, v, mask=None, scale=None):
            if mask is not None or q.shape[2] < 1024 or q.shape[2] != k.shape[2]:
                return orig(q, k, v, mask=mask, scale=scale)
            b, h, lq, d = q.shape
            run.work.append(("attn", (b, h, lq, d, q.element_size(), precision)))
            with tracing.span("pb.attn"):
                out = orig(q, k, v, mask=mask, scale=scale)
            if out.grad_fn is not None:
                run.work.append(("attn_bwd", (b, h, lq, d, q.element_size(), precision)))
                tracing.around_backward(out.grad_fn, "pb.attn.bwd")
            return out

        return sdpa

    for mod in modules:
        patches.append(tracing.patched(mod, "sdpa", factory))
    return patches


def attn_bound_and_count(run) -> Tuple[float, int]:
    """The seconds the recorded attention work needs at the card's peaks."""
    total, n = 0.0, 0
    for kind, p in run.work:
        if kind in ("attn", "attn_bwd"):
            b, h, l, d, elem, prec = p
            fn = counts.attention_forward if kind == "attn" else counts.attention_backward
            flops, nbytes = fn(b, h, l, l, d, elem)
            total += counts.bound_seconds(flops, nbytes, prec)
            n += 1
    return total, n


def halves(rng, ks, group: int, n: int):
    """``n`` of ``ks`` drawn by ``rng``, alternately from the first and the
    second half of their position in a batch of ``group`` (so that a
    sample sees both halves of every batch)."""
    parts = [[k for k in ks if k % group < group // 2], [k for k in ks if k % group >= group // 2]]
    out = []
    for i in range(n):
        part = [k for k in parts[i % 2] if k not in out] or [k for k in ks if k not in out]
        if not part:
            break
        out.append(rng.choice(part))
    return sorted(out)
