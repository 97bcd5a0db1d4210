"""Operations and bytes of the cells' work, from shapes alone, and the
card's published peaks.

A model's FLOPs are those of its reference module's matrix products and
convolutions (2 per multiply-add) at the given input shapes, counted by
``torch.utils.flop_counter`` while the reference runs on the meta device:
no memory, no arithmetic, and nothing of what the program launches. An
attention call's work is counted apart (``attention_*``): 4 B H Lq Lk D in
the forward (q kᵀ and p v), 10 B H L² D in the backward (the logits again,
dv, dp, dq, dk), and its bytes are each input read once and each output
written once.

Peaks of one NVIDIA H100 SXM (data sheet, dense, at the full 700 W): 989
TFLOP/s bf16, 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s HBM3.
"""
from __future__ import annotations

import functools
from typing import Callable, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12


def model_flops(build: Callable[[], torch.nn.Module], call: Callable, *shapes: Tuple, dtypes=None) -> int:
    """FLOPs of ``call(model, *inputs)`` with meta inputs of ``shapes``
    (float32, or ``dtypes``) on the meta device."""
    with torch.device("meta"):
        model = build()
        inputs = [torch.empty(s, dtype=(dtypes[i] if dtypes else torch.float32)) for i, s in enumerate(shapes)]
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        call(model, *inputs)
    return int(counter.get_total_flops())


@functools.lru_cache(maxsize=None)
def unet_flops(cfg_key: str, cfg_json: str, rows: int, h: int, w: int, ctx_len: int) -> int:
    """One UNet forward over ``rows`` latents of h x w."""
    import json

    from portbench.reference.unet import UNet

    cfg = json.loads(cfg_json)
    t = lambda m, x, tt, c: m(x, tt.long(), c)  # noqa: E731
    return model_flops(lambda: UNet(cfg), t, (rows, cfg["in_channels"], h, w), (rows,),
                       (rows, ctx_len, cfg["cross_attention_dim"]), dtypes=[torch.float32, torch.int64, torch.float32])


@functools.lru_cache(maxsize=None)
def vae_encoder_flops(cfg_key: str, cfg_json: str, rows: int, height: int, width: int) -> int:
    import json

    from portbench.reference.vae import VAEEncoder

    cfg = json.loads(cfg_json)
    return model_flops(lambda: VAEEncoder(cfg), lambda m, x: m.encode(x), (rows, cfg["in_channels"], height, width))


@functools.lru_cache(maxsize=None)
def text_flops(cfg_key: str, cfg_json: str, rows: int, length: int) -> int:
    import json

    from portbench.reference.clip import TextEncoder

    cfg = json.loads(cfg_json)
    return model_flops(lambda: TextEncoder(cfg), lambda m, ids: m(ids), (rows, length), dtypes=[torch.int64])


@functools.lru_cache(maxsize=None)
def vision_flops(cfg_key: str, cfg_json: str, projection_dim: int, rows: int, height: int, width: int) -> int:
    import json

    from portbench.reference.clip import VisionTower

    cfg = json.loads(cfg_json)
    return model_flops(lambda: VisionTower(cfg, projection_dim), lambda m, x: m(x),
                       (rows, cfg["num_channels"], height, width))


def attention_forward(b: int, h: int, lq: int, lk: int, d: int, elem: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of softmax(q kᵀ) v: q, k, v read once, o written once."""
    return 4 * b * h * lq * lk * d, elem * b * h * d * (2 * lq + 2 * lk)


def attention_backward(b: int, h: int, lq: int, lk: int, d: int, elem: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of the backward: q, k, v, o, do read and dq, dk, dv
    written once (the row statistics are counted as nothing)."""
    return 10 * b * h * lq * lk * d, elem * b * h * d * (4 * lq + 4 * lk)


def bound_seconds(flops: float, nbytes: float, precision: str) -> float:
    """The least time the card could take: the larger of operations over
    the peak of ``precision`` and bytes over HBM bandwidth."""
    return max(flops / PEAK_FLOPS[precision], nbytes / PEAK_BYTES)
