"""Plain PyTorch building blocks of the references, and the precision they
compute in.

Every reference computes in float32 with TF32 off (``Precision("fp32")``).
The same modules also compute the controls (``portbench/calibrate.py``):
``"tf32"`` runs the float32 matmuls and convolutions with TF32 on, and
``"fp8"`` rounds both operands of every matmul and convolution to
float8_e4m3fn with one scale a tensor (amax / 448) before a float32
product, as an fp8 path with per-tensor scaling would. Norms, softmax and
elementwise work stay float32 in every mode.

Nothing here imports the program under test. Each module carries the init
of its parameters (``INIT``: mean and standard deviation of a normal draw,
``None`` for the fan-in rule), which ``portbench/weights.py`` reads.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_MAX = 448.0


class Precision:
    """The arithmetic of the reference's products: "fp32", "tf32" or "fp8"."""

    MODES = ("fp32", "tf32", "fp8")

    def __init__(self, mode: str = "fp32"):
        if mode not in self.MODES:
            raise ValueError(f"precision {mode!r}: expected one of {self.MODES}")
        self.mode = mode

    @contextlib.contextmanager
    def active(self):
        """TF32 on only in "tf32" mode; the previous flags restored after."""
        prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        on = self.mode == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield self
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` rounded as this mode's products take it; under autograd the
        rounding passes the gradient straight through (the backward's
        products stay float32)."""
        if self.mode != "fp8":
            return t
        with torch.no_grad():
            scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
            rounded = (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return t + (rounded - t).detach() if t.requires_grad else rounded


FP32 = Precision("fp32")


class Ref(nn.Module):
    """A reference module: the precision of its products, shared by every
    submodule (``set_precision``)."""

    prec: Precision = FP32

    def set_precision(self, prec: Precision) -> "Ref":
        for m in self.modules():
            if isinstance(m, Ref):
                m.prec = prec
        return self


def _param(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape))


class Linear(Ref):
    INIT = {"weight": None, "bias": (0.0, 0.02)}

    def __init__(self, n_in: int, n_out: int, bias: bool = True):
        super().__init__()
        self.weight = _param(n_out, n_in)
        self.bias = _param(n_out) if bias else None

    def forward(self, x):
        p = self.prec
        return F.linear(p.operand(x), p.operand(self.weight), self.bias)


class Conv2d(Ref):
    INIT = {"weight": None, "bias": (0.0, 0.02)}

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1, padding: int = 0, bias: bool = True):
        super().__init__()
        self.weight = _param(c_out, c_in, k, k)
        self.bias = _param(c_out) if bias else None
        self.stride, self.padding = stride, padding

    def forward(self, x):
        p = self.prec
        return F.conv2d(p.operand(x), p.operand(self.weight), self.bias, self.stride, self.padding)


class GroupNorm(Ref):
    INIT = {"weight": (1.0, 0.02), "bias": (0.0, 0.02)}

    def __init__(self, groups: int, ch: int, eps: float):
        super().__init__()
        self.weight, self.bias = _param(ch), _param(ch)
        self.groups, self.eps = groups, eps

    def forward(self, x):
        return F.group_norm(x, self.groups, self.weight, self.bias, self.eps)


class LayerNorm(Ref):
    INIT = {"weight": (1.0, 0.02), "bias": (0.0, 0.02)}

    def __init__(self, ch: int, eps: float):
        super().__init__()
        self.weight, self.bias = _param(ch), _param(ch)
        self.eps = eps

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.weight, self.bias, self.eps)


class Embedding(Ref):
    INIT = {"weight": (0.0, 0.02)}

    def __init__(self, n: int, dim: int):
        super().__init__()
        self.weight = _param(n, dim)


def attention(prec: Precision, q, k, v, mask: Optional[torch.Tensor] = None, block: int = 1024):
    """softmax(q kᵀ / sqrt(D)) v over [B, H, L, D] in float32, a block of
    query rows at a time so that the logits fit; ``mask`` [.., Lq, Lk] is
    True where attention is allowed."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    out = torch.empty(*q.shape[:-1], v.shape[-1], dtype=torch.float32, device=q.device)
    kt = prec.operand(k).transpose(-1, -2)
    vv = prec.operand(v)
    for i in range(0, q.shape[2], block):
        s = torch.matmul(prec.operand(q[:, :, i:i + block]), kt) * scale
        if mask is not None:
            s = s.masked_fill(~mask[..., i:i + block, :], float("-inf"))
        out[:, :, i:i + block] = torch.matmul(prec.operand(torch.softmax(s, dim=-1)), vv)
    return out


def materialize(model: Ref, state, device) -> Ref:
    """The module on ``device`` with ``state`` (float32) loaded, every key
    required."""
    model = model.to_empty(device=device)
    model.load_state_dict({k: v.float() for k, v in state.items()}, strict=True)
    return model.eval().requires_grad_(False)
