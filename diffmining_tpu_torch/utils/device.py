"""Device selection and numeric set-up for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Entry points run on the GPU unless the caller asks for the CPU; a CUDA
    request on a machine without one raises instead of running elsewhere.

    Every set-up of the port resolves its device here, so this is where
    the port's float32 policy is set: no TF32 (``exact_float32``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --device cpu) "
            "to run the port on the CPU"
        )
    exact_float32()
    return dev


def exact_float32() -> None:
    """Float32 matmuls and cuDNN convolutions in full float32 (no TF32).

    PyTorch computes float32 convolutions in TF32 (a 10-bit mantissa) by
    default; a float32 run of the port (``--dtype fp32``, ``finetune
    --mixed_precision no``, the CLIP towers, the Doersch baseline) must
    compute what the JAX package computes in float32, which the float32
    kernels do (fp32 FMA only). bf16 work is untouched: the flags govern
    float32 operands alone. They are process-wide and do nothing on the
    CPU. Only the legacy flags are set: newer PyTorch may refuse a mix with
    its ``fp32_precision`` settings."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
