"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Entry points run on the GPU unless the caller asks for the CPU; a CUDA
    request on a machine without one raises instead of running elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --device cpu) "
            "to run the port on the CPU"
        )
    return dev
