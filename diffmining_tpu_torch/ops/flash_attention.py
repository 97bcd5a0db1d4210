"""No-max flash attention forward: the hand-written CUDA kernel and its plain
PyTorch version (counterpart of the no-max kernels of
diffmining_tpu/ops/flash_attention.py).

``flash_fwd_nomax`` launches ``csrc/flash_fwd_nomax.cu``, one kernel that
replaces both ``_flash_kernel_t_1shot`` and ``_flash_kernel_t_nomax`` (the
source's header says why one suffices on Hopper). ``flash_attention_nomax_plain``
repeats the same arithmetic step by step in PyTorch: the CPU tests use it, and
``chip_smoke.py`` holds the kernel against it on the card. The wrapper takes
the plain version only for a tensor that lies on the CPU; for a CUDA tensor it
launches the kernel or raises.

The kernel is built with ``nvcc`` at first use, from the source in this
package, into ``build/kernels/`` beside the package (a plain C entry point
loaded with ``ctypes``), so importing this module needs neither a GPU nor nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

LOG2E = 1.4426950408889634
HEAD_DIMS = (40, 80, 160)  # the kernel's instantiations: SD-v1.5's self-attention head dims
_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "flash_fwd_nomax.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _prescale(q: torch.Tensor, scale: float) -> float:
    """scale·log2e rounded to q's dtype — the TPU kernels' caller multiplies
    q by ``jnp.asarray(scale * LOG2E, q.dtype)`` (flash_attention.py:363)."""
    return torch.tensor(scale * LOG2E, dtype=q.dtype).item()


def flash_attention_nomax_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """The no-max kernels' arithmetic in plain PyTorch. q [B,H,Lq,D], k/v
    [B,H,Lk,D] -> [B,H,Lq,D] in q's dtype.

    q is pre-scaled by scale·log2e in q's dtype; logits are fp32; p = exp2
    with subnormal results flushed to zero (as XLA and the TPU do, and as the
    kernel's ex2.approx.ftz does); p is cast to v's dtype before PV; the
    denominator is the fp32 sum of those rounded p (the ones column); the
    output is acc · (1 / max(l, 1e-30)) cast to q's dtype. A row whose
    natural-log logits are all below about −87 comes out as zeros: the
    designed underflow edge.
    """
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d**0.5)
    qs = q * _prescale(q, scale)
    logits = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    p = torch.exp2(logits)
    p = torch.where(p < torch.finfo(torch.float32).tiny, torch.zeros_like(p), p)
    pc = p.to(v.dtype).float()
    acc = torch.matmul(pc, v.float())
    l_safe = pc.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return (acc * (1.0 / l_safe)).to(q.dtype)


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output of the build this process made (-Xptxas -v)


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the flash kernel is built from source at first use")


def build() -> Path:
    """Compile the kernel into build/kernels/ (keyed by the source's and the
    flags' hash, so an edited source rebuilds) and return the library path."""
    global build_log
    src = _SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"flash_fwd_nomax-{key}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
        capture_output=True, text=True,
    )
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {_SOURCE.name}:\n{build_log}")
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.flash_fwd_nomax
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_fwd_nomax: q, k and v must all be CUDA tensors")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_fwd_nomax: q, k and v must be on one device")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"flash_fwd_nomax: bf16 only, got {q.dtype}/{k.dtype}/{v.dtype} "
                         "(float32 runs on the CPU)")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"flash_fwd_nomax: expected [B,H,L,D], got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[1] != h or k.shape[3] != d:
        raise ValueError(f"flash_fwd_nomax: q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_fwd_nomax: head dim {d} is not one of SD-v1.5's {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_fwd_nomax: {name}'s head dim must be contiguous")
        if any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"flash_fwd_nomax: {name}'s strides and base must be 16-byte aligned")


def flash_fwd_nomax(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v without the running max. q [B,H,Lq,D], k/v
    [B,H,Lk,D] (strided views allowed, head dim contiguous) -> [B,H,Lq,D].

    CPU tensors take the plain version. CUDA tensors launch the kernel on
    the current stream, or raise on anything it does not take; the output is
    a [B,H,Lq,D] view of a [B,Lq,H,D] buffer, so merging heads is free.
    ``flash_fwd_nomax.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_attention_nomax_plain(q, k, v, scale)
    _check(q, k, v)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    scale = scale if scale is not None else 1.0 / (d**0.5)
    out = torch.empty((b, lq, h, d), device=q.device, dtype=q.dtype).permute(0, 2, 1, 3)
    strides = (ctypes.c_longlong * 12)(*[s for t in (q, k, v, out) for s in t.stride()[:3]])
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_fwd_nomax(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, lq, lk, d, ctypes.cast(strides, ctypes.c_void_p), _prescale(q, scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd_nomax launch failed: CUDA error {err}")
    flash_fwd_nomax.launches += 1
    return out


flash_fwd_nomax.launches = 0
