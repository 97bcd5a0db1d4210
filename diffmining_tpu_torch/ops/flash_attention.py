"""Flash attention: the hand-written CUDA kernels, their plain PyTorch
versions, the forward route gates and the autograd Function (counterpart of
diffmining_tpu/ops/flash_attention.py).

Nine kernels, one CUDA source each under ``csrc/``; six bf16:

  flash_fwd_nomax   no-max forward (TPU ``_flash_kernel_t_1shot``, K1, and
                    ``_flash_kernel_t_nomax``, K2): the UNet without grad
                    under the default modes;
  flash_fwd_online  online-softmax forward without lse (TPU
                    ``_flash_kernel_t``, K3): the UNet without grad when the
                    no-max modes are off;
  flash_fwd_lse     online-softmax forward that also writes the natural-log
                    logsumexp (TPU ``_flash_kernel``, K4): the forward under
                    grad, and without grad under ``DIFFMINING_ATTN_TLAYOUT=0``;
  flash_bwd_dq      dq from lse, and delta from dO and o (TPU
                    ``_bwd_dq_kernel``, K5, and the delta of ``_bwd_pallas``);
  flash_bwd_dkv     dk and dv from lse and delta (TPU ``_bwd_dkv_kernel``, K6);

and three float32 (fp32 FMA only: no TF32, no bf16), for every float32 run
on the card (the UNet under ``--dtype fp32`` and ``finetune
--mixed_precision no``, the CLIP vision towers from crop 448 on):

  flash_fwd_f32     the float32 forward in three modes of one loop: online
                    (K3), no-max (K1/K2) and online with the lse (K4);
  flash_bwd_dq_f32  K5 in float32, with delta, flash_bwd_dq's interface;
  flash_bwd_dkv_f32 K6 in float32, flash_bwd_dkv's interface.

``flash_fwd_nomax``, ``flash_fwd_online``, ``flash_fwd_lse``,
``flash_bwd_dq`` and ``flash_bwd_dkv`` hand their float32 CUDA calls to the
``*_f32`` wrappers (``variant`` decides from the dtype and the head dim).

``forward_route`` picks among K1-K4 for a forward without grad as the JAX
``sdpa`` and ``_flash_forward_t`` do, from the same environment variables,
read into module attributes at import (``_ONESHOT``, ``_NOMAX``,
``_BLOCK_Q``, ``_BLOCK_K``) or at call time (``DIFFMINING_ATTN_TLAYOUT``).

``FlashAttention`` is the counterpart of the JAX custom_vjp: its forward is
flash_fwd_lse and saves (q, k, v, o, lse); its backward forms the
pre-scaled q (``prescaled_q``) once and runs flash_bwd_dq, which also
forms delta = sum(dO * o), and flash_bwd_dkv. Each ``*_plain``
function repeats its kernel's arithmetic step by step in PyTorch (at
float32 every rounding to the operands' dtype is a no-op): the CPU tests
hold it to the Pallas kernels, and ``chip_smoke.py`` holds the kernel to it
on the card. A wrapper takes the plain version only for a tensor that lies
on the CPU; for a CUDA tensor it launches its kernel or raises. Each
wrapper counts its launches in ``.launches``.

The bf16 kernels take head dims 40, 80 and 160 (``HEAD_DIMS``), the float32
ones those and the CLIP towers' 64 (``F32_HEAD_DIMS``). They read strided
[B,L,H*D]-as-[B,H,L,D] views in place; they write [B,L,H,D] buffers and
return [B,H,L,D] views of them, so merging heads (and, in the backward,
handing the gradients back to the projections) needs no copy.

Each source under ``csrc/`` (these and ``gn_act_proj.cu`` and
``gn_act_proj_f32.cu``, the fused GroupNorm kernels of ops/fused_norm.py) is
built with ``nvcc`` at first use into ``build/kernels/`` beside the package (a plain C entry point loaded
with ``ctypes``), keyed by the hash of the source, the shared headers and
the flags, so importing this module needs neither a GPU nor nvcc.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG_INF = -1e30  # the TPU kernels' mask value
HEAD_DIMS = (40, 80, 160)  # the bf16 kernels' instantiations: SD-v1.5's self-attention head dims
# the float32 kernels' instantiations: SD-v1.5's and every CLIP vision tower's (64)
F32_HEAD_DIMS = (40, 64, 80, 160)
TPU_BLOCK_K = 1024  # the TPU kernel's key block (flash_attention.py:102, :148)
# The key tile of the CUDA online-softmax forward (K3, K4; BLOCK_N in
# csrc/flash_fwd_online.cuh): p is rounded to bf16 relative to the running max
# of each tile, so the plain versions equal the kernel only at this block_k.
ONLINE_BLOCK_K = 128
# The key tile of the float32 kernels (TILE in csrc/flash_f32.cuh): the online
# and lse modes take their running max per tile, which in float32 moves only
# roundings.
F32_BLOCK_K = 64
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# one source per kernel, one C entry point of the same name per source
ARGTYPES = {
    "flash_fwd_nomax": [_P] * 4 + [_I] * 5 + [_P, _F, _P],
    "flash_fwd_online": [_P] * 4 + [_I] * 5 + [_P, _F, _P],
    "flash_fwd_lse": [_P] * 5 + [_I] * 5 + [_P, _F, _P],
    "flash_fwd_f32": [_P] * 5 + [_I] * 6 + [_P, _F, _P],
    "flash_bwd_dq": [_P] * 8 + [_I] * 5 + [_P, _F, _P],
    "flash_bwd_dkv": [_P] * 8 + [_I] * 5 + [_P, _P],
    "flash_bwd_dq_f32": [_P] * 8 + [_I] * 5 + [_P, _F, _P],
    "flash_bwd_dkv_f32": [_P] * 8 + [_I] * 5 + [_P, _P],
    "gn_act_proj": [_P] * 7 + [_I] * 5 + [_F] + [_LL] * 3 + [_I] * 5 + [_P],
    "gn_act_proj_f32": [_P] * 7 + [_I] * 5 + [_F] + [_LL] * 3 + [_I] + [_P],
}
F32_SOURCES = ("flash_fwd_f32", "flash_bwd_dq_f32", "flash_bwd_dkv_f32", "gn_act_proj_f32")
SOURCES = tuple(ARGTYPES)

# The JAX package's forward gates (flash_attention.py:101-133), read from the
# same environment variables at import; tests set the attributes directly.
_BLOCK_Q = int(os.environ.get("DIFFMINING_FLASH_BLOCK_Q", "1024"))
_BLOCK_K = int(os.environ.get("DIFFMINING_FLASH_BLOCK_K", "1024"))
# no-max one-shot forward when the key row is one TPU key block: "0" off,
# "1" for Lq >= 4096 only, "all" (default) every single-block shape
_ONESHOT = os.environ.get("DIFFMINING_FLASH_ONESHOT", "all")
# multi-block no-max forward at Lq >= 4096 self-attention: "1" (default) on
_NOMAX = os.environ.get("DIFFMINING_FLASH_NOMAX", "1")


def _oneshot_auto(lq: int) -> bool:
    return _ONESHOT == "all" or (_ONESHOT == "1" and lq >= 4096)


def _nomax_auto(lq: int, lk: int) -> bool:
    return _NOMAX == "1" and lq >= 4096 and lq == lk


def block_policy(lq: int, lk: int) -> Tuple[int, int]:
    """The TPU forward's (block_q, block_k) (flash_attention.py:350-361):
    512/4096 for self-attention at L >= 4096 unless a block size is set in
    the environment, else min(_BLOCK, max(128, L)). It decides whether the
    key row is one block, and the plain K3's block size."""
    block_q = block_k = None
    if ("DIFFMINING_FLASH_BLOCK_Q" not in os.environ and "DIFFMINING_FLASH_BLOCK_K" not in os.environ
            and lq >= 4096 and lq == lk):
        block_q, block_k = 512, 4096
    return min(block_q or _BLOCK_Q, max(128, lq)), min(block_k or _BLOCK_K, max(128, lk))


def forward_route(lq: int, lk: int) -> str:
    """The TPU kernel ("K1".."K4") the JAX ``sdpa`` runs for a gated forward
    without grad at these lengths, under the current settings:
    ``DIFFMINING_ATTN_TLAYOUT=0`` takes the standard-layout primal
    (``_flash_forward``, K4; attention.py:126); otherwise
    ``_flash_forward_t`` (:378-416) takes K1 when the key row is one block
    and one-shot is on, else K2 when no-max is on, else K3."""
    if os.environ.get("DIFFMINING_ATTN_TLAYOUT", "1") == "0":
        return "K4"
    _, block_k = block_policy(lq, lk)
    if lk <= block_k and _oneshot_auto(lq):
        return "K1"
    if _nomax_auto(lq, lk):
        return "K2"
    return "K3"


def _prescale(q: torch.Tensor, scale: float) -> float:
    """scale·log2e rounded to q's dtype — the TPU kernels' callers multiply
    q by ``jnp.asarray(scale * LOG2E, q.dtype)`` (flash_attention.py:155,
    :363, :673)."""
    return _rounded(scale * LOG2E, q.dtype)


@functools.lru_cache(maxsize=None)
def _rounded(x: float, dtype: torch.dtype) -> float:
    return torch.tensor(x, dtype=dtype).item()


def prescaled_q(q: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """qs = q·bf16(scale·log2e) in q's dtype, the pre-scaled q that both
    backward kernels take: formed once a backward as one tensor operation,
    as ``_bwd_pallas`` forms ``qs_`` (flash_attention.py:673). It keeps q's
    strides, so a [B,L,H*D] view stays one."""
    return q * _prescale(q, _scale(q, scale))


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)


def _ftz(p: torch.Tensor) -> torch.Tensor:
    """Flush subnormal results to zero, as XLA, the TPU and the kernels'
    ex2.approx.ftz do."""
    return torch.where(p < torch.finfo(torch.float32).tiny, torch.zeros_like(p), p)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


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
    qs = q * _prescale(q, _scale(q, scale))
    logits = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    pc = _ftz(torch.exp2(logits)).to(v.dtype).float()
    acc = torch.matmul(pc, v.float())
    l_safe = pc.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return (acc * (1.0 / l_safe)).to(q.dtype)


def flash_fwd_lse_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None, block_k: int | None = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's arithmetic (flash_attention.py:59-87) in plain PyTorch: q
    [B,H,Lq,D], k/v [B,H,Lk,D] -> (o [B,H,Lq,D] in q's dtype, lse [B,H,Lq]
    float32, natural log).

    Over key blocks of ``block_k`` (default the TPU kernel's, min(1024,
    max(128, Lk)); the CUDA kernel's tiles are ``ONLINE_BLOCK_K``): the
    running max m in base 2 starts at −1e30, alpha = exp2(m_prev − m_new),
    p = exp2(s − m_new) is rounded to v's dtype, acc = acc·alpha + p·v and
    l = l·alpha + Σp (the ones column); o = acc·(1/max(l, 1e-30)), lse =
    m·ln2 + log(max(l, 1e-30)). The block size decides where p is rounded
    relative to which max, so only runs at the same block size agree to
    summation order."""
    lk = k.shape[2]
    block_k = block_k or min(TPU_BLOCK_K, max(128, lk))
    qs = (q * _prescale(q, _scale(q, scale))).float()
    kf, vf = k.float(), v.float()
    m = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for j in range(0, lk, block_k):
        s = torch.matmul(qs, kf[:, :, j:j + block_k].transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = _ftz(torch.exp2(m - m_new))
        pb = _ftz(torch.exp2(s - m_new[..., None])).to(v.dtype).float()
        acc = acc * alpha[..., None] + torch.matmul(pb, vf[:, :, j:j + block_k])
        l = l * alpha + pb.sum(dim=-1)
        m = m_new
    l_safe = l.clamp_min(1e-30)
    return (acc * (1.0 / l_safe)[..., None]).to(q.dtype), m * LN2 + torch.log(l_safe)


def flash_fwd_online_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None, block_k: int | None = None
) -> torch.Tensor:
    """K3's arithmetic (flash_attention.py:215-247), which is K4's without
    the lse: ``flash_fwd_lse_plain(...)[0]``. The default ``block_k`` is the
    TPU forward's (``block_policy``: the whole row up to 4096 keys at L >=
    4096, else min(1024, max(128, Lk))); the CUDA kernel's tiles are
    ``ONLINE_BLOCK_K``."""
    block_k = block_k or block_policy(q.shape[2], k.shape[2])[1]
    return flash_fwd_lse_plain(q, k, v, scale, block_k)[0]


def _probs(qs: torch.Tensor, k: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """p = exp2(qs·kᵀ − lse·log2e) in fp32: the softmax re-formed from the
    forward's logsumexp, with no max (flash_attention.py:595, :632)."""
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    return _ftz(torch.exp2(s - (lse.float() * LOG2E)[..., None]))


def attention_delta(g: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """delta = Σ_d dO·o in fp32, [B,H,Lq] contiguous (flash_attention.py:669)."""
    return (g.float() * o.float()).sum(dim=-1).contiguous()


def flash_bwd_dq_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
    scale: float | None = None,
) -> torch.Tensor:
    """K5's arithmetic (flash_attention.py:583-606): ds = (p·(dp − delta))
    cast to k's dtype with dp = dO·vᵀ, dq = (ds·k)·scale in q's dtype."""
    scale = _scale(q, scale)
    p = _probs(q * _prescale(q, scale), k, lse)
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta[..., None])).to(k.dtype).float()
    return (torch.matmul(ds, k.float()) * scale).to(q.dtype)


def flash_bwd_dkv_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
    scale: float | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's arithmetic (flash_attention.py:620-650): dv = pᵀ·dO with p cast
    to dO's dtype; ds = (p·(dp − delta)) cast to q's dtype; dk = (dsᵀ·qs)·ln2
    with qs the pre-scaled q (ln2 undoes its log2e)."""
    qs = q * _prescale(q, _scale(q, scale))
    p = _probs(qs, k, lse)
    dv = torch.matmul(p.to(g.dtype).float().transpose(-1, -2), g.float()).to(v.dtype)
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dk = (torch.matmul(ds.transpose(-1, -2), qs.float()) * LN2).to(k.dtype)
    return dk, dv


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}  # nvcc's output (-Xptxas -v) of each build this process made


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the flash kernels are built from source at first use")


def _library_path(name: str) -> Path:
    """Where ``name``'s library lives, keyed by the hash of its source, the
    shared headers and the flags (an edited source rebuilds)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named kernel source not built yet, one nvcc per source,
    all started together; return each library's path."""
    paths = {name: _library_path(name) for name in names}
    procs = {}
    for name, out in paths.items():
        if out.is_file():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        build_log[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {name}.cu:\n{build_log[name]}")
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def _library(name: str):
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build([name])[name]))
            fn = getattr(lib, name)
            fn.argtypes = ARGTYPES[name]
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernels take CUDA operands of this dtype and head dim, on
    metadata only: "" for the bf16 kernels (``HEAD_DIMS``), "_f32" for the
    float32 ones (``F32_HEAD_DIMS``), the suffix of their wrappers' names.
    Any other dtype or head dim raises: no kernel computes it, and a cast or
    a padded head dim would compute something other than the JAX package
    does."""
    dims = {torch.bfloat16: HEAD_DIMS, torch.float32: F32_HEAD_DIMS}.get(dtype)
    if dims is None:
        raise ValueError(f"no flash kernel takes {dtype}: bf16 or float32 only")
    if head_dim not in dims:
        raise ValueError(f"{dtype} head dim {head_dim} is not one of {dims}")
    return "" if dtype == torch.bfloat16 else "_f32"


def _aligned(t: torch.Tensor) -> bool:
    """Head dim contiguous, other strides and the base 16-byte aligned."""
    return t.stride(3) == 1 and not any(s * t.element_size() % 16 for s in t.stride()[:3]) and t.data_ptr() % 16 == 0


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *more: torch.Tensor,
           dtype: torch.dtype = torch.bfloat16) -> None:
    """A kernel's [B,H,L,D] operands (``more``: dO and the like, q's shape):
    all of ``dtype`` on one CUDA device, D one of the kernel's head dims, the
    head dim contiguous, the other strides and the base 16-byte aligned."""
    ts = (q, k, v, *more)
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{name}: every operand must be a CUDA tensor")
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{name}: every operand must be on one device")
    if not all(t.dtype == dtype for t in ts):
        kind = "bf16" if dtype == torch.bfloat16 else "float32"
        raise ValueError(f"{name}: {kind} only, got {[str(t.dtype) for t in ts]}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: expected [B,H,L,D], got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[1] != h or k.shape[3] != d:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree")
    if any(t.shape != q.shape for t in more):
        raise ValueError(f"{name}: dO {[tuple(t.shape) for t in more]} does not match q {tuple(q.shape)}")
    dims = HEAD_DIMS if dtype == torch.bfloat16 else F32_HEAD_DIMS
    if d not in dims:
        raise ValueError(f"{name}: {dtype} head dim {d} is not one of {dims}")
    for t in ts:
        if not _aligned(t):
            raise ValueError(f"{name}: strides and base must be 16-byte aligned with the head dim contiguous")


def _check_rows(name: str, q: torch.Tensor, *rows: torch.Tensor) -> None:
    for t in rows:
        if t.device != q.device or t.dtype != torch.float32 or t.shape != q.shape[:3] or not t.is_contiguous():
            raise ValueError(f"{name}: lse and delta must be contiguous float32 {tuple(q.shape[:3])} on {q.device}")


def _bhld(like: torch.Tensor, length: int) -> torch.Tensor:
    """An uninitialised [B,H,length,D] view of a [B,length,H,D] buffer."""
    b, h, _, d = like.shape
    return torch.empty((b, length, h, d), device=like.device, dtype=like.dtype).permute(0, 2, 1, 3)


def _strides(*ts: torch.Tensor):
    return (ctypes.c_longlong * (3 * len(ts)))(*[s for t in ts for s in t.stride()[:3]])


def _launch(name: str, q: torch.Tensor, *args) -> None:
    fn = getattr(_library(name), name)
    with torch.cuda.device(q.device):
        err = fn(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _requires_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


F32_MODES = {"online": 0, "nomax": 1, "lse": 2}  # flash_fwd_f32's modes


def _fwd_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None, mode: str):
    _check("flash_fwd_f32", q, k, v, dtype=torch.float32)
    b, h, lq, d = q.shape
    out = _bhld(q, lq)
    lse = torch.empty((b, h, lq), device=q.device, dtype=torch.float32) if mode == "lse" else None
    _launch("flash_fwd_f32", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            0 if lse is None else lse.data_ptr(), b, h, lq, k.shape[2], d, F32_MODES[mode],
            ctypes.cast(_strides(q, k, v, out), _P), _prescale(q, _scale(q, scale)))
    return out if lse is None else (out, lse)


def flash_fwd_online_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """K3 in float32: flash_fwd_f32's online mode on float32 CUDA [B,H,L,D]
    at a head dim of ``F32_HEAD_DIMS``. Its plain version is
    ``flash_fwd_online_plain`` at float32. ``flash_fwd_online_f32.launches``
    counts launches."""
    out = _fwd_f32(q, k, v, scale, "online")
    flash_fwd_online_f32.launches += 1
    return out


def flash_fwd_nomax_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """K1/K2 in float32: flash_fwd_f32's no-max mode. Its plain version is
    ``flash_attention_nomax_plain`` at float32. It overflows where the TPU
    kernels do, once a logit·log2e passes 128. ``flash_fwd_nomax_f32
    .launches`` counts launches."""
    out = _fwd_f32(q, k, v, scale, "nomax")
    flash_fwd_nomax_f32.launches += 1
    return out


def flash_fwd_lse_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None):
    """K4 in float32: flash_fwd_f32's lse mode, (o, lse [B,H,Lq] float32
    natural log). Its plain version is ``flash_fwd_lse_plain`` at float32.
    ``flash_fwd_lse_f32.launches`` counts launches."""
    out = _fwd_f32(q, k, v, scale, "lse")
    flash_fwd_lse_f32.launches += 1
    return out


def flash_fwd_nomax(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v without the running max. q [B,H,Lq,D], k/v
    [B,H,Lk,D] -> [B,H,Lq,D]. Forward only: it raises when grad mode is on
    and an input requires grad (use ``flash_attention``), since its output
    carries no gradient. Float32 CUDA tensors go to ``flash_fwd_nomax_f32``;
    ``flash_fwd_nomax.launches`` counts the bf16 kernel's launches."""
    if _requires_grad(q, k, v):
        raise RuntimeError("flash_fwd_nomax has no backward; under grad use flash_attention")
    if q.device.type == "cpu":
        return flash_attention_nomax_plain(q, k, v, scale)
    if variant(q.dtype, q.shape[-1]):
        return flash_fwd_nomax_f32(q, k, v, scale)
    _check("flash_fwd_nomax", q, k, v)
    b, h, lq, d = q.shape
    out = _bhld(q, lq)
    _launch("flash_fwd_nomax", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, lq, k.shape[2], d, ctypes.cast(_strides(q, k, v, out), _P), _prescale(q, _scale(q, scale)))
    flash_fwd_nomax.launches += 1
    return out


def flash_fwd_online(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """K3: softmax(q·kᵀ·scale)·v with the running max and no lse. q
    [B,H,Lq,D], k/v [B,H,Lk,D] -> [B,H,Lq,D]. Forward only, like
    ``flash_fwd_nomax``: it raises under grad. CPU tensors take
    ``flash_fwd_online_plain``, float32 CUDA tensors
    ``flash_fwd_online_f32``; ``flash_fwd_online.launches`` counts the bf16
    kernel's launches."""
    if _requires_grad(q, k, v):
        raise RuntimeError("flash_fwd_online has no backward; under grad use flash_attention")
    if q.device.type == "cpu":
        return flash_fwd_online_plain(q, k, v, scale)
    if variant(q.dtype, q.shape[-1]):
        return flash_fwd_online_f32(q, k, v, scale)
    _check("flash_fwd_online", q, k, v)
    b, h, lq, d = q.shape
    out = _bhld(q, lq)
    _launch("flash_fwd_online", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, lq, k.shape[2], d, ctypes.cast(_strides(q, k, v, out), _P), _prescale(q, _scale(q, scale)))
    flash_fwd_online.launches += 1
    return out


def flash_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None):
    """K4: (o [B,H,Lq,D], lse [B,H,Lq] float32 natural log). CPU tensors take
    ``flash_fwd_lse_plain``, float32 CUDA tensors ``flash_fwd_lse_f32``;
    ``flash_fwd_lse.launches`` counts the bf16 kernel's launches."""
    if q.device.type == "cpu":
        return flash_fwd_lse_plain(q, k, v, scale)
    if variant(q.dtype, q.shape[-1]):
        return flash_fwd_lse_f32(q, k, v, scale)
    _check("flash_fwd_lse", q, k, v)
    b, h, lq, d = q.shape
    out = _bhld(q, lq)
    lse = torch.empty((b, h, lq), device=q.device, dtype=torch.float32)
    _launch("flash_fwd_lse", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, h, lq, k.shape[2], d, ctypes.cast(_strides(q, k, v, out), _P), _prescale(q, _scale(q, scale)))
    flash_fwd_lse.launches += 1
    return out, lse


def _bwd_dq(name, q, k, v, g, o, lse, qs, scale, dtype):
    _check(name, q, k, v, g, o, qs, dtype=dtype)
    _check_rows(name, q, lse)
    b, h, lq, d = q.shape
    dq = _bhld(q, lq)
    delta = torch.empty((b, h, lq), device=q.device, dtype=torch.float32)
    _launch(name, q, qs.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), o.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, lq, k.shape[2], d,
            ctypes.cast(_strides(qs, k, v, g, o, dq), _P), _scale(q, scale))
    return dq, delta


def _bwd_dkv(name, q, k, v, g, lse, delta, qs, dtype):
    _check(name, q, k, v, g, qs, dtype=dtype)
    _check_rows(name, q, lse, delta)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    dk, dv = _bhld(k, lk), _bhld(v, lk)
    _launch(name, q, qs.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, lq, lk, d,
            ctypes.cast(_strides(qs, k, v, g, dk, dv), _P))
    return dk, dv


def flash_bwd_dq_f32(q, k, v, g, o, lse, qs, scale: float | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 in float32 (``csrc/flash_bwd_dq_f32.cu``): flash_bwd_dq's
    interface on float32 CUDA tensors at a head dim of ``F32_HEAD_DIMS``. Its
    plain versions are ``attention_delta`` and ``flash_bwd_dq_plain`` at
    float32. ``flash_bwd_dq_f32.launches`` counts launches."""
    out = _bwd_dq("flash_bwd_dq_f32", q, k, v, g, o, lse, qs, scale, torch.float32)
    flash_bwd_dq_f32.launches += 1
    return out


def flash_bwd_dkv_f32(q, k, v, g, lse, delta, qs, scale: float | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 in float32 (``csrc/flash_bwd_dkv_f32.cu``): flash_bwd_dkv's
    interface on float32 CUDA tensors. Its plain version is
    ``flash_bwd_dkv_plain`` at float32. ``flash_bwd_dkv_f32.launches``
    counts launches."""
    out = _bwd_dkv("flash_bwd_dkv_f32", q, k, v, g, lse, delta, qs, torch.float32)
    flash_bwd_dkv_f32.launches += 1
    return out


def flash_bwd_dq(q, k, v, g, o, lse, qs, scale: float | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: (dq [B,H,Lq,D], delta [B,H,Lq] float32) from dO ``g`` and the
    forward's ``o`` and ``lse``: the kernel forms delta = Σ dO·o of its rows
    itself (``attention_delta``'s arithmetic) and returns it for K6. It
    reads ``qs = prescaled_q(q, scale)`` in place of q. CPU tensors take
    ``attention_delta`` and ``flash_bwd_dq_plain``, which pre-scales q
    itself; float32 CUDA tensors ``flash_bwd_dq_f32``;
    ``flash_bwd_dq.launches`` counts the bf16 kernel's launches."""
    if q.device.type == "cpu":
        delta = attention_delta(g, o)
        return flash_bwd_dq_plain(q, k, v, g, lse, delta, scale), delta
    if variant(q.dtype, q.shape[-1]):
        return flash_bwd_dq_f32(q, k, v, g, o, lse, qs, scale)
    out = _bwd_dq("flash_bwd_dq", q, k, v, g, o, lse, qs, scale, torch.bfloat16)
    flash_bwd_dq.launches += 1
    return out


def flash_bwd_dkv(q, k, v, g, lse, delta, qs, scale: float | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: (dk, dv) [B,H,Lk,D] from dO ``g``, the forward's ``lse`` and
    ``delta``. The kernel reads ``qs = prescaled_q(q, scale)`` in place of
    q. CPU tensors take ``flash_bwd_dkv_plain``, which pre-scales q itself;
    float32 CUDA tensors ``flash_bwd_dkv_f32``; ``flash_bwd_dkv.launches``
    counts the bf16 kernel's launches."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, g, lse, delta, scale)
    if variant(q.dtype, q.shape[-1]):
        return flash_bwd_dkv_f32(q, k, v, g, lse, delta, qs, scale)
    out = _bwd_dkv("flash_bwd_dkv", q, k, v, g, lse, delta, qs, torch.bfloat16)
    flash_bwd_dkv.launches += 1
    return out


for _fn in (flash_fwd_nomax, flash_fwd_online, flash_fwd_lse, flash_bwd_dq, flash_bwd_dkv, flash_fwd_online_f32,
            flash_fwd_nomax_f32, flash_fwd_lse_f32, flash_bwd_dq_f32, flash_bwd_dkv_f32):
    _fn.launches = 0


class FlashAttention(torch.autograd.Function):
    """Counterpart of the JAX custom_vjp (flash_attention.py:438-446, :789):
    forward K4 saving (q, k, v, o, lse); backward the pre-scaled q (once,
    for both kernels, as ``_bwd_pallas`` does), then K5, which also forms
    delta, and K6."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_fwd_lse(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        if g.is_cuda and not _aligned(g):
            g = g.contiguous()
        qs = prescaled_q(q, ctx.scale)
        dq, delta = flash_bwd_dq(q, k, v, g, o, lse, qs, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, qs, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """Differentiable flash attention. q [B,H,Lq,D], k/v [B,H,Lk,D] ->
    [B,H,Lq,D]."""
    return FlashAttention.apply(q, k, v, scale)
