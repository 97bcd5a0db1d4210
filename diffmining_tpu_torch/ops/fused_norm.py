"""Fused GroupNorm → optional SiLU → 1x1 projection (counterpart of
diffmining_tpu/ops/fused_norm.py), the entry of every SpatialTransformer on
the inference paths when ``DIFFMINING_FUSED_NORM=1``.

  gn_act_proj         the wrapper: for a bf16 CUDA tensor one call of the
                      hand-written CUDA source ``csrc/gn_act_proj.cu``, which
                      launches two kernels, the per-(batch, group) statistics
                      (``gn_stats_kernel``) and the normalise + projection
                      (``gn_act_proj_kernel``, TPU ``_gn_act_matmul_kernel``,
                      K7); for a float32 CUDA tensor ``gn_act_proj_f32``;
                      for a CPU tensor ``gn_act_proj_plain``;
  gn_act_proj_f32     K7 in float32 (``csrc/gn_act_proj_f32.cu``, fp32 FMA
                      only): the same statistics in the same order, then a
                      normalise + projection on 8 x 8 register tiles fed by
                      a two-stage ring (small images split the channel sum
                      over a cluster of blocks); its plain version
                      is ``gn_act_proj_plain`` at float32 (every rounding to
                      w's and x's dtype a no-op);
  gn_kernel           which of the two a CUDA call runs, from the dtypes;
  group_stats_plain   the statistics kernel's arithmetic: its partial sums
                      and centred merges in its order;
  gn_act_proj_plain   the whole call's arithmetic step by step in PyTorch;
  gn_act_proj_tiled   the same on the projection kernel's tiling (``plan``):
                      h normalised once a block, Cout tiles, 64-channel
                      K chunks; the CPU tests hold it to the plain version;
  gn_act_proj_xla     the reference chain (fused_norm.py:107).

x is [B, H, W, C] as in JAX. The kernels read it in place in either layout
the UNet hands it: the NCHW activations viewed as NHWC
(``x.permute(0, 2, 3, 1)``, pixels contiguous) or channels-last ones (after
a transformer's proj_out, channels contiguous); the call writes [B, H, W,
Cout] contiguous, so the transformer's [B, L, C] input needs no copy.
Forward only, as in JAX (:60-62): the wrapper raises under grad.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from diffmining_tpu_torch.ops.flash_attention import _launch, _requires_grad

ACTS = ("none", "silu")
K_TILE = 64  # input channels a stage of w (the projection's K chunk): one 128-byte swizzle row
TILE_N = 160  # output channels a tile of the projection (SD's widths 320, 640 and 1280 are multiples)
STATS_THREADS = 512  # threads of a statistics block, one block per (batch, group)
STATS_VEC = 8  # elements in a run of the statistics kernel
STATS_UNROLL = 4  # runs a statistics thread loads at once and merges as one
SMEM_LIMIT = 232448  # dynamic shared memory a block may use on an H100
MAX_CHUNKS = 32  # K chunks of a slab (one barrier each)
MAX_STAGES = 6  # stages in the ring at most


class Plan(NamedTuple):
    """The projection kernel's tiling: ``bm`` pixels a block (two
    warpgroups: 64 pixel rows each at 128, each half of a Cout tile at 64),
    each block ``Cout / TILE_N / splits`` consecutive Cout tiles, ``stages``
    stages in its ring; ``ring``: the block streams x through the ring
    beside w, 64 channels a stage, instead of keeping a normalised [bm, C]
    slab."""
    bm: int
    splits: int
    stages: int
    ring: bool = False


def smem_bytes(c: int, bm: int, stages: int, ring: bool = False) -> int:
    """Dynamic shared memory of a projection block: 1024 bytes of alignment
    slack, the slab [bm, C] bf16 (none with ``ring``), the per-channel
    (mean, rsig, gamma, beta) fp32, the ring (a stage: w [TILE_N, 64], and
    x [bm, 64] with ``ring``, bf16), a barrier per slab chunk and two per
    stage."""
    slab = 0 if ring else bm * c * 2
    return 1024 + slab + c * 16 + stages * (TILE_N + (bm if ring else 0)) * K_TILE * 2 + 8 * MAX_CHUNKS + 16 * stages


def plan(b: int, n: int, c: int, cout: int, sms: int = 132) -> Plan:
    """Tiling of one call on a card with ``sms`` SMs. Where a slab of 128
    pixels x C fits beside a ring of two or more w stages (C=320, 640), a
    block normalises its slab once and covers ``Cout / splits`` of the
    output with it; the split is the divisor of the Cout tiles that
    minimises waves x (tiles a block + 1), the 1 standing for the slab's
    load and normalise: one block covers all of Cout at the large levels,
    and the small ones split Cout to fill the card. Where it does not fit
    (C=1280: a slab of 128 pixels would take 320 KB), each block covers one
    Cout tile and streams x through the ring beside w, normalising each
    64-channel chunk as it lands: 128 pixels a block, 64 where an image has
    no more."""
    tiles = cout // TILE_N

    def stages_at(bm, ring):
        per = (TILE_N + (bm if ring else 0)) * K_TILE * 2 + 16
        return min(MAX_STAGES, (SMEM_LIMIT - smem_bytes(c, bm, 0, ring)) // per)

    if c // K_TILE <= MAX_CHUNKS and stages_at(128, False) >= 2:
        bm, stages = 128, stages_at(128, False)
    else:
        bm = 128 if n > 64 else 64
        stages = stages_at(bm, True)
        if stages < 2:
            raise ValueError(f"gn_act_proj: C={c} leaves no room for a ring of stages in shared memory")
        return Plan(bm, tiles, stages, True)
    pixel_tiles = -(-n // bm)

    def cost(s):
        return -(-(pixel_tiles * b * s) // sms) * (tiles // s + 1)

    splits = min((s for s in range(1, tiles + 1) if tiles % s == 0), key=lambda s: (cost(s), s))
    return Plan(bm, splits, stages)


def _channels_contiguous(x: torch.Tensor) -> bool:
    """The layout the kernels take x in: channels contiguous (channels-last)
    unless the pixels are (NCHW viewed as NHWC)."""
    return not (x.stride(2) == 1 and x.stride(3) != 1)


def _pairwise8(v: torch.Tensor) -> torch.Tensor:
    """((v0 + v1) + (v2 + v3)) + ((v4 + v5) + (v6 + v7)) over the last axis of 8."""
    a = v[..., 0::2] + v[..., 1::2]
    a = a[..., 0::2] + a[..., 1::2]
    return a[..., 0] + a[..., 1]


def _chan_merge(na, ma, qa, nb, mb, qb):
    """Chan's merge of two (count, mean, sum of squared deviations) partials,
    each step rounded in fp32 as the kernel's; an empty side gives the other."""
    n = na + nb
    d = mb - ma
    f = nb / torch.where(n == 0, torch.ones_like(n), n)
    m = ma + d * f
    q = (qa + qb) + (d * d) * (na * f)
    m = torch.where(nb == 0, ma, torch.where(na == 0, mb, m))
    q = torch.where(nb == 0, qa, torch.where(na == 0, qb, q))
    return n, m, q


def _tree(n, m, q, width: int):
    """The kernel's shuffle-down tree over the last axis (``width`` a power
    of two): slot i merges slot i + o for o = width/2, ..., 1; slot 0 holds
    the result."""
    o = width // 2
    while o >= 1:
        lo = (slice(None),) * (n.ndim - 1) + (slice(0, o),)
        hi = (slice(None),) * (n.ndim - 1) + (slice(o, 2 * o),)
        n2, m2, q2 = _chan_merge(n[lo], m[lo], q[lo], n[hi], m[hi], q[hi])
        n, m, q = n.clone(), m.clone(), q.clone()
        n[lo], m[lo], q[lo] = n2, m2, q2
        o //= 2
    return n[..., 0], m[..., 0], q[..., 0]


def group_stats_plain(x: torch.Tensor, groups: int, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, rsigma) [B, C] float32 of x [B, H, W, C]: each
    (batch, group)'s fp32 mean and population variance, 1 / sqrt(var +
    eps), over the group's channels; the statistics kernel's arithmetic in
    its order. A group's elements, in memory order (channel by channel for
    NCHW x, pixel by pixel for channels-last x), are cut into runs of 8;
    thread t of the group's STATS_THREADS loads runs t, t + 512, t + 1024
    and t + 1536 at once, takes their count, mean and sum of squared
    deviations from that mean (pairwise sums), and merges them into its
    partial by Chan's centred merge; then the next four, 2048 runs on; then
    the threads merge down a tree (within each warp, then across the 16
    warps). No E[x^2] - E[x]^2 anywhere, so a
    mean large against the spread costs no digits (fused_norm.py:69-71
    takes the mean of squared deviations)."""
    b, hh, ww, c = x.shape
    n, cg = hh * ww, c // groups
    xf = x.reshape(b, n, c).float()
    if _channels_contiguous(x):
        xg = xf.reshape(b, n, groups, cg).permute(0, 2, 1, 3).reshape(b, groups, n * cg)
    else:
        xg = xf.permute(0, 2, 1).reshape(b, groups, cg * n)
    m_all = n * cg
    per_it = STATS_UNROLL * STATS_THREADS * STATS_VEC
    its = -(-m_all // per_it)
    total = its * per_it
    shape = (its, STATS_UNROLL, STATS_THREADS, STATS_VEC)
    valid = (torch.arange(total, device=x.device) < m_all).reshape(shape)
    v = torch.nn.functional.pad(xg, (0, total - m_all)).reshape(b, groups, *shape)

    def four(r):  # (r0 + r1) + (r2 + r3) over the STATS_UNROLL runs of a load
        return (r[:, :, :, 0] + r[:, :, :, 1]) + (r[:, :, :, 2] + r[:, :, :, 3])

    cnt = valid.sum(-1).float()
    cnt = ((cnt[:, 0] + cnt[:, 1]) + (cnt[:, 2] + cnt[:, 3])).expand(b, groups, its, STATS_THREADS)
    mean = four(_pairwise8(v)) / torch.where(cnt == 0, torch.ones_like(cnt), cnt)
    d = torch.where(valid, v - mean[:, :, :, None, :, None], torch.zeros_like(v))
    q = four(_pairwise8(d * d))
    tn, tm, tq = cnt[:, :, 0], mean[:, :, 0], q[:, :, 0]
    for it in range(1, its):  # each thread's loads in turn
        tn, tm, tq = _chan_merge(tn, tm, tq, cnt[:, :, it], mean[:, :, it], q[:, :, it])
    warps = STATS_THREADS // 32
    tn, tm, tq = (t.reshape(b, groups, warps, 32) for t in (tn, tm, tq))
    tn, tm, tq = _tree(tn, tm, tq, 32)  # within each warp
    gn, gm, gq = _tree(tn, tm, tq, warps)  # across the warps
    var = gq / gn
    rsig = 1.0 / torch.sqrt(var + eps)

    def per_channel(s):  # [B, G] -> [B, C], each group's value over its channels
        return s[:, :, None].expand(b, groups, cg).reshape(b, c)

    return per_channel(gm), per_channel(rsig)


def _normalise(x, mean, rsig, gamma, beta, act):
    """h = ((x - mean)·rsig)·γ + β in fp32, then h·sigmoid(h) for act="silu"."""
    h = (x.float() - mean) * rsig * gamma.float() + beta.float()
    return h * torch.sigmoid(h) if act == "silu" else h


def gn_act_proj_plain(x, gamma, beta, w, bias, groups: int, eps: float = 1e-6, act: str = "none") -> torch.Tensor:
    """K7's arithmetic (fused_norm.py:30-41, :103): the group statistics as
    ``group_stats_plain``, h = ((x - mean)·rsig)·γ + β in fp32, then
    h·sigmoid(h) for act="silu", h rounded to w's dtype, the product
    accumulated in fp32 and cast to x's dtype, the bias added in that dtype.
    x [B, H, W, C], w [C, Cout] -> [B, H, W, Cout]."""
    mean, rsig = group_stats_plain(x, groups, eps)
    h = _normalise(x, mean[:, None, None], rsig[:, None, None], gamma, beta, act)
    out = torch.matmul(h.to(w.dtype).float(), w.float()).to(x.dtype)
    return out + bias.to(out.dtype)


def gn_act_proj_tiled(x, gamma, beta, w, bias, groups: int, eps: float = 1e-6, act: str = "none",
                      tiling: Optional[Plan] = None, skip_tile: Optional[int] = None) -> torch.Tensor:
    """``gn_act_proj_plain`` on the projection kernel's tiling: the grid of
    pixel tiles x Cout splits x B that ``plan`` gives; each block normalises
    its [pixels, C] slab once to bf16 h and covers its Cout tiles with it,
    each tile's fp32 sum taken over 64-channel K chunks in turn from the
    block's own first chunk (its linear index in the grid modulo C / 64),
    rounded to x's dtype, the bias added in that dtype. ``skip_tile`` leaves that Cout
    tile of every block unwritten (zeros): a fault for the tests' bound."""
    b, hh, ww, c = x.shape
    n, cout = hh * ww, w.shape[1]
    p = tiling or plan(b, n, c, cout)
    mean, rsig = group_stats_plain(x, groups, eps)
    xf = x.reshape(b, n, c)
    out = torch.zeros(b, n, cout, dtype=x.dtype, device=x.device)
    per_block = cout // TILE_N // p.splits
    kch, pixel_tiles = c // K_TILE, -(-n // p.bm)
    for bi in range(b):
        for px in range(pixel_tiles):
            rows = slice(px * p.bm, min((px + 1) * p.bm, n))
            for split in range(p.splits):
                rot = (px + pixel_tiles * (split + p.splits * bi)) % kch  # the block's first K chunk
                h = _normalise(xf[bi, rows], mean[bi], rsig[bi], gamma, beta, act).to(w.dtype).float()  # once a block
                for t in range(split * per_block, (split + 1) * per_block):
                    if t == skip_tile:
                        continue
                    cols = slice(t * TILE_N, (t + 1) * TILE_N)
                    acc = torch.zeros(h.shape[0], TILE_N, dtype=torch.float32, device=x.device)
                    for i in range(kch):
                        k0 = (i + rot) % kch * K_TILE
                        acc = acc + h[:, k0:k0 + K_TILE] @ w[k0:k0 + K_TILE, cols].float()
                    out[bi, rows, cols] = acc.to(x.dtype) + bias[cols].to(x.dtype)
    return out.reshape(b, hh, ww, cout)


def gn_act_proj_xla(x, gamma, beta, w, bias, groups: int, eps: float = 1e-6, act: str = "none") -> torch.Tensor:
    """The reference chain (fused_norm.py:107-118): GroupNorm in fp32, γ/β,
    optional SiLU, cast to x's dtype, then the projection and bias in x's
    dtype. x [B, H, W, C] -> [B, H·W, Cout]."""
    b, hh, ww, c = x.shape
    xf = x.float().reshape(b, hh * ww, groups, c // groups)
    var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, correction=0)
    h = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, hh, ww, c)
    h = h * gamma.float() + beta.float()
    if act == "silu":
        h = h * torch.sigmoid(h)
    h = h.to(x.dtype)
    return torch.matmul(h.reshape(b, hh * ww, c), w) + bias[None, None]


F32_K_CHUNK = 16  # input channels a chunk of the float32 projection (KC in csrc/gn_act_proj_f32.cu)
F32_TILE_N = 160  # output channels a block of the float32 projection (BN in csrc/gn_act_proj_f32.cu)


def gn_kernel(x_dtype: torch.dtype, w_dtype: torch.dtype) -> str:
    """The wrapper whose kernel a CUDA call runs, on metadata only: bf16 x
    and w take ``gn_act_proj``'s bf16 kernels, float32 x and w
    ``gn_act_proj_f32`` (the JAX kernel computes in x's and w's dtypes); any
    other pair raises."""
    kernels = {torch.bfloat16: "gn_act_proj", torch.float32: "gn_act_proj_f32"}
    if x_dtype != w_dtype or x_dtype not in kernels:
        raise ValueError(f"gn_act_proj: x and w both bf16 or both float32, got {x_dtype}, {w_dtype}")
    return kernels[x_dtype]


def _check(x, gamma, beta, w, bias, groups: int, kernel: str = "gn_act_proj") -> None:
    """``kernel``'s operands: CUDA tensors on one device, x and w of its
    dtype, C and Cout multiples of its tiles."""
    ts = (x, gamma, beta, w, bias)
    if not all(t.is_cuda for t in ts) or len({t.device for t in ts}) != 1:
        raise ValueError("gn_act_proj: every operand must be a CUDA tensor on one device")
    if gn_kernel(x.dtype, w.dtype) != kernel:
        raise ValueError(f"{kernel}: x and w of {x.dtype} go to {gn_kernel(x.dtype, w.dtype)}")
    k_chunk, tile_n = (K_TILE, TILE_N) if kernel == "gn_act_proj" else (F32_K_CHUNK, F32_TILE_N)
    b, hh, ww, c = x.shape
    if w.ndim != 2 or w.shape[0] != c or gamma.shape != (c,) or beta.shape != (c,) or bias.shape != (w.shape[1],):
        raise ValueError(f"gn_act_proj: x {tuple(x.shape)}, w {tuple(w.shape)}, gamma/beta/bias do not agree")
    if c % groups or c % k_chunk or w.shape[1] % tile_n:
        raise ValueError(f"gn_act_proj: C={c} must divide into {groups} groups and be a multiple of {k_chunk}, "
                         f"Cout={w.shape[1]} a multiple of {tile_n}")


def kernel_strides(x: torch.Tensor) -> Tuple[int, int, int]:
    """(batch, pixel, channel) element strides of x [B, H, W, C] for the
    kernels, which take the H·W pixels as one axis and either the pixels
    (NCHW viewed as NHWC) or the channels (channels-last) contiguous."""
    _, hh, ww, _ = x.shape
    sn, sc = x.stride(2), x.stride(3)
    if (hh > 1 and x.stride(1) != ww * sn) or (sn != 1 and sc != 1):
        raise ValueError(f"gn_act_proj: strides {x.stride()} of x {tuple(x.shape)}: the kernel takes an NCHW or a "
                         "channels-last tensor viewed as NHWC")
    return x.stride(0), sn, sc


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _param(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """gamma or beta as the kernels read it: bf16 or float32, contiguous;
    (tensor, 1 if float32)."""
    if t.dtype not in (torch.bfloat16, torch.float32):
        t = t.float()
    return t.contiguous(), int(t.dtype == torch.float32)


def _stats_buffer(x: torch.Tensor, stats: Optional[torch.Tensor]) -> torch.Tensor:
    b, c = x.shape[0], x.shape[3]
    if stats is None:
        return torch.empty((b, 2, c), device=x.device, dtype=torch.float32)
    if stats.shape != (b, 2, c) or stats.dtype != torch.float32 or not stats.is_contiguous() or \
            stats.device != x.device:
        raise ValueError(f"gn_act_proj: stats must be a contiguous float32 {(b, 2, c)} tensor on {x.device}")
    return stats


def gn_act_proj_f32(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    groups: int, eps: float = 1e-6, act: str = "none",
                    stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7 in float32 on float32 CUDA x [B, H, W, C] (either layout
    ``kernel_strides`` takes) and w [C, Cout]: one call of
    ``csrc/gn_act_proj_f32.cu`` (the statistics kernel, then the normalise
    + projection kernel) -> [B, H, W, Cout] float32. C must be a multiple of
    16, Cout of 160. ``stats`` as for ``gn_act_proj``;
    ``gn_act_proj_f32.launches`` counts the calls."""
    if act not in ACTS:
        raise ValueError(f"act={act!r}: expected one of {ACTS}")
    _check(x, gamma, beta, w, bias, groups, "gn_act_proj_f32")
    sb, sn, sc = kernel_strides(x)
    b, hh, ww, c = x.shape
    cout = w.shape[1]
    stats = _stats_buffer(x, stats)
    gamma_k, beta_k, bias_k = (t.float().contiguous() for t in (gamma, beta, bias))
    wt = w.t().contiguous()  # [Cout, C]: the conv weight's own layout, so no copy in the UNet
    out = torch.empty((b, hh, ww, cout), device=x.device, dtype=torch.float32)
    _launch("gn_act_proj_f32", x, x.data_ptr(), stats.data_ptr(), gamma_k.data_ptr(), beta_k.data_ptr(),
            wt.data_ptr(), bias_k.data_ptr(), out.data_ptr(), b, hh * ww, c, cout, groups, ctypes.c_float(eps),
            sb, sn, sc, int(act == "silu"))
    gn_act_proj_f32.launches += 1
    return out


def gn_act_proj(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                groups: int, eps: float = 1e-6, act: str = "none",
                stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm(groups, eps) → optional SiLU → 1x1 projection. x [B, H, W,
    C], gamma/beta [C], w [C, Cout], bias [Cout] -> [B, H, W, Cout] in x's
    dtype. CPU tensors take ``gn_act_proj_plain``; float32 CUDA tensors
    ``gn_act_proj_f32``; a bf16 CUDA call launches the statistics kernel and
    the projection kernel, and ``gn_act_proj.launches`` counts the calls.
    ``stats``, a contiguous float32 [B, 2, C] CUDA tensor, receives the
    per-channel (mean, rsigma) the statistics kernel wrote (for checks)."""
    if act not in ACTS:
        raise ValueError(f"act={act!r}: expected one of {ACTS}")
    if _requires_grad(x, gamma, beta, w, bias):
        raise RuntimeError("gn_act_proj has no backward (forward only, as in JAX); train with fused_norm off")
    if x.device.type == "cpu":
        return gn_act_proj_plain(x, gamma, beta, w, bias, groups, eps, act)
    if gn_kernel(x.dtype, w.dtype) == "gn_act_proj_f32":
        return gn_act_proj_f32(x, gamma, beta, w, bias, groups, eps, act, stats)
    _check(x, gamma, beta, w, bias, groups)
    sb, sn, sc = kernel_strides(x)
    b, hh, ww, c = x.shape
    cout = w.shape[1]
    p = plan(b, hh * ww, c, cout, _sm_count(x.device.index if x.device.index is not None else torch.cuda.current_device()))
    stats = _stats_buffer(x, stats)
    (gamma_k, gamma_f32), (beta_k, beta_f32) = _param(gamma), _param(beta)
    if gamma_f32 != beta_f32:
        gamma_k, beta_k, gamma_f32 = gamma_k.float(), beta_k.float(), 1
    wt = w.t().contiguous()  # [Cout, C]: the conv weight's own layout, so no copy in the UNet
    bias_x = bias.to(x.dtype).contiguous()
    out = torch.empty((b, hh, ww, cout), device=x.device, dtype=x.dtype)
    flags = int(act == "silu") | gamma_f32 << 1
    _launch("gn_act_proj", x, x.data_ptr(), stats.data_ptr(), gamma_k.data_ptr(), beta_k.data_ptr(),
            wt.data_ptr(), bias_x.data_ptr(), out.data_ptr(), b, hh * ww, c, cout, groups, ctypes.c_float(eps),
            sb, sn, sc, flags, p.bm, p.splits, p.stages, int(p.ring))
    gn_act_proj.launches += 1
    return out


gn_act_proj.launches = 0
gn_act_proj_f32.launches = 0
