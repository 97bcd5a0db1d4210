"""Patch scoring ops: box-average pooling, bilinear upsampling, the score
maps, non-overlap suppression, top-k and the figure filters (counterpart of
diffmining_tpu/ops/pool.py).

The map ops take and return tensors on the caller's device (the card, on
the mining path); suppression and top-k are host numpy, as in JAX, on
tiny inputs (the candidate boxes of one image). The suppression runs in
C++ (``native/boxops.cpp``, built at first use with g++), as the JAX
package's fast path does; ``get_non_overlapping_plain`` is the numpy loop,
its plain version.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from diffmining_tpu_torch.native.boxops import non_overlap_suppress


def _as_maps(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """[..., H, W] -> ([M, 1, H, W] float32, the leading shape)."""
    lead = tuple(x.shape[:-2])
    return x.float().reshape(-1, 1, *x.shape[-2:]), lead


def box_pool(x: torch.Tensor, kx: int, ky: int) -> torch.Tensor:
    """Stride-1 VALID average pooling over the last two dims, fp32:
    [..., H, W] -> [..., H-kx+1, W-ky+1] (the reference's AvgPool2d((kx,
    ky), stride=1), utils.py:74-80). Separable: the kx rows, then the ky
    columns."""
    if kx == 1 and ky == 1:
        return x
    m, lead = _as_maps(x)
    m = F.avg_pool2d(F.avg_pool2d(m, (kx, 1), stride=1), (1, ky), stride=1)
    return m.reshape(*lead, *m.shape[-2:])


def upsample_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of the last two dims to (h, w) in fp32, torch's
    ``align_corners=False`` (JAX: jax.image.resize "linear", which is the
    same for upsampling, the only use here)."""
    m, lead = _as_maps(x)
    m = F.interpolate(m, size=(h, w), mode="bilinear", align_corners=False)
    return m.reshape(*lead, h, w)


def typicality_map(loss_grid: torch.Tensor, h: int, w: int, kx: int = 64, ky: int = 64) -> torch.Tensor:
    """The patch-score map [h-kx+1, w-ky+1] fp32 of one image's loss grid
    [N, n_cond, C, hl, wl] (cond at index 0, null at 1): mean_n of
    box(L_null) - box(L_cond), the losses first averaged over the latent
    channels and upsampled to the image (reference cluster.py:125-137)."""
    dm = upsample_bilinear(loss_grid.float().mean(dim=2), h, w)  # [N, n_cond, h, w]
    pooled = box_pool(dm, kx, ky)
    return (pooled[:, 1] - pooled[:, 0]).mean(dim=0)


def pixel_typicality_map(loss_grid: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Per-pixel (unpooled) typicality [h, w]: mean_n of L_null - L_cond,
    upsampled (reference cluster.py:112-123, 512-528)."""
    dm = upsample_bilinear(loss_grid.float().mean(dim=2), h, w)
    return (dm[:, 1] - dm[:, 0]).mean(dim=0)


def get_non_overlapping(boxes: np.ndarray, scores: np.ndarray, k: int) -> np.ndarray:
    """Greedy suppression: pick the highest-score box, drop every box that
    intersects it, repeat (reference utils.py:94-102). boxes [M, 4] as
    (x_start, y_start, x_end, y_end); returns indices into boxes, at most k.
    Through the C++ host op, which ranks the scores as float32 as the JAX
    package's does."""
    return non_overlap_suppress(boxes, scores, k)


def get_non_overlapping_plain(boxes: np.ndarray, scores: np.ndarray, k: int) -> np.ndarray:
    """``get_non_overlapping``'s plain version, the numpy loop."""
    order = np.argsort(-scores, kind="stable")
    picked = []
    bx = boxes[order]
    alive = np.ones(len(order), dtype=bool)
    for i in range(len(order)):
        if not alive[i]:
            continue
        picked.append(order[i])
        if len(picked) >= k:
            break
        b = bx[i]
        overlap = (bx[:, 0] <= b[2]) & (bx[:, 2] >= b[0]) & (bx[:, 1] <= b[3]) & (bx[:, 3] >= b[1])
        alive &= ~overlap
    return np.asarray(picked, dtype=np.int64)


def top_patches(score_map: np.ndarray, kx: int, ky: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k non-overlapping kx×ky patches of a score map: (boxes [k, 4] as
    x_start, y_start, x_end, y_end with x the row, scores [k]). The same as
    sorting every (i, j) by score and suppressing greedily (reference
    cluster.py:192-204), on a capped candidate list with a full rerun when
    the cap runs out before k picks."""
    h, w = score_map.shape
    flat = score_map.ravel()
    order = np.argsort(-flat, kind="stable")
    # k picks can suppress at most k*(2kx-1)*(2ky-1) boxes
    cap = min(len(order), max(k * 8, 4096))
    cand = order[:cap]
    xs, ys = np.divmod(cand, w)
    boxes = np.stack([xs, ys, xs + kx, ys + ky], axis=1)
    idx = get_non_overlapping(boxes, flat[cand], k)
    if len(idx) < k and cap < len(order):
        xs, ys = np.divmod(order, w)
        boxes = np.stack([xs, ys, xs + kx, ys + ky], axis=1)
        idx = get_non_overlapping(boxes, flat[order], k)
        return boxes[idx], flat[order][idx]
    return boxes[idx], flat[cand][idx]


def filter_patch(arr: np.ndarray, black_threshold: float = 30, white_threshold: float = 225) -> bool:
    """Reject near-black and near-white patches (reference utils.py:104-109);
    arr is uint8 RGB or grayscale."""
    if arr.ndim == 3:
        gray = arr[..., 0] * 0.299 + arr[..., 1] * 0.587 + arr[..., 2] * 0.114
    else:
        gray = arr
    m = float(np.mean(gray))
    return black_threshold < m < white_threshold


def gauss_kernel_1d(sigma: float, ksize: int) -> np.ndarray:
    r = ksize // 2
    xs = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(xs**2) / (2 * sigma**2))
    return k / k.sum()


def _reflect_index(n: int, r: int, device) -> torch.Tensor:
    """Source indices of an axis of length n padded by r on each side in
    numpy's "reflect" mode (no edge repeat), for any r: pads wider than the
    axis keep reflecting, as jnp.pad does."""
    i = torch.arange(-r, n + r, device=device).abs()
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = i % period
    return torch.where(i > n - 1, period - i, i)


def gaussian_blur(dm: torch.Tensor, sigma: float = 32.0, ksize: int = 127) -> torch.Tensor:
    """Separable 2-D Gaussian blur of an [H, W] map in fp32 with reflect
    padding (scipy gaussian_filter(mode='reflect') without the edge
    repeat, as jnp.pad's "reflect"): along W, then along H."""
    r = ksize // 2
    k = torch.as_tensor(gauss_kernel_1d(sigma, ksize), dtype=torch.float32, device=dm.device)
    h, w = dm.shape
    x = dm.float()[_reflect_index(h, r, dm.device)][:, _reflect_index(w, r, dm.device)][None, None]
    x = F.conv2d(x, k.reshape(1, 1, 1, ksize))
    x = F.conv2d(x, k.reshape(1, 1, ksize, 1))
    return x[0, 0]
