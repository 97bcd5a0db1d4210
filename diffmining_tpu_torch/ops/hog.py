"""HOG(31) + LAB patch features in PyTorch (counterpart of
diffmining_tpu/ops/hog.py).

The features of the Doersch baseline: per 8-px grid position, [8·8·31
block-normalised HOG | 2·8·8 LAB] = 2112 dims, laid out as the JAX package
lays them out ([nx, ny, 2112] after its transpose), L2-normalised by the
caller. skimage's semantics, as the JAX package replicates them:

  * gradients: central differences with zeroed borders, the channel of
    largest magnitude per pixel (the first of equal ones, as both
    frameworks' argmax take it);
  * hard orientation binning over [0°, 180°): the bin is the truncation of
    atan2 in degrees (``torch.remainder``, as Python's and JAX's ``%``, for
    negative angles); a cell is the mean magnitude per bin over 8×8 pixels;
  * blocks of 8×8 cells, stride 1 cell, L2-Hys normalisation (clip 0.2);
  * LAB: the a/b channels of each 64×64 window resized to 8×8 by bilinear
    taps without antialias, gathered as the JAX package gathers them.

The work is elementwise passes and window sums over one image; it runs on
``device`` (the card unless the caller asks for the CPU) in float32. The
frameworks' atan2 may differ by an ulp, so a pixel whose angle lies on a bin
edge may vote into the neighbouring bin on one of them.
"""
from __future__ import annotations

import numpy as np
import torch

from diffmining_tpu_torch.utils.device import resolve_device

_RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)
_WHITE_D65 = (0.95047, 1.0, 1.08883)


def rgb2lab(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB [H,W,3] in [0,1] -> CIE Lab (D65), matching skimage.color.rgb2lab."""
    rgb = rgb.float()
    linear = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92)
    m = torch.tensor(_RGB2XYZ, dtype=torch.float32, device=rgb.device)
    xyz = torch.einsum("hwc,dc->hwd", linear, m)
    t = xyz / torch.tensor(_WHITE_D65, dtype=torch.float32, device=rgb.device)
    eps, kappa = 0.008856, 903.3
    f = torch.where(t > eps, t.clamp_min(0) ** (1.0 / 3.0), (kappa * t + 16.0) / 116.0)
    L = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return torch.stack([L, a, b], dim=-1)


def _channel_gradients(img: torch.Tensor):
    """skimage _hog_channel_gradient: central differences, zero borders."""
    g_row = torch.zeros_like(img)
    g_row[1:-1] = img[2:] - img[:-2]
    g_col = torch.zeros_like(img)
    g_col[:, 1:-1] = img[:, 2:] - img[:, :-2]
    return g_row, g_col


def orientation_bins(g_row: torch.Tensor, g_col: torch.Tensor, orientations: int = 31):
    """(angle in degrees in [0, 180), bin index) of each pixel's gradient."""
    deg = torch.remainder(torch.rad2deg(torch.atan2(g_row, g_col)), 180.0)
    bins = torch.clamp((deg / (180.0 / orientations)).to(torch.int32), 0, orientations - 1)
    return deg, bins


def dominant_gradients(img: torch.Tensor):
    """(g_row, g_col, magnitude) of the channel of largest magnitude per pixel."""
    g_row, g_col = _channel_gradients(img.float())
    mag = torch.sqrt(g_row**2 + g_col**2)
    idx = torch.argmax(mag, dim=-1, keepdim=True)
    pick = lambda t: torch.gather(t, -1, idx)[..., 0]  # noqa: E731
    return pick(g_row), pick(g_col), pick(mag)


def hog_features(img: torch.Tensor, orientations: int = 31, cell: int = 8, block: int = 8) -> torch.Tensor:
    """[H,W,3] float in [0,1] -> [nbx, nby, block*block*orientations]."""
    g_row, g_col, mag = dominant_gradients(img)
    _, bins = orientation_bins(g_row, g_col, orientations)
    votes = torch.nn.functional.one_hot(bins.long(), orientations).float() * mag[..., None]
    # cell histograms: the mean over cell x cell pixels ("valid" windows)
    nch, ncw = votes.shape[0] // cell, votes.shape[1] // cell
    cells = votes[: nch * cell, : ncw * cell].reshape(nch, cell, ncw, cell, orientations).sum(dim=(1, 3))
    cells = cells / (cell * cell)
    # blocks of block x block cells, stride 1, flattened [row, col, orientation]
    nbx, nby = nch - block + 1, ncw - block + 1
    blocks = torch.cat([cells[dr:dr + nbx, dc:dc + nby] for dr in range(block) for dc in range(block)], dim=-1)
    # L2-Hys
    eps = 1e-5
    norm = torch.sqrt(torch.sum(blocks**2, dim=-1, keepdim=True) + eps**2)
    v = torch.clamp(blocks / norm, max=0.2)
    norm2 = torch.sqrt(torch.sum(v**2, dim=-1, keepdim=True) + eps**2)
    return v / norm2


def lab_patch_features(img: torch.Tensor, patch: int = 64, stride: int = 8, out_size: int = 8) -> torch.Tensor:
    """a/b LAB channels of patch×patch windows resized to out_size², scaled
    (x+128)/255 -> [nx, ny, 2*out_size*out_size], channel-major."""
    lab = rgb2lab(img)[..., 1:3]  # [H, W, 2]
    H, W, _ = lab.shape
    nx, ny = (H - patch) // stride + 1, (W - patch) // stride + 1
    dev = lab.device
    # bilinear taps without antialias: output k samples (k + 0.5)·scale − 0.5
    pos = (torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) * (patch / out_size) - 0.5
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, patch - 1)
    hi = torch.clamp(lo + 1, 0, patch - 1)
    frac = torch.clamp(pos - lo, 0.0, 1.0)
    start_x = torch.arange(nx, device=dev)[:, None] * stride  # [nx, 1]
    start_y = torch.arange(ny, device=dev)[:, None] * stride
    rows = (lab[start_x + lo] * (1 - frac)[None, :, None, None]
            + lab[start_x + hi] * frac[None, :, None, None])  # [nx, out, W, 2]
    cols = (rows[:, :, start_y + lo] * (1 - frac)[None, None, None, :, None]
            + rows[:, :, start_y + hi] * frac[None, None, None, :, None])  # [nx, out, ny, out, 2]
    resized = cols.permute(0, 2, 4, 1, 3)  # [nx, ny, 2, out, out]
    return (resized.reshape(nx, ny, 2 * out_size * out_size) + 128.0) / 255.0


def hoglab_features(img: np.ndarray, device="cuda") -> np.ndarray:
    """The per-image feature map: [nx, ny, 2112] float32 numpy for the 8-px
    grid positions. img: [H,W,3] uint8 or float in [0,1]. The JAX package
    transposes to (x, y, C) as the reference caches it; so does this."""
    dev = resolve_device(device)
    arr = torch.as_tensor(np.asarray(img, np.float32), device=dev)
    if float(arr.max()) > 1.5:
        arr = arr / 255.0
    hog = hog_features(arr)
    lab = lab_patch_features(arr)
    nx, ny = min(hog.shape[0], lab.shape[0]), min(hog.shape[1], lab.shape[1])
    out = torch.cat([hog[:nx, :ny], lab[:nx, :ny]], dim=-1)
    return out.transpose(0, 1).contiguous().cpu().numpy()


def normalize_features(feats: np.ndarray) -> np.ndarray:
    """L2 per position."""
    n = np.linalg.norm(feats, axis=-1, keepdims=True)
    return feats / np.maximum(n, 1e-12)
