"""Image IO: the reference's per-domain rescale rules and array conversion
(counterpart of diffmining_tpu/utils/images.py).

cars short-side 256, places short-side 512, geo/ftt native, LANCZOS
(reference compute.py:165-180). PIL is imported inside the functions that
decode, so the sweep itself runs where Pillow is not installed when the
caller hands it decoded arrays (``array_from_uint8``).
"""
from __future__ import annotations

import binascii
import math
import os
from typing import Optional, Tuple

import numpy as np


def rescale_short_side(img, short: int, ceil_mode: bool = False):
    from PIL import Image

    w, h = img.size
    rnd = math.ceil if ceil_mode else int
    if w > h:
        return img.resize((rnd(w * (short / h)), short), Image.LANCZOS)
    return img.resize((short, rnd(h * (short / w))), Image.LANCZOS)


def rescale_for_domain(img, which: str, bucket_size: Optional[int] = None, native: bool = False):
    """Domain resize rules; `native=True` skips the domain downscale and
    `bucket_size` rounds each side down to a multiple."""
    from PIL import Image

    if not native:
        if which == "cars":
            img = rescale_short_side(img, 256)
        elif which == "places":
            img = rescale_short_side(img, 512, ceil_mode=True)
    if bucket_size:
        w, h = img.size
        bw = max((w // bucket_size) * bucket_size, min(w, bucket_size))
        bh = max((h // bucket_size) * bucket_size, min(h, bucket_size))
        if (bw, bh) != (w, h):
            img = img.resize((bw, bh), Image.LANCZOS)
    return img


def array_from_uint8(arr: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 RGB -> [H, W, 3] float32 in [-1, 1] (reference
    compute.py:128-131)."""
    return np.asarray(arr, dtype=np.float32) / 255.0 * 2.0 - 1.0


def load_image(
    path: str, which: str = "", bucket_size: Optional[int] = None, native: bool = False
) -> Tuple[np.ndarray, object]:
    """Decode, rescale for the domain, and convert; returns (array, PIL image)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    img = rescale_for_domain(img, which, bucket_size, native=native)
    return array_from_uint8(np.asarray(img)), img


def image_uid(path: str) -> int:
    """Stable per-image RNG uid from the basename (so recomputation and
    sharded workers agree); equal to diffmining_tpu's for every path."""
    return binascii.crc32(os.path.basename(path).encode("utf-8"))


def array_to_image(arr: np.ndarray):
    """[H, W, 3] in [-1, 1] -> PIL RGB (values clipped, rounded)."""
    from PIL import Image

    arr = np.clip((np.asarray(arr, dtype=np.float32) + 1.0) / 2.0, 0.0, 1.0)
    return Image.fromarray((arr * 255.0).round().astype(np.uint8))


def tensor_to_images(images) -> list:
    """A [B, 3, H, W] tensor in [-1, 1] (any device, any dtype) -> B PIL RGB
    images."""
    arr = images.detach().float().permute(0, 2, 3, 1).cpu().numpy()
    return [array_to_image(a) for a in arr]
