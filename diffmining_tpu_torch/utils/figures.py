"""PIL figure and grid helpers (counterpart of
diffmining_tpu/utils/figures.py; reference diffmining/typicality/utils.py:
21-72, 111-120, 255-277): pure visualisation, no kernel work."""
from __future__ import annotations

from typing import List, Optional, Sequence

from PIL import Image, ImageColor


def hcat(pils: Sequence[Image.Image]) -> Image.Image:
    height = pils[0].height
    total = sum(p.width for p in pils)
    out = Image.new(pils[0].mode, (total, height))
    x = 0
    for p in pils:
        out.paste(p, (x, 0))
        x += p.width
    return out


def vcat(pils: Sequence[Image.Image], vertical_spacing: int = 0) -> Image.Image:
    # max, not pils[0].width: rows wider than the first must not be clipped
    width = max(p.width for p in pils)
    total = sum(p.height for p in pils) + vertical_spacing * (len(pils) - 1)
    out = Image.new(pils[0].mode, (width, total))
    y = 0
    for i, p in enumerate(pils):
        out.paste(p, (0, y))
        y += p.height + (vertical_spacing if i < len(pils) - 1 else 0)
    return out


def hcat_margin(pils: Sequence[Image.Image], margin: int = 2) -> Image.Image:
    total = sum(p.width for p in pils) + margin * (len(pils) - 1)
    out = Image.new("RGB", (total, max(p.height for p in pils)))
    x = 0
    for p in pils:
        out.paste(p, (x, 0))
        x += p.width + margin
    return out


def add_border(pil: Image.Image, color, border: int = 1) -> Image.Image:
    pil = pil.convert("RGBA")
    if color == "transparent":
        color = (0, 0, 0, 0)
    elif isinstance(color, str):
        color = ImageColor.getrgb(color) + (255,)
    w, h = pil.size
    out = Image.new(pil.mode, (w + 2 * border, h + 2 * border), color)
    out.paste(pil, (border, border))
    return out


def make_grid(
    images: List[List[Image.Image]], horizontal_spacing: int = 2, vertical_spacing: int = 4
) -> Optional[Image.Image]:
    if not images:
        return None
    iw, ih = images[0][0].size
    cols = max(len(r) for r in images)
    gw = iw * cols + horizontal_spacing * (cols - 1)
    gh = ih * len(images) + vertical_spacing * (len(images) - 1)
    grid = Image.new("RGB", (gw, gh), (255, 255, 255))
    for r, row in enumerate(images):
        for c, img in enumerate(row):
            grid.paste(img, (c * (iw + horizontal_spacing), r * (ih + vertical_spacing)))
    return grid

