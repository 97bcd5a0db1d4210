"""Per-domain prompt templates — preserved exactly, quirks included (the
port's own copy of diffmining_tpu/typicality/templates.py).

Three distinct template sets exist in the reference and all are load-bearing
(SURVEY.md C8):

  1. training prompts (finetuning/cars.py:68-74 etc.) — live in finetuning/datasets.py
  2. typicality prompts (typicality/compute.py:41-48)
  3. DIFT prompts (typicality/cluster.py:233-241) — NOTE the reference swaps
     the cars/faces templates here (cars gets "Portrait at the {c}'s.");
     we replicate the swap for parity, flagged by `dift_swapped=True`.
"""
from __future__ import annotations

from typing import List, Sequence


def typicality_prompt(which: str, c: str) -> str:
    """Prompt used when embedding category c for the typicality sweep;
    c == "" is the null condition (reference compute.py:41-48)."""
    if which in ("faces", "ftt"):
        return f"Portrait at the {c}'s." if c else "Portrait."
    if which == "cars":
        return f"A car at the {c}'s." if c else "A car."
    if which == "places":
        return "Image of " + c.replace("_", " ") + "." if c else ""
    return f"{c}" if c else ""


def dift_prompt(which: str, c: str, swapped: bool = True) -> str:
    """Prompt for DIFT feature extraction (reference cluster.py:233-241).

    The reference's `Cluster.dift_prompt` swaps the cars/faces templates
    relative to the typicality set (cars -> portrait template). `swapped=True`
    reproduces that behavior; pass False for the 'fixed' variant.
    """
    if swapped:
        if which == "cars":
            return f"Portrait at the {c}'s." if c else "Portrait."
        if which in ("faces", "ftt"):
            return f"A car at the {c}'s." if c else "A car."
    else:
        if which == "cars":
            return f"A car at the {c}'s." if c else "A car."
        if which in ("faces", "ftt"):
            return f"Portrait at the {c}'s." if c else "Portrait."
    if which == "places":
        return "Image of " + c.replace("_", " ") + "." if c else ""
    return f"{c}" if c else ""


def typicality_prompts(which: str, categories: Sequence[str]) -> List[str]:
    return [typicality_prompt(which, c) for c in categories]


def get_decade(year) -> str:
    return str((int(year) // 10) * 10)
