"""Fidelity oracles: compare typicality artifacts / patch rankings between two
runs (ours vs the reference's, or two of ours). The port's own copy of
diffmining_tpu/utils/fidelity.py: numpy only, it runs on the host.

This is the measurement half of BASELINE.md's fidelity target ("cluster rank
correlation >0.95 vs reference"). The reference ships no artifacts, so the
harness is exercised on self-comparisons and seed-stability tests; pointed
at a reference `.npy` tree it computes the real number:

    python -m diffmining_tpu_torch fidelity --ours typ_ours/ --theirs typ_ref/
"""
from __future__ import annotations

import argparse
import os
from os.path import join
from typing import Dict, Sequence, Tuple

import numpy as np


def pearson(a: np.ndarray, b: np.ndarray) -> float:
    a = a.ravel().astype(np.float64)
    b = b.ravel().astype(np.float64)
    a = a - a.mean()
    b = b - b.mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / denom) if denom > 0 else 0.0


def spearman(a: Sequence[float], b: Sequence[float]) -> float:
    """Spearman rank correlation (average ranks for ties)."""
    def ranks(x):
        x = np.asarray(x, np.float64)
        order = np.argsort(x, kind="stable")
        r = np.empty(len(x), np.float64)
        r[order] = np.arange(len(x), dtype=np.float64)
        # average tied ranks
        vals, inv, counts = np.unique(x, return_inverse=True, return_counts=True)
        sums = np.zeros(len(vals))
        np.add.at(sums, inv, r)
        return sums[inv] / counts[inv]

    return pearson(ranks(a), ranks(b))


def map_correlation(grid_a: np.ndarray, grid_b: np.ndarray) -> float:
    """Correlation of per-pixel typicality maps computed from two reference-
    layout loss grids [N, 2, C, h, w] (null − cond, averaged over draws)."""
    def pixel_map(g):
        g = g.astype(np.float32).mean(axis=2)  # channel mean
        return (g[:, 1] - g[:, 0]).mean(axis=0)

    return pearson(pixel_map(grid_a), pixel_map(grid_b))


def patch_rank_correlation(
    boxes_a: Dict[str, float], boxes_b: Dict[str, float]
) -> Tuple[float, int]:
    """Spearman over the D-scores of patches present in both runs; patches are
    keyed by 'path_x0-y0-x1-y1'. Returns (rho, n_shared)."""
    shared = sorted(set(boxes_a) & set(boxes_b))
    if len(shared) < 2:
        return 0.0, len(shared)
    return spearman([boxes_a[k] for k in shared], [boxes_b[k] for k in shared]), len(shared)


def compare_typicality_dirs(ours: str, theirs: str) -> Dict[str, float]:
    """Per-image map correlations for every .npy present in both trees
    (category subdirs), plus the aggregate."""
    out: Dict[str, float] = {}
    for cat in sorted(os.listdir(ours)):
        a_dir, b_dir = join(ours, cat), join(theirs, cat)
        if not (os.path.isdir(a_dir) and os.path.isdir(b_dir)):
            continue
        for name in sorted(os.listdir(a_dir)):
            if not name.endswith(".npy") or not os.path.isfile(join(b_dir, name)):
                continue
            a = np.load(join(a_dir, name))
            b = np.load(join(b_dir, name))
            if a.shape[2:] != b.shape[2:]:
                continue  # different image scaling — not comparable
            out[f"{cat}/{name}"] = map_correlation(a, b)
    if out:
        out["__mean__"] = float(np.mean([v for k, v in out.items() if not k.startswith("__")]))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="compare typicality artifact trees")
    ap.add_argument("--ours", required=True)
    ap.add_argument("--theirs", required=True)
    args = ap.parse_args(argv)
    res = compare_typicality_dirs(args.ours, args.theirs)
    for k, v in sorted(res.items()):
        print(f"{v:+.4f}  {k}")
    if "__mean__" in res:
        print(f"mean map correlation: {res['__mean__']:.4f}")


if __name__ == "__main__":
    main()
