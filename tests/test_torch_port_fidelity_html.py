"""The port's copies of the fidelity oracles (utils/fidelity.py) and the HTML
report (typicality/make_html.py), held to the JAX package's on the same
inputs: numpy and file work on the host, so the results are equal (float
sums within rtol 1e-6), and the ``fidelity`` and ``html`` commands."""
import filecmp
import os

import numpy as np
import pytest
import torch
from PIL import Image

from diffmining_tpu.typicality import make_html as jhtml
from diffmining_tpu.utils import fidelity as jfid

from diffmining_tpu_torch.__main__ import main as port_cli
from diffmining_tpu_torch.typicality import make_html as phtml
from diffmining_tpu_torch.utils import fidelity as pfid

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_correlations_match_jax(seed):
    rng = np.random.RandomState(seed)
    a = rng.randn(50)
    b = a + rng.randn(50) * 0.5
    ties = rng.randint(0, 5, 40).astype(float)  # many ties: the average-rank branch
    ties_b = rng.randint(0, 5, 40).astype(float)
    for fn, args in (("pearson", (a, b)), ("spearman", (a, b)), ("spearman", (ties, ties_b)),
                     ("pearson", (np.ones(5), np.arange(5.0)))):
        np.testing.assert_allclose(getattr(pfid, fn)(*args), getattr(jfid, fn)(*args), rtol=1e-6)
    g1 = rng.randn(4, 2, 4, 6, 6).astype(np.float16)
    g2 = (g1 + rng.randn(*g1.shape) * 0.3).astype(np.float16)
    np.testing.assert_allclose(pfid.map_correlation(g1, g2), jfid.map_correlation(g1, g2), rtol=1e-6)
    boxes_a = {f"p{i}": float(v) for i, v in enumerate(rng.randn(12))}
    boxes_b = {f"p{i}": float(v) for i, v in enumerate(rng.randn(12)) if i % 3}
    boxes_b["only_b"] = 1.0
    assert pfid.patch_rank_correlation(boxes_a, boxes_b) == pytest.approx(
        jfid.patch_rank_correlation(boxes_a, boxes_b), rel=1e-6)
    assert pfid.patch_rank_correlation({"x": 1.0}, {"x": 2.0}) == jfid.patch_rank_correlation({"x": 1.0}, {"x": 2.0})


@pytest.fixture()
def typ_trees(tmp_path):
    rng = np.random.RandomState(0)
    for side in ("ours", "theirs"):
        for cat in ("1930", "1960"):
            os.makedirs(tmp_path / side / cat)
    for cat in ("1930", "1960"):
        for i in range(3):
            g = rng.randn(4, 2, 4, 6, 6).astype(np.float16)
            np.save(tmp_path / "ours" / cat / f"img{i}.npy", g)
            if i < 2:  # img2 only in ours
                np.save(tmp_path / "theirs" / cat / f"img{i}.npy",
                        (g + rng.randn(*g.shape) * 0.2).astype(np.float16))
    # another image scaling: skipped as not comparable
    np.save(tmp_path / "ours" / "1930" / "big.npy", rng.randn(4, 2, 4, 8, 8).astype(np.float16))
    np.save(tmp_path / "theirs" / "1930" / "big.npy", rng.randn(4, 2, 4, 6, 6).astype(np.float16))
    os.makedirs(tmp_path / "ours" / "only_ours")
    return str(tmp_path / "ours"), str(tmp_path / "theirs")


def test_compare_typicality_dirs_matches_jax(typ_trees):
    ours, theirs = typ_trees
    got, want = pfid.compare_typicality_dirs(ours, theirs), jfid.compare_typicality_dirs(ours, theirs)
    assert set(got) == set(want) and "1930/big.npy" not in got and len(got) == 5
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


def test_fidelity_cli_prints_what_jax_prints(typ_trees, capsys):
    ours, theirs = typ_trees
    jfid.main(["--ours", ours, "--theirs", theirs])
    want = capsys.readouterr().out
    port_cli(["fidelity", "--ours", ours, "--theirs", theirs])
    got = capsys.readouterr().out
    assert got == want and "mean map correlation" in got


def _figure_tree(figs):
    for mode in ("pt", "ft"):
        for trange in ("0.1-0.7", "0.3-0.9"):
            d = figs / mode / trange / "clusters"
            os.makedirs(d)
            for cat in ("United States", "Japan"):
                Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(d / f"{cat}__hard_limit_20_ranked.png")
                Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(d / f"{cat}__other.png")
    os.makedirs(figs / "pt" / "notes")
    (figs / "pt" / "notes" / "x.txt").write_text("not a figure")


def test_scan_figures_matches_jax(tmp_path):
    figs = tmp_path / "figures"
    _figure_tree(figs)
    got = phtml.scan_figures(str(figs))
    assert got == jhtml.scan_figures(str(figs))
    assert all(v.endswith("_ranked.png") for v in got.values()) and len(got) == 8


def test_html_cli_writes_what_jax_writes(tmp_path):
    figs = tmp_path / "figures"
    _figure_tree(figs)
    want = jhtml.generate_html(str(figs), str(tmp_path / "jax"))
    port_cli(["html", str(figs), str(tmp_path / "port"), "32"])
    got = str(tmp_path / "port" / "index.html")
    assert open(got).read() == open(want).read()
    cmp = filecmp.dircmp(str(tmp_path / "jax" / "figures"), str(tmp_path / "port" / "figures"))
    assert not cmp.left_only and not cmp.right_only and not cmp.diff_files
    with pytest.raises(SystemExit):
        port_cli(["html"])
