"""The port's Doersch baseline (baselines/doersch.py) held to the JAX
package's on the CPU, on the mini dataset of tests/test_doersch.py (two
decades of three 128 px images).

Exact: ``iou``, the contrast gate, the cached splits, ``init_patches``,
``random_sample`` and the fold masks; the feature caches are interchangeable
both ways (each package reads the other's .npy files and .safetensors
shards to the same arrays, and shards built from one cache are byte for
byte the same file); the LAB part of the two packages' caches agrees to an
fp16 ulp (rtol 2^-10). The dense search reads the same shards in both
packages: scores at rtol 1e-5, atol 1e-6 (float32 products summed in
another order), and the (bbox, path) of each hit equal wherever its score
is clear of its neighbours in the list by more than that tolerance (heap
order may swap for scores within rounding of each other). The mini end to
end runs, on both SVM paths, start from one hog cache (the HOG of 8-bit
images may bin a pixel on a bin edge or a channel tie differently in the two
frameworks, tests/test_torch_port_hog.py) and agree on every detector's
accuracy, its hits (as above) and its weights at rtol 1e-4, atol 1e-5 (the
SVM's bound, tests/test_torch_port_svm.py).
"""
import os
import pickle
import shutil
from os.path import join

import numpy as np
import pytest
import torch
from PIL import Image
from safetensors.numpy import load_file

from diffmining_tpu.baselines import doersch as jd

from diffmining_tpu_torch.__main__ import main as port_main
from diffmining_tpu_torch.baselines import doersch as pd

torch.set_num_threads(1)
SCORE_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def mini_dataset(tmp_path_factory):
    """Two 'decades' with visually distinct patterns, ftt layout (the JAX
    package's test fixture)."""
    root = tmp_path_factory.mktemp("doersch_data")
    rng = np.random.RandomState(0)
    for dec, base in [("1930", 40), ("1990", 200)]:
        os.makedirs(join(root, dec))
        for i in range(3):
            arr = rng.randint(0, 55, (128, 128, 3)).astype(np.uint8) + base
            Image.fromarray(arr).save(join(root, dec, f"d{dec}_{i}.jpg"))
    return str(root)


@pytest.fixture(scope="module")
def shards(mini_dataset, tmp_path_factory):
    """The JAX package's feature cache and shards of all six images (two
    blocks of two and one of two, in one file) and of 1930 alone."""
    root = tmp_path_factory.mktemp("store")
    store = jd.FeatureStore(str(root / "cache"), str(root / "shards"))
    paths = [join(mini_dataset, d, f"d{d}_{i}.jpg") for d in ("1930", "1990") for i in range(3)]
    return dict(root=root, paths=paths, all=store.build_shards(paths, "t-all", num_splits=1, batch_size=2),
                split=store.build_shards(paths, "t-split", num_splits=3, batch_size=2))


def _same_hits(got, want):
    """Scores equal to SCORE_TOL; the (bbox, path[, feature]) of each hit
    equal where its score is clear of its neighbours by more than that."""
    assert len(got) == len(want)
    sg, sw = np.asarray([g[0] for g in got]), np.asarray([w[0] for w in want])
    np.testing.assert_allclose(sg, sw, **SCORE_TOL)
    tol = SCORE_TOL["atol"] + SCORE_TOL["rtol"] * np.abs(sw)
    for i, (g, w) in enumerate(zip(got, want)):
        clear = all(abs(sw[i] - sw[j]) > tol[i] + tol[j] for j in (i - 1, i + 1) if 0 <= j < len(sw))
        if clear:
            assert g[1:3] == w[1:3], (i, g[:3], w[:3])
            for a, b in zip(g[3:], w[3:]):
                np.testing.assert_array_equal(a, b)


def test_iou_and_contrast_gate_equal_jax():
    boxes = [(0, 0, 10, 10), (10, 10, 20, 20), (5, 5, 15, 15), (0, 0, 64, 64), (8, 0, 72, 64), (3, 4, 3, 9)]
    for a in boxes:
        for b in boxes:
            assert pd.iou(a, b) == jd.iou(a, b)
    rng = np.random.RandomState(0)
    for arr in [np.full((64, 64, 3), 128, np.uint8), rng.randint(0, 255, (64, 64, 3), dtype=np.uint8),
                rng.randint(100, 140, (64, 64, 3), dtype=np.uint8)]:
        img = Image.fromarray(arr)
        assert pd.patch_has_contrast(img) == jd.patch_has_contrast(img)


def test_feature_caches_interchange_both_ways(mini_dataset, shards, tmp_path):
    root, paths = shards["root"], shards["paths"]
    # the port reads the JAX package's .npy cache and builds byte-identical shards from it
    port_on_jax = pd.FeatureStore(str(root / "cache"), str(tmp_path / "shards"), device="cpu")
    jax_store = jd.FeatureStore(str(root / "cache"), str(root / "shards"))
    for p in paths:
        np.testing.assert_array_equal(port_on_jax.image_features(p), jax_store.image_features(p))
    built = port_on_jax.build_shards(paths, "t-all", num_splits=1, batch_size=2)
    assert [os.path.basename(b) for b in built] == [os.path.basename(s) for s in shards["all"]]
    for a, b in zip(built, shards["all"]):
        assert open(a, "rb").read() == open(b, "rb").read()
    # the port's shard reader gives the safetensors package's keys, order and arrays
    for sp in shards["split"]:
        got, want = pd.load_shard(sp), load_file(sp)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == np.float16
            np.testing.assert_array_equal(got[k], want[k])
    # the JAX package reads a cache the port computed
    port_store = pd.FeatureStore(str(tmp_path / "pcache"), str(tmp_path / "pshards"), device="cpu")
    jax_on_port = jd.FeatureStore(str(tmp_path / "pcache"), str(tmp_path / "jshards"))
    for p in paths:
        feats = port_store.image_features(p)
        assert feats.shape == (9, 9, 2112)
        np.testing.assert_array_equal(jax_on_port.image_features(p), feats)
        # the cached LAB part is the JAX package's to an fp16 ulp (the HOG
        # part of these 8-bit images has pixels whose bin is ambiguous, a bin
        # edge or a channel tie, each moving a whole 64 px block; the HOG
        # parity is tests/test_torch_port_hog.py's)
        key = os.path.abspath(p).replace("/", "_") + ".npy"
        lab_p = np.load(join(tmp_path / "pcache", key))[..., -128:].astype(np.float32)
        lab_j = np.load(join(root / "cache", key))[..., -128:].astype(np.float32)
        np.testing.assert_allclose(lab_p, lab_j, rtol=2.0**-10, atol=0)
    for sp in port_store.build_shards(paths, "p", num_splits=2, batch_size=2):
        got, want = load_file(sp), pd.load_shard(sp)
        assert list(got) == list(want) and all(np.array_equal(got[k], want[k]) for k in got)


@pytest.mark.parametrize("case", ["plain", "fold", "fold_only_pos_ret_ws"])
def test_dense_search_matches_jax(shards, case):
    store = jd.FeatureStore(str(shards["root"] / "cache"), str(shards["root"] / "shards"))
    feats = [store.image_features(p) for p in shards["paths"]]
    rng = np.random.RandomState(5)
    ws = np.stack([feats[0][2, 3], feats[4][1, 6], feats[2][5, 5]]
                  + [rng.randn(2112).astype(np.float32) * 0.02 for _ in range(2)]).astype(np.float32)
    kw = {"plain": dict(top_k=4), "fold": dict(top_k=5, fold=(1, 3)),
          "fold_only_pos_ret_ws": dict(top_k=3, fold=(2, 3), only_pos=True, ret_ws=True)}[case]
    for sp in (shards["all"], shards["split"]):
        want = jd.dense_search(ws, sp, **kw)
        got = pd.dense_search(ws, sp, device="cpu", **kw)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            _same_hits(g, w)
    if case == "plain":
        top = pd.dense_search(ws[:1], shards["all"], top_k=3, device="cpu")[0][0]
        assert top[0] == pytest.approx(1.0, abs=1e-3) and top[1] == (16, 24) and top[2] == shards["paths"][0]


def test_masked_positions_score_zero_as_in_jax(shards):
    """A detector that scores every open position negatively: the masked
    positions score 0 and win, in both packages."""
    ws = -np.abs(np.random.RandomState(1).randn(1, 2112)).astype(np.float32)
    want = jd.dense_search(ws, shards["all"], top_k=6, fold=(1, 3))
    got = pd.dense_search(ws, shards["all"], top_k=6, device="cpu", fold=(1, 3))
    assert [g[0] for g in got[0]] == [w[0] for w in want[0]] == [0.0] * 6
    assert [g[1:] for g in got[0]] == [w[1:] for w in want[0]]


def test_fold_mask_and_random_sample_equal_jax(shards):
    for fold in (None, (1, 3), (3, 3)):
        for sp in (shards["all"], shards["split"]):
            want = jd.random_sample(sp, fold=fold, num_samples=37, seed=2)
            got = pd.random_sample(sp, fold=fold, num_samples=37, seed=2)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    mask = pd.fold_mask(3, 2, 81, (2, 3))
    rng = np.random.RandomState(3)
    for b in range(2):
        want = np.zeros(81, np.float32)
        want[rng.permutation(81)[:54]] = 1.0
        np.testing.assert_array_equal(mask[b], want)


def test_splits_and_init_patches_equal_jax(mini_dataset, tmp_path):
    dj = jd.Doersch(str(tmp_path / "jax"), "ftt", mini_dataset, how_many=6, threshold=50)
    dp = pd.Doersch(str(tmp_path / "port"), "ftt", mini_dataset, how_many=6, threshold=50, device="cpu")
    assert dp.categories() == dj.categories() == ["1930", "1990"]
    for c in dp.categories():
        assert dp.positive_paths(c) == dj.positive_paths(c)
        assert dp.negative_paths(c) == dj.negative_paths(c)
        assert dp.positive_paths(c, 1, 3) == dj.positive_paths(c, 1, 3)
        assert dp.init_patches(c, 6) == dj.init_patches(c, 6)
        assert dp.init_patches(c, 40, num_trials=3) == dj.init_patches(c, 40, num_trials=3)


def _detectors(root, c="1930"):
    d = join(root, "ftt", c, "detectors", "50")
    return {f: pickle.load(open(join(d, f), "rb")) for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("batch_svm", ["1", "0"])
def test_mini_end_to_end_matches_jax(mini_dataset, tmp_path, monkeypatch, batch_svm):
    """get_top end to end on both SVM paths from one hog cache: the ranked
    init detectors equal, every trained detector's accuracy, hits and
    weights as the JAX package's, the figures written."""
    monkeypatch.setenv("DIFFMINING_DOERSCH_BATCH_SVM", batch_svm)
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    dj = jd.Doersch(jroot, "ftt", mini_dataset, how_many=6, threshold=50)
    img_j = dj.get_top("1930", top_k=3, top_elem=3)
    os.makedirs(join(proot, "ftt"))
    shutil.copytree(join(jroot, "ftt", "hog_cache"), join(proot, "ftt", "hog_cache"))
    dp = pd.Doersch(proot, "ftt", mini_dataset, how_many=6, threshold=50, device="cpu")
    img_p = dp.get_top("1930", top_k=3, top_elem=3)
    assert img_p.size == img_j.size
    init = "1930/init_ws_42_50_6_1000_hog.pkl"
    ij, ip = (pickle.load(open(join(r, "ftt", init), "rb")) for r in (jroot, proot))
    assert [(k, p) for k, p, _ in ip] == [(k, p) for k, p, _ in ij]
    for (_, _, a), (_, _, b) in zip(ip, ij):
        np.testing.assert_array_equal(a, b)
    det_j, det_p = _detectors(jroot), _detectors(proot)
    assert list(det_p) == list(det_j) and len(det_p) == 5
    for f in det_j:
        acc_j, hits_j, top_j, w_j = det_j[f]
        acc_p, hits_p, top_p, w_p = det_p[f]
        assert acc_p == acc_j
        _same_hits(hits_p, hits_j)
        np.testing.assert_allclose(w_p, w_j, rtol=1e-4, atol=1e-5)
    out = join(proot, "ftt", "1930")
    assert os.path.isfile(join(out, "top_42_50_6_hog_final.png"))
    plot = dp.plot_detectors("1930")
    assert plot is not None and plot.size == dj.plot_detectors("1930").size
    assert os.path.isfile(join(out, "plots", "50", "detectors", "init.png"))


def test_doersch_command_on_the_cpu(mini_dataset, tmp_path):
    main_dir = str(tmp_path / "run")
    port_main(["doersch", "--dataset_path", mini_dataset, "--which", "ftt", "--category", "1990",
               "--how_many", "4", "--main_dir", main_dir, "--device", "cpu"])
    assert os.path.isfile(join(main_dir, "ftt", "1990", "top_42_50_4_hog_final.png"))
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node 2"):
        port_main(["doersch", "--dataset_path", mini_dataset, "--which", "ftt", "--mesh_dp", "2", "--device", "cpu"])
