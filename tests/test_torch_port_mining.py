"""The port's mining slice held to the JAX package on the CPU: the pool ops,
top-k suppression, k-means, the UNet's DIFT taps, ``SDFeaturizer`` with the
JAX draws injected, and ``Cluster`` end to end on one shared artifact tree
(identical patch tables; the same ranked clusters when both k-means start
from JAX's k-means++ draws, rank correlation > 0.95 as the repo's oracle in
tests/test_torch_port_pipeline.py), the clip and clip+dift-161 feature
modes with a tiny vision tower carried across, and the ``cluster`` CLI with
--device cpu.

Float32 throughout. Map ops agree to rtol 1e-5 (summation order); UNet
outputs and features to rtol 1e-3, atol 2e-4, the UNet tests' framework-to-
framework bound.
"""
import itertools
import os
import sys
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffmining_tpu.ops import kmeans as jkm
from diffmining_tpu.ops import pool as jpool
from diffmining_tpu.typicality.cluster import Cluster as JCluster
from diffmining_tpu.typicality.compute import SD as JSD
from diffmining_tpu.typicality.compute import Typicality as JTypicality
from diffmining_tpu.typicality.dift import SDFeaturizer as JFeaturizer
from diffmining_tpu.utils import figures as jfig
from diffmining_tpu.utils.export import save_pipeline_dir

from diffmining_tpu_torch.models.unet import TINY_UNET, UNet2DCondition
from diffmining_tpu_torch.ops import kmeans as pkm
from diffmining_tpu_torch.ops import pool as ppool
from diffmining_tpu_torch.typicality.cluster import Cluster
from diffmining_tpu_torch.typicality.compute import SD
from diffmining_tpu_torch.typicality.dift import SDFeaturizer
from diffmining_tpu_torch.utils import figures as pfig
from diffmining_tpu_torch.utils.weights import load_state, params_from_jax

torch.set_num_threads(1)
TOL = dict(rtol=1e-3, atol=2e-4)
MAP_TOL = dict(rtol=1e-5, atol=1e-6)
DECADES = ["1930", "1990"]
DIFT_SEED = 42  # SDFeaturizer's default seed in both packages


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ pool ops


def test_box_pool_and_upsample_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 17, 23).astype(np.float32)
    np.testing.assert_allclose(ppool.box_pool(_t(x), 5, 7).numpy(), np.asarray(jpool.box_pool(jnp.asarray(x), 5, 7)),
                               **MAP_TOL)
    small = rng.rand(2, 5, 7).astype(np.float32)
    for h, w in ((10, 14), (37, 41), (64, 64)):  # exact 2x and odd sizes
        np.testing.assert_allclose(ppool.upsample_bilinear(_t(small), h, w).numpy(),
                                   np.asarray(jpool.upsample_bilinear(jnp.asarray(small), h, w)), **MAP_TOL)


@pytest.mark.parametrize("h,w,k", [(37, 41, 8), (32, 32, 16)])
def test_score_maps_match_jax(h, w, k):
    grid = (np.random.RandomState(h).rand(4, 2, 4, 5, 7) * 2).astype(np.float16)
    np.testing.assert_allclose(ppool.typicality_map(_t(grid), h, w, k, k).numpy(),
                               np.asarray(jpool.typicality_map(jnp.asarray(grid), h, w, k, k)), **MAP_TOL)
    np.testing.assert_allclose(ppool.pixel_typicality_map(_t(grid), h, w).numpy(),
                               np.asarray(jpool.pixel_typicality_map(jnp.asarray(grid), h, w)), **MAP_TOL)


@pytest.mark.parametrize("sigma,ksize", [(2.0, 17), (10.0, 81)])
def test_gaussian_blur_and_filters_match_jax(sigma, ksize):
    """Reflect padding narrower and (40 > 30) wider than the map."""
    dm = np.random.RandomState(1).randn(30, 40).astype(np.float32)
    np.testing.assert_allclose(ppool.gaussian_blur(_t(dm), sigma, ksize).numpy(),
                               np.asarray(jpool.gaussian_blur(jnp.asarray(dm), sigma, ksize)), **MAP_TOL)
    np.testing.assert_array_equal(ppool.gauss_kernel_1d(3.0, 13), jpool.gauss_kernel_1d(3.0, 13))
    for v in (10, 128, 240):
        arr = np.full((8, 8, 3), v, np.uint8)
        assert ppool.filter_patch(arr) == jpool.filter_patch(arr)


@pytest.mark.parametrize("h,w,kx,k", [(40, 50, 8, 5), (100, 100, 20, 1000)])
def test_top_patches_equal_jax_numpy_path(monkeypatch, h, w, kx, k):
    """The greedy suppression and top-k, against the JAX package's numpy path
    (its native fast path blocked); the second case exhausts the capped
    candidates and reruns on the full order."""
    monkeypatch.setitem(sys.modules, "diffmining_tpu.native.boxops", None)
    score = np.random.RandomState(h).rand(h, w).astype(np.float32)
    boxes, scores = ppool.top_patches(score, kx, kx, k)
    jboxes, jscores = jpool.top_patches(score, kx, kx, k)
    np.testing.assert_array_equal(boxes, jboxes)
    np.testing.assert_array_equal(scores, jscores)
    np.testing.assert_array_equal(ppool.get_non_overlapping(boxes, scores, 3),
                                  jpool.get_non_overlapping(jboxes, jscores, 3))


# -------------------------------------------------------------------- k-means


def test_lloyd_from_a_fixed_init_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(200, 16).astype(np.float32)
    init = x[:6].copy()
    np.testing.assert_allclose(pkm.pairwise_sq_dists(_t(x), _t(init)).numpy(),
                               np.asarray(jkm.pairwise_sq_dists(jnp.asarray(x), jnp.asarray(init))), rtol=1e-5,
                               atol=1e-5)
    c, labels, inertia = pkm.lloyd(_t(x), _t(init), 6)
    jc, jlabels, jinertia = jkm.lloyd(jnp.asarray(x), jnp.asarray(init), 6)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    np.testing.assert_allclose(float(inertia), float(jinertia), rtol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)


def _partition(labels):
    labels = np.asarray(labels)
    return labels[:, None] == labels[None, :]


def test_kmeans_on_blobs_gives_the_jax_partition():
    rng = np.random.RandomState(3)
    centers = rng.randn(4, 8) * 10
    x = np.concatenate([c + rng.randn(25, 8) for c in centers]).astype(np.float32)
    got = pkm.KMeans(4, random_state=10, device="cpu").fit(x)
    want = jkm.KMeans(4, random_state=10).fit(x)
    np.testing.assert_array_equal(_partition(got.labels_), _partition(want.labels_))
    np.testing.assert_allclose(got.inertia_, want.inertia_, rtol=1e-5)
    assert got.cluster_centers_.shape == (4, 8)


def test_kmeans_variants_match_jax():
    """KMeansSplitReassign draws its init from numpy's RandomState in both
    packages, so its labels are equal; KMeansRe re-seeds from its own stream
    and must leave no cluster under its minimum size on blobs."""
    rng = np.random.RandomState(4)
    x = np.concatenate([rng.randn(60, 4), rng.randn(4, 4) + 8]).astype(np.float32)
    got = pkm.KMeansSplitReassign(5, random_state=1, k_min=0.1, device="cpu").fit(x)
    want = jkm.KMeansSplitReassign(5, random_state=1, k_min=0.1).fit(x)
    np.testing.assert_array_equal(got.labels_, want.labels_)
    np.testing.assert_allclose(got.inertia_, want.inertia_, rtol=1e-5)
    re = pkm.KMeansRe(3, random_state=0, n_init=2, device="cpu").fit(x)
    assert re.labels_.shape == (64,) and np.isfinite(re.inertia_)


# ----------------------------------------------------------------- DIFT path


def test_unet_up_ft_taps_match_jax(tree):
    """Each up block's output after its upsampler, at a size where the
    upsamplers size themselves to the skips (7x5 -> 14x10)."""
    jsd = tree[3]
    punet = UNet2DCondition(TINY_UNET).eval()
    load_state(punet, params_from_jax(jax.tree_util.tree_map(np.asarray, jsd.unet_params), "unet"))
    rng = np.random.RandomState(6)
    x = rng.randn(2, 4, 14, 10).astype(np.float32)
    ctx = rng.randn(2, 77, 32).astype(np.float32)
    t = np.array([161, 161], np.int32)
    run = jax.jit(lambda p, x, t, c: jsd.unet.apply(p, x, t, c, up_ft_indices=(0, 1)))
    want = run(jsd.unet_params, jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        got = punet(_t(x), _t(t), _t(ctx), up_ft_indices=(0, 1))
    assert set(got) == {"sample", "up_ft"} and set(got["up_ft"]) == {0, 1}
    for i in (0, 1):
        np.testing.assert_allclose(got["up_ft"][i].numpy(), np.asarray(want["up_ft"][i]).transpose(0, 3, 1, 2), **TOL)
    np.testing.assert_allclose(got["sample"].numpy(), np.asarray(want["sample"]).transpose(0, 3, 1, 2), **TOL)


def _jax_dift_draws(uid, latent_shape, ensemble_size):
    """JAX SDFeaturizer's draws (dift.py:81-88) in the port's NCHW layout."""
    c, h, w = latent_shape
    base = jax.random.PRNGKey(DIFT_SEED)
    kvae = jax.random.fold_in(jax.random.fold_in(base, 11), uid)
    kens = jax.random.fold_in(jax.random.fold_in(base, 13), uid)
    vae = np.asarray(jax.random.normal(kvae, (1, h, w, c), dtype=jnp.float32))[0].transpose(2, 0, 1)
    noise = np.asarray(jax.random.normal(kens, (ensemble_size, h, w, c), dtype=jnp.float32)).transpose(0, 3, 1, 2)
    return _t(vae), _t(noise)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A tiny ftt dataset (3 random 32px images per decade), its JAX sweep
    artifacts (N=4) and the JAX bundle exported as a pipeline dir."""
    root = tmp_path_factory.mktemp("ftt")
    rng = np.random.RandomState(0)
    for dec in DECADES:
        os.makedirs(join(root, dec))
        for i in range(3):
            Image.fromarray(rng.randint(0, 255, (32, 32, 3), dtype=np.uint8)).save(join(root, dec, f"img_{dec}_{i}.png"))
    jsd = JSD.init_tiny("ftt", DECADES)
    pipe = str(tmp_path_factory.mktemp("pipe"))
    save_pipeline_dir(pipe, jsd.unet.config, jax.device_get(jsd.unet_params), jsd.vae.config,
                      jax.device_get(jsd.vae_params), jsd.clip.config, jax.device_get(jsd.clip_params), jsd.schedule)
    typ = str(tmp_path_factory.mktemp("typ"))
    jt = JTypicality("ftt", None, str(root), typ, t_min=0.1, t_max=0.7, sd=jsd, N=4)
    for dec in DECADES:
        jt.D[dec].compute_batch([(p, dec) for p in jt.get_seeds_(dec)])
    psd = SD.from_pipeline_dir("ftt", pipe, [], dtype=torch.float32, device="cpu")
    return str(root), typ, pipe, jsd, psd


def test_featurizer_matches_jax(tree):
    _, _, _, jsd, psd = tree
    img = np.random.RandomState(7).uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    want = JFeaturizer(jsd).forward(img, "a photo", t=161, uid=5)
    feat = SDFeaturizer(psd, draws=_jax_dift_draws)
    got = feat.forward(img, "a photo", t=161, uid=5)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    box = (4, 8, 20, 24)
    pf = feat.patch_feature(img, "a photo", box, t=161, uid=5)
    np.testing.assert_allclose(pf, JFeaturizer(jsd).patch_feature(img, "a photo", box, t=161, uid=5), atol=2e-4)
    np.testing.assert_allclose(np.linalg.norm(pf), 1.0, rtol=1e-5)
    feat.patch_feature(img, "a photo", (0, 0, 8, 8), t=161, uid=5)
    assert feat.n_passes == 2  # the second patch of the image came from the cache


@pytest.fixture(scope="module")
def clusters(tree, tmp_path_factory):
    root, typ, _, jsd, psd = tree
    jcl = JCluster("ftt", typ, root, str(tmp_path_factory.mktemp("jcache")), sd=jsd, dift_sd=jsd, kx=8, ky=8)
    pcl = Cluster("ftt", typ, root, str(tmp_path_factory.mktemp("pcache")), dift_sd=psd, kx=8, ky=8,
                  device="cpu", dtype=torch.float32, dift_draws=_jax_dift_draws)
    return jcl, pcl


def test_patch_tables_equal_jax(clusters):
    jcl, pcl = clusters
    want, got = jcl.patch_tables(k_per_image=3), pcl.patch_tables(k_per_image=3)
    for dec in DECADES:
        for g, w in zip(got[dec], want[dec]):
            assert list(g.columns) == list(w.columns) and len(g) == len(w) == 9
            cols = ["seed", "x_start", "y_start", "x_end", "y_end", "origin"]
            assert g[cols].equals(w[cols])
            np.testing.assert_allclose(g["D"].values, w["D"].values, **MAP_TOL)


def test_clustering_matches_jax(clusters, monkeypatch):
    """Both k-means runs start from JAX's k-means++ draws (the restart keys
    fold_in(PRNGKey(10), i)) on the port's features: the ranked clusters
    have the same members in the same order, scores equal, and the per-patch
    cluster ranks correlate > 0.95 (the oracle's threshold)."""
    jcl, pcl = clusters
    calls = itertools.count()

    def jax_init(generator, x, k):
        key = jax.random.fold_in(jax.random.PRNGKey(10), next(calls) % 10)
        return _t(np.asarray(jkm.kmeanspp_init(key, jnp.asarray(x.numpy()), k)))

    monkeypatch.setattr(pkm, "kmeanspp_init", jax_init)
    want = jcl.clustering("dift-161", k_per_image=3, k=9, num_clusters=3)
    got = pcl.clustering("dift-161", k_per_image=3, k=9, num_clusters=3)
    for dec in DECADES:
        g_ids = [[m[2] for m in members] for members, _ in got[dec]]
        w_ids = [[m[2] for m in members] for members, _ in want[dec]]
        assert [sorted(c) for c in g_ids] == [sorted(c) for c in w_ids]
        np.testing.assert_allclose([s for _, s in got[dec]], [s for _, s in want[dec]], **MAP_TOL)
        rank_g = {i: r for r, c in enumerate(g_ids) for i in c}
        rank_w = {i: r for r, c in enumerate(w_ids) for i in c}
        ids = sorted(rank_g)
        a = np.argsort(np.argsort([rank_g[i] for i in ids]))
        b = np.argsort(np.argsort([rank_w[i] for i in ids]))
        assert np.corrcoef(a, b)[0, 1] > 0.95
        # crops are named {rank}-{member}-{num_clusters}_{id}.png; members sort
        # by distance to the center, where near-ties may fall either way
        def crops(cl):
            names = os.listdir(join(cl.cache_path, "images", "clusters", "ranked", "dift-161", dec))
            return sorted((n.split("-")[0], n.split("_", 1)[1]) for n in names)

        assert crops(pcl) == crops(jcl) and len(crops(pcl)) == 9
        emb = join(pcl.cache_path, "embeddings", "dift-161")
        jemb = join(jcl.cache_path, "embeddings", "dift-161")
        for name in os.listdir(jemb):
            np.testing.assert_allclose(np.load(join(emb, name), allow_pickle=True),
                                       np.load(join(jemb, name), allow_pickle=True), atol=2e-4)


def test_rankings_and_overlays_match_jax(clusters):
    jcl, pcl = clusters
    for dec in DECADES:
        got, want = pcl.rank_images(dec), jcl.rank_images(dec)
        assert [p for p, _ in got] == [p for p, _ in want]
        np.testing.assert_allclose([v for _, v in got], [v for _, v in want], **MAP_TOL)
    path = pcl.get_seeds(pcl.D[DECADES[0]], DECADES[0])[0]
    a = np.asarray(pcl.typicality_overlay(pcl.D[DECADES[0]], path, sigma=2.0), np.int16)
    b = np.asarray(jcl.typicality_overlay(jcl.D[DECADES[0]], path, sigma=2.0), np.int16)
    assert np.abs(a - b).max() <= 1  # uint8 truncation of equal-to-1e-6 floats


def test_figures_equal_jax():
    rng = np.random.RandomState(8)
    pils = [Image.fromarray(rng.randint(0, 255, (6 + i, 5 + i, 3), dtype=np.uint8)) for i in range(3)]
    for fn in ("hcat_margin", "vcat"):
        assert getattr(pfig, fn)(pils).tobytes() == getattr(jfig, fn)(pils).tobytes()
    assert pfig.add_border(pils[0], "red").tobytes() == jfig.add_border(pils[0], "red").tobytes()
    rows = [[p.resize((6, 6)) for p in pils]] * 2
    assert pfig.make_grid(rows).tobytes() == jfig.make_grid(rows).tobytes()


@pytest.mark.parametrize("feature_which", ["clip", "clip+dift-161"])
def test_clip_modes_match_jax(tree, monkeypatch, tmp_path, feature_which):
    """cluster's clip modes with the tiny vision tower carried across: the
    per-patch features ([clip | dift] for clip+dift, the CLIP part
    L2-normalised) within the UNet tests' bound, and, both k-means starting
    from JAX's k-means++ draws, the same ranked clusters."""
    from diffmining_tpu.models.clip import TINY_CLIP_VISION, CLIPVisionModel

    from diffmining_tpu_torch.models import clip as pclip

    root, typ, _, jsd, psd = tree
    vision = CLIPVisionModel(TINY_CLIP_VISION)
    vp = vision.init(jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3)))
    jcl = JCluster("ftt", typ, root, str(tmp_path / "j"), sd=jsd, dift_sd=jsd, kx=8, ky=8,
                   clip_bundle={"config": TINY_CLIP_VISION, "params": vp})
    pcl = Cluster("ftt", typ, root, str(tmp_path / "p"), dift_sd=psd, kx=8, ky=8, device="cpu",
                  dtype=torch.float32, dift_draws=_jax_dift_draws,
                  clip_bundle={"config": pclip.TINY_CLIP_VISION,
                               "state_dict": params_from_jax(jax.tree_util.tree_map(np.asarray, vp), "clip_vision")})
    df = pcl.patch_tables(k_per_image=3)[DECADES[0]][0]
    got = pcl.compute_embeddings(df, c=DECADES[0], feature_which=feature_which)[0]
    want = jcl.compute_embeddings(df, c=DECADES[0], feature_which=feature_which)[0]
    dim = TINY_CLIP_VISION.projection_dim
    for g, w in zip(got, want):
        assert g.shape == w.shape == ((dim,) if feature_which == "clip" else (dim + w.shape[0] - dim,))
        np.testing.assert_allclose(g, w, **TOL)
        np.testing.assert_allclose(np.linalg.norm(g[:dim]), 1.0, rtol=1e-5)
    calls = itertools.count()

    def jax_init(generator, x, k):
        key = jax.random.fold_in(jax.random.PRNGKey(10), next(calls) % 10)
        return _t(np.asarray(jkm.kmeanspp_init(key, jnp.asarray(x.numpy()), k)))

    monkeypatch.setattr(pkm, "kmeanspp_init", jax_init)
    want_c = jcl.clustering(feature_which, k_per_image=3, k=9, num_clusters=3)
    got_c = pcl.clustering(feature_which, k_per_image=3, k=9, num_clusters=3)
    for dec in DECADES:
        assert [sorted(m[2] for m in ms) for ms, _ in got_c[dec]] == [sorted(m[2] for m in ms) for ms, _ in want_c[dec]]
        np.testing.assert_allclose([s for _, s in got_c[dec]], [s for _, s in want_c[dec]], **MAP_TOL)


def test_unported_modes_raise(clusters, tree, tmp_path):
    from diffmining_tpu_torch.typicality.cluster import main

    root, typ, _, _, _ = tree
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node 2"):
        main(["-w", "ftt", "-d", root, "-t", typ, "-c", str(tmp_path), "--mesh_dp", "2", "--device", "cpu"])


def test_cluster_cli_on_the_cpu(tree, tmp_path):
    """python -m diffmining_tpu_torch cluster ... --device cpu: top-k crops
    with overlays, clustering, and both figure kinds from the cache."""
    from diffmining_tpu_torch.__main__ import main as cli

    root, typ, pipe, _, _ = tree
    cache, figs = str(tmp_path / "cache"), str(tmp_path / "figs")
    common = ["-w", "ftt", "-d", root, "-t", typ, "-c", cache, "-m", pipe, "--k", "8", "--dtype", "fp32",
              "--device", "cpu"]
    cli(["cluster", *common, "--topk", "--overlays", "--cluster", "--num_clusters", "2", "--num_images", "6",
         "--figure_path", figs, "--min_row", "1"])
    for dec in DECADES:
        crops = os.listdir(join(cache, "images", "clusters", "ranked", "dift-161", dec))
        assert len(crops) == 6 and all(c.endswith(".png") for c in crops)
        assert len(os.listdir(join(cache, "images", "topk", "D", dec))) == 12  # 6 crops + 6 overlays
    assert os.listdir(join(figs, "clusters")) and os.listdir(join(figs, "topk"))
    cli(["cluster", *common, "--figure_path", str(tmp_path / "full"), "--top_full_images"])
    assert len(os.listdir(join(tmp_path / "full", "ordered"))) == 3 * len(DECADES)
