"""The port's parallel-dataset pipeline (applications/parallel.py) held to
the JAX package's on the CPU, mirroring tests/test_parallel.py with JAX's
draws injected: the sweep over ground-truth and translated files (the
sweep's bound, rtol 2e-3, atol 1e-4), the groups, ``df_PD``'s median stack
(rtol 1e-5, the boxes equal), the dift, clip and clip+dift embeddings (rtol
1e-3, atol 2e-4: the UNet tests' framework-to-framework bound),
``clustering`` end to end (both k-means from JAX's k-means++ draws: the same
ranked clusters), the CLI's --figures_only and aliases, --mesh_dp 2
outside a process group naming torchrun, and the ``parallel`` command with
--device cpu.
"""
import itertools
import os
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffmining_tpu.applications.parallel import ParallelCluster as JParallelCluster
from diffmining_tpu.applications.parallel import ParallelTypicality as JParallelTypicality
from diffmining_tpu.models.clip import TINY_CLIP_VISION, CLIPVisionModel
from diffmining_tpu.ops import kmeans as jkm
from diffmining_tpu.typicality.compute import SD as JSD
from diffmining_tpu.typicality.engine import sample_noise_and_t
from diffmining_tpu.utils.export import save_pipeline_dir

from diffmining_tpu_torch.applications import parallel as ppar
from diffmining_tpu_torch.applications.parallel import ParallelCluster, ParallelTypicality
from diffmining_tpu_torch.models import clip as pclip
from diffmining_tpu_torch.ops import kmeans as pkm
from diffmining_tpu_torch.typicality.compute import SD
from diffmining_tpu_torch.utils.weights import params_from_jax

torch.set_num_threads(1)
TOL = dict(rtol=1e-3, atol=2e-4)
MAP_TOL = dict(rtol=1e-5, atol=1e-6)
COUNTRIES = ["France", "Japan"]
N, SEED = 4, 42  # the sweep's samples; its seed in both packages
DIFT_SEED = 42  # SDFeaturizer's default seed in both packages


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_sweep_draws(uid, latent_shape):
    """The JAX sweep's draws for one image (t over [0, 1]: ParallelTypicality's
    defaults), in the port's layout."""
    c, h, w = latent_shape
    vae_key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(SEED), 7), uid)
    post = np.asarray(jax.random.normal(vae_key, (h, w, c), dtype=jnp.float32)).transpose(2, 0, 1)
    noise, t = sample_noise_and_t(jax.random.fold_in(jax.random.PRNGKey(SEED), uid), N, (h, w, c), 0.0, 1.0)
    return (_t(np.ascontiguousarray(post)), _t(np.ascontiguousarray(np.asarray(noise).transpose(0, 3, 1, 2))),
            _t(np.asarray(t)).long())


def _jax_dift_draws(uid, latent_shape, ensemble_size):
    c, h, w = latent_shape
    base = jax.random.PRNGKey(DIFT_SEED)
    kvae = jax.random.fold_in(jax.random.fold_in(base, 11), uid)
    kens = jax.random.fold_in(jax.random.fold_in(base, 13), uid)
    vae = np.asarray(jax.random.normal(kvae, (1, h, w, c), dtype=jnp.float32))[0].transpose(2, 0, 1)
    noise = np.asarray(jax.random.normal(kens, (ensemble_size, h, w, c), dtype=jnp.float32)).transpose(0, 3, 1, 2)
    return _t(vae), _t(noise)


@pytest.fixture(scope="module")
def translated_dataset(tmp_path_factory):
    """PnP's output layout: {root}/{source}/gt--{source}___{sid}.jpg and a
    {target}___{sid}.jpg translation for the other country."""
    root = tmp_path_factory.mktemp("parallel")
    rng = np.random.RandomState(0)
    for src in COUNTRIES:
        os.makedirs(join(root, src))
        for sid in ["a1", "b2"]:
            for prefix in [f"gt--{src}"] + [c for c in COUNTRIES if c != src]:
                arr = rng.randint(0, 255, (32, 32, 3), dtype=np.uint8)
                Image.fromarray(arr).save(join(root, src, f"{prefix}___{sid}.jpg"))
    return str(root)


@pytest.fixture(scope="module")
def computed(translated_dataset, tmp_path_factory):
    """JAX's sweep over every file, the JAX bundle as a pipeline dir, and the
    port's bundle read from it."""
    jsd = JSD.init_tiny("geo", COUNTRIES)
    typ_path = str(tmp_path_factory.mktemp("ptyp"))
    typ = JParallelTypicality(None, translated_dataset, typ_path, sd=jsd, N=N)
    for c in COUNTRIES:
        typ.D[c].compute_batch([(p, c) for p in typ.get_seeds_(c)])
    pipe = str(tmp_path_factory.mktemp("pipe"))
    save_pipeline_dir(pipe, jsd.unet.config, jax.device_get(jsd.unet_params), jsd.vae.config,
                      jax.device_get(jsd.vae_params), jsd.clip.config, jax.device_get(jsd.clip_params), jsd.schedule)
    psd = SD.from_pipeline_dir("geo", pipe, COUNTRIES, dtype=torch.float32, device="cpu")
    return jsd, typ, typ_path, translated_dataset, pipe, psd


def test_groups_and_seeds_equal_jax(computed):
    jsd, jtyp, typ_path, ds, _, _ = computed
    ptyp = ParallelTypicality(None, ds, typ_path, device="cpu")
    assert sorted(ptyp.parent) == COUNTRIES
    for c in COUNTRIES:
        assert ptyp.get_seeds_(c) == jtyp.get_seeds_(c) and len(ptyp.get_seeds_(c)) == 4
        assert ptyp.parallel[c] == jtyp.parallel[c]
        for group in ptyp.parallel[c]:
            assert group[0][1] == c and {cc for _p, cc in group} == set(COUNTRIES)


def test_sweep_over_translations_matches_jax(computed, tmp_path):
    """make_submission + compute_submission with JAX's draws: the artifacts
    of every ground-truth and translated file equal JAX's."""
    _, jtyp, typ_path, ds, _, psd = computed
    tree, subs = str(tmp_path / "tree"), str(tmp_path / "subs")
    ptyp = ParallelTypicality(None, ds, tree, sd=psd, N=N, device="cpu", draws=_jax_sweep_draws)
    ptyp.make_submission(ds, subs, sub_split=1)
    with open(join(subs, "0.txt")) as f:
        assert len(f.read().split()) == 8
    ptyp.compute_submission(join(subs, "0.txt"))
    for c in COUNTRIES:
        for p in jtyp.get_seeds_(c):
            got, want = ptyp.D[c](p), jtyp.D[c](p)
            assert got.shape == want.shape == (N, 2, 4, 16, 16) and got.dtype == np.float16
            np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), rtol=2e-3, atol=1e-4)


def _clusters(computed, tmp_path, **kw):
    jsd, _, typ_path, ds, _, psd = computed
    j = JParallelCluster(typ_path, ds, str(tmp_path / "j"), sd=jsd, dift_sd=jsd, kx=8, ky=8, **kw.get("j", {}))
    p = ParallelCluster(typ_path, ds, str(tmp_path / "p"), dift_sd=psd, kx=8, ky=8, device="cpu",
                        dtype=torch.float32, dift_draws=_jax_dift_draws, **kw.get("p", {}))
    return j, p


def test_df_pd_median_stack_matches_jax(computed, tmp_path):
    j, p = _clusters(computed, tmp_path)
    for got, want in zip(p.df_PD(k_per_image=2), j.df_PD(k_per_image=2)):
        assert list(got.columns) == list(want.columns) and len(got) == len(want) == 2 * 2 * 2
        exact = ["x_start", "y_start", "x_end", "y_end", "origin"] + ["path_" + c for c in COUNTRIES]
        assert got[exact].equals(want[exact])
        np.testing.assert_allclose(got[["D"] + COUNTRIES].to_numpy(float), want[["D"] + COUNTRIES].to_numpy(float),
                                   **MAP_TOL)
    row = got.iloc[0]
    assert row["D"] == pytest.approx(float(np.median([row[c] for c in COUNTRIES])), rel=1e-6)


def test_unreadable_group_is_skipped_and_device_errors_raise(computed, tmp_path, monkeypatch):
    """A group with an unreadable artifact is reported and skipped (the
    reference's behaviour); an error of the score map itself raises."""
    import shutil

    _, _, typ_path, ds, _, _ = computed
    tree = str(tmp_path / "tree")
    shutil.copytree(typ_path, tree)
    p = ParallelCluster(tree, ds, str(tmp_path / "p"), kx=8, ky=8, device="cpu")
    bad = p.parallel[COUNTRIES[0]][0][0][0]
    with open(p.D[COUNTRIES[0]].get_path(bad), "wb") as f:
        f.write(b"not an array")
    df, _ = p.df_PD(k_per_image=2)
    assert len(df) == 2 * 3 and bad not in set(df["path_" + COUNTRIES[0]])
    monkeypatch.setattr(p, "_score_map", lambda *a: (_ for _ in ()).throw(RuntimeError("CUDA error")))
    with pytest.raises(RuntimeError, match="CUDA error"):
        p.df_PD(k_per_image=2)


def test_dift_clip_and_concat_embeddings_match_jax(computed, tmp_path):
    vision = CLIPVisionModel(TINY_CLIP_VISION)
    vp = vision.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, vp), "clip_vision")
    j, p = _clusters(computed, tmp_path, j={"clip_bundle": {"config": TINY_CLIP_VISION, "params": vp}},
                     p={"clip_bundle": {"config": pclip.TINY_CLIP_VISION, "state_dict": sd}})
    df, _ = p.df_PD(k_per_image=1)
    dim = TINY_CLIP_VISION.projection_dim
    out = {}
    for fw in ("dift-161", "clip", "clip+dift-161"):
        got = p.compute_embeddings(df.iloc[:2], feature_which=fw)
        want = j.compute_embeddings(df.iloc[:2], feature_which=fw)
        assert got[1] == want[1]  # ids
        for g, w in zip(got[0], want[0]):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, **TOL)
        out[fw] = got[0]
    assert all(x.shape == (dim * len(COUNTRIES),) for x in out["clip"])
    np.testing.assert_allclose(np.linalg.norm(out["clip"][0][:dim]), 1.0, rtol=1e-5)
    for c, d, cd in zip(out["clip"], out["dift-161"], out["clip+dift-161"]):
        np.testing.assert_array_equal(cd, np.concatenate([c, d]))  # [clip | dift], both from the cache


def test_clustering_matches_jax(computed, tmp_path, monkeypatch):
    """clustering() end to end (PCA compression, the argmax centres): with
    both k-means from JAX's k-means++ draws, the same ranked clusters with
    the same members in the same order, scores equal; figures written."""
    j, p = _clusters(computed, tmp_path)
    calls = itertools.count()

    def jax_init(generator, x, k):
        key = jax.random.fold_in(jax.random.PRNGKey(10), next(calls) % 10)
        return _t(np.asarray(jkm.kmeanspp_init(key, jnp.asarray(x.numpy()), k)))

    monkeypatch.setattr(pkm, "kmeanspp_init", jax_init)
    kw = dict(feature_which="dift-161", k_per_image=2, k=8, num_clusters=2, num_components=2)
    want, got = j.clustering(**kw), p.clustering(**kw)
    assert len(got) == 2 and got[0][1] >= got[1][1]
    assert [[m[2] for m in ms] for ms, _ in got] == [[m[2] for m in ms] for ms, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], **MAP_TOL)
    assert got[0][0][0][0].width >= 8 * len(COUNTRIES)  # one crop per country side by side
    figs = str(tmp_path / "figs")
    p.make_figure(figs, k=8, num_clusters=2, min_im=1, feature_which="dift-161")
    assert os.listdir(join(figs, "clusters", "ranked", "dift-161", "2"))


def test_cli_figures_only_aliases_and_mesh_dp(tmp_path, monkeypatch):
    """--figures_only regenerates figures without clustering, the compute
    CLI's -i alias parses, and --mesh_dp 2 outside a process group names
    torchrun."""
    os.makedirs(tmp_path / "data" / "France")
    called = []
    monkeypatch.setattr(ppar.ParallelCluster, "clustering", lambda *a, **k: called.append("clustering"))
    monkeypatch.setattr(ppar.ParallelCluster, "make_figure", lambda *a, **k: called.append("figure"))
    common = ["-i", str(tmp_path / "data"), "-t", str(tmp_path / "typ"), "-c", str(tmp_path / "cache")]
    ppar.main([*common, "--cluster", "--figures_only", "--figure_path", str(tmp_path / "figs"), "--device", "cpu"])
    assert called == ["figure"]
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node 2"):
        ppar.main([*common, "--cluster", "--mesh_dp", "2", "--device", "cpu"])


def test_parallel_cli_on_the_cpu(computed, tmp_path):
    """python -m diffmining_tpu_torch parallel --cluster ... --device cpu
    over the swept tree and the pipeline dir."""
    from diffmining_tpu_torch.__main__ import main as cli

    _, _, typ_path, ds, pipe, _ = computed
    cache, figs = str(tmp_path / "cache"), str(tmp_path / "figs")
    cli(["parallel", "-i", ds, "-t", typ_path, "-c", cache, "-m", pipe, "--cluster", "--k", "8", "--num_images", "8",
         "--num_clusters", "2", "--num_components", "2", "--figure_path", figs, "--min_row", "1",
         "--dtype", "fp32", "--device", "cpu"])
    crops = os.listdir(join(cache, "images", "clusters", "8", "2", "ranked", "dift-161"))
    assert len(crops) == 2 * 2 * 2 and len(os.listdir(join(cache, "embeddings", "dift-161"))) == 8
    assert os.listdir(join(figs, "clusters", "ranked", "dift-161", "2"))
