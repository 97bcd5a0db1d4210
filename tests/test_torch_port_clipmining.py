"""The port's CLIP-mining baseline (baselines/clipmining.py) held to the JAX
package's on the CPU, with the tiny towers carried across: the crop and the
resize matrices (equal, or rtol 1e-6), the pooled score maps (rtol 1e-5,
atol 1e-6), the mined boxes (equal), the box embeddings and scores (rtol
1e-3, atol 2e-4: the towers' framework-to-framework bound) on both scoring
paths, the device path against the host path (as tests/test_clipmining.py),
the batched encode, ``clustering`` end to end (both k-means starting from
JAX's k-means++ draws: the same ranked clusters) and the ``clipmining``
command with --device cpu.
"""
import itertools
import json
import os
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffmining_tpu.baselines import clipmining as jcm
from diffmining_tpu.models import clip as jclip
from diffmining_tpu.models.tokenizer import tiny_tokenizer as jtiny_tokenizer
from diffmining_tpu.ops import kmeans as jkm

from diffmining_tpu_torch.baselines import clipmining as pcm
from diffmining_tpu_torch.models import clip as pclip
from diffmining_tpu_torch.models.tokenizer import tiny_tokenizer
from diffmining_tpu_torch.ops import kmeans as pkm
from diffmining_tpu_torch.utils.weights import load_state, params_from_jax, write_safetensors

torch.set_num_threads(1)
TOL = dict(rtol=1e-3, atol=2e-4)
MAP_TOL = dict(rtol=1e-5, atol=1e-6)
COUNTRIES = ["France", "Japan"]
K = 16  # box side at the tiny 64 px crop


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def geo_dataset(tmp_path_factory):
    """2 countries x 3 ground-truth images (72x64: resized and centre-cropped
    to 64) and one translated file per country, which the ranker skips."""
    root = tmp_path_factory.mktemp("geo")
    rng = np.random.RandomState(0)
    for country in COUNTRIES:
        os.makedirs(join(root, country))
        for i in range(3):
            arr = rng.randint(0, 255, (64, 72, 3), dtype=np.uint8)
            Image.fromarray(arr).save(join(root, country, f"gt--{country}__{i}.png"))
        Image.fromarray(rng.randint(0, 255, (64, 64, 3), dtype=np.uint8)).save(join(root, country, f"Italy__0.png"))
    return str(root)


@pytest.fixture(scope="module")
def towers():
    vision = jclip.CLIPVisionModel(jclip.TINY_CLIP_VISION)
    vp = vision.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    text = jclip.CLIPTextModelWithProjection(jclip.TINY_CLIP_TEXT, projection_dim=16)
    tp = text.init(jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32))
    return vision, vp, text, tp


def _port_towers(towers):
    _, vp, _, tp = towers
    pv = pclip.CLIPVisionModel(pclip.TINY_CLIP_VISION)
    load_state(pv, params_from_jax(_np(vp), "clip_vision"))
    pt = pclip.CLIPTextModelWithProjection(pclip.TINY_CLIP_TEXT, projection_dim=16)
    load_state(pt, params_from_jax(_np(tp), "clip_text_projection"))
    return pv, pt


def _rankers(geo_dataset, towers, tmp_path_factory, **kw):
    vision, vp, text, tp = towers
    j = jcm.CLIPRankCluster(geo_dataset, str(tmp_path_factory.mktemp("jc")), "diff", vision=vision,
                            vision_params=vp, text=text, text_params=tp,
                            tokenizer=jtiny_tokenizer(jclip.TINY_CLIP_TEXT.vocab_size), crop=64, **kw)
    pv, pt = _port_towers(towers)
    p = pcm.CLIPRankCluster(geo_dataset, str(tmp_path_factory.mktemp("pc")), "diff", vision=pv, text=pt,
                            tokenizer=tiny_tokenizer(pclip.TINY_CLIP_TEXT.vocab_size), crop=64, device="cpu", **kw)
    return j, p


def test_constants_and_crop_equal_jax():
    np.testing.assert_array_equal(pcm.CLIP_MEAN, jcm.CLIP_MEAN)
    np.testing.assert_array_equal(pcm.CLIP_STD, jcm.CLIP_STD)
    rng = np.random.RandomState(1)
    for (w, h), size in [((100, 80), 64), ((64, 64), 64), ((80, 130), 64), ((512, 512), 336), ((300, 224), 224)]:
        img = Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8))
        got, want = pcm.resize_center_crop(img, size), jcm.resize_center_crop(img, size)
        assert got.size == want.size == (size, size) and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n,m", [(24, 336), (7, 224), (8, 64), (12, 96), (5, 5)])
def test_resize_weights_match_jax(n, m):
    """The path's pairs: ViT-L/14 at 336 (24 -> 336), ViT-B/32 at 224 (7 ->
    224), the tiny tower's own, and the identity."""
    got = pcm._resize_weights(n, m)
    assert got.shape == (m, n)
    np.testing.assert_allclose(got, jcm._resize_weights(n, m), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("diff", [True, False])
def test_pooled_maps_and_box_embeds_match_jax(diff):
    rng = np.random.RandomState(2)
    tokens = rng.randn(3, 64, 16).astype(np.float32)
    te = rng.randn(2, 16).astype(np.float32)
    te /= np.linalg.norm(te, axis=-1, keepdims=True)
    want = np.asarray(jcm._pooled_score_maps(jnp.asarray(tokens), jnp.asarray(te), 8, 8, 64, 64, K, K, diff))
    got = pcm._pooled_score_maps(_t(tokens), _t(te), 8, 8, 64, 64, K, K, diff).numpy()
    assert got.shape == (3, 64 - K + 1, 64 - K + 1)
    np.testing.assert_allclose(got, want, **MAP_TOL)
    u = rng.rand(3, 4, 8).astype(np.float32)
    v = rng.rand(3, 4, 8).astype(np.float32)
    want_e = np.asarray(jcm._box_embeds(jnp.asarray(tokens), jnp.asarray(u), jnp.asarray(v), 8, 8))
    np.testing.assert_allclose(pcm._box_embeds(_t(tokens), _t(u), _t(v), 8, 8).numpy(), want_e, **MAP_TOL)


@pytest.mark.parametrize("host", [False, True])
def test_rank_matches_jax(geo_dataset, towers, tmp_path_factory, host):
    """rank() on each scoring path against JAX's on the same path: the same
    rows and boxes, scores and box embeddings within the towers' bound."""
    j, p = _rankers(geo_dataset, towers, tmp_path_factory, host_scoring=host)
    assert p.host_scoring == host and p.crop == 64
    for country in COUNTRIES:
        df_j, emb_j = j.rank(country, k_per_image=3, kx=K, ky=K)
        df_p, emb_p = p.rank(country, k_per_image=3, kx=K, ky=K)
        assert len(df_p) == 9 and df_p.drop(columns=["D"]).equals(df_j.drop(columns=["D"]))
        np.testing.assert_allclose(df_p["D"].to_numpy(), df_j["D"].to_numpy(), **TOL)
        for a, b in zip(emb_p, emb_j):
            np.testing.assert_allclose(a, b, **TOL)
            np.testing.assert_allclose(np.linalg.norm(a), 1.0, rtol=1e-5)


def test_device_path_matches_host_path_and_batching(geo_dataset, towers, tmp_path_factory):
    """The device path reproduces the host path (bilinear resize is linear
    and separable: rtol 1e-4, atol 1e-5, tests/test_clipmining.py's bound);
    batch_images 1 gives what the padded batch of 8 gives; the env flag
    routes rank() through score_map."""
    pv, pt = _port_towers(towers)
    tok = tiny_tokenizer(pclip.TINY_CLIP_TEXT.vocab_size)

    def ranker(**kw):
        return pcm.CLIPRankCluster(geo_dataset, str(tmp_path_factory.mktemp("r")), "diff", vision=pv, text=pt,
                                   tokenizer=tok, crop=64, device="cpu", **kw)

    dev, host, solo = ranker(), ranker(host_scoring=True), ranker(batch_images=1)
    assert not dev.host_scoring and host.host_scoring
    df_d, emb_d = dev.rank("France", k_per_image=3, kx=K, ky=K)
    for other in (host, solo):
        df_o, emb_o = other.rank("France", k_per_image=3, kx=K, ky=K)
        assert df_d.drop(columns=["D"]).equals(df_o.drop(columns=["D"]))
        np.testing.assert_allclose(df_d["D"].to_numpy(), df_o["D"].to_numpy(), rtol=1e-4, atol=1e-5)
        for a, b in zip(emb_d, emb_o):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    old = pcm._HOST_SCORING
    pcm._HOST_SCORING = True
    try:
        flagged = ranker()
    finally:
        pcm._HOST_SCORING = old
    calls = []
    orig = flagged.score_map
    flagged.score_map = lambda *a, **kw: (calls.append(1) or orig(*a, **kw))
    flagged.rank("France", k_per_image=1, kx=K, ky=K)
    assert flagged.host_scoring and calls


def test_clustering_matches_jax(geo_dataset, towers, tmp_path_factory, monkeypatch):
    """clustering() end to end with non-default box sizes (the cache name
    carries them), both k-means from JAX's k-means++ draws (the restart keys
    fold_in(PRNGKey(10), i)): the same ranked clusters with the same
    members, scores within the bound, crops and figures written."""
    j, p = _rankers(geo_dataset, towers, tmp_path_factory)
    calls = itertools.count()

    def jax_init(generator, x, k):
        key = jax.random.fold_in(jax.random.PRNGKey(10), next(calls) % 10)
        return _t(np.asarray(jkm.kmeanspp_init(key, jnp.asarray(x.numpy()), k)))

    monkeypatch.setattr(pkm, "kmeanspp_init", jax_init)
    want = j.clustering(k_per_image=3, k=6, num_clusters=2, kx=K, ky=K)
    got = p.clustering(k_per_image=3, k=6, num_clusters=2, kx=K, ky=K)
    for c in COUNTRIES:
        assert [[m[2] for m in ms] for ms, _ in got[c]] == [[m[2] for m in ms] for ms, _ in want[c]]
        np.testing.assert_allclose([s for _, s in got[c]], [s for _, s in want[c]], **TOL)
        assert os.path.isfile(join(p.cache_path, "dfs", f"{c}__3-{K}-{K}.pkl"))
        assert os.path.isfile(join(p.cache_path, "figures", f"{c}.png"))
        assert sorted(os.listdir(join(p.cache_path, "images", "clusters", c))) == sorted(
            os.listdir(join(j.cache_path, "images", "clusters", c)))
    # a second call reads the cached tables
    again = p.clustering(k_per_image=3, k=6, num_clusters=2, kx=K, ky=K)
    assert [s for _, s in again[COUNTRIES[0]]] == [s for _, s in got[COUNTRIES[0]]]


def test_clipmining_cli_on_the_cpu(geo_dataset, towers, tmp_path, monkeypatch):
    """python -m diffmining_tpu_torch clipmining --clip_dir DIR --device cpu
    over a tiny CLIPModel dir with a tokenizer; the mining constants (k 5,
    32 clusters, 64 px boxes) need more patches than the tiny data has, so
    the command's clustering call is checked for them and run smaller."""
    from diffmining_tpu_torch.__main__ import main as cli

    pv, pt = _port_towers(towers)
    d = str(tmp_path / "clip")
    os.makedirs(d)
    write_safetensors(join(d, "model.safetensors"),
                      {k: v.numpy() for k, v in {**pv.state_dict(), **pt.state_dict()}.items()})
    tv, tt = pclip.TINY_CLIP_VISION, pclip.TINY_CLIP_TEXT
    with open(join(d, "config.json"), "w") as f:
        json.dump({"projection_dim": 16,
                   "vision_config": {"image_size": tv.image_size, "patch_size": tv.patch_size,
                                     "hidden_size": tv.hidden_size, "intermediate_size": tv.intermediate_size,
                                     "num_hidden_layers": tv.num_layers, "num_attention_heads": tv.num_heads},
                   "text_config": {"vocab_size": tt.vocab_size, "hidden_size": tt.hidden_size,
                                   "intermediate_size": tt.intermediate_size, "num_hidden_layers": tt.num_layers,
                                   "num_attention_heads": tt.num_heads}}, f)
    with open(join(d, "vocab.json"), "w") as f:
        json.dump(tiny_tokenizer(tt.vocab_size).encoder, f)
    with open(join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    seen = {}
    orig = pcm.CLIPRankCluster.clustering

    def smaller(self, k_per_image=5, k=1000, num_clusters=32, hard_limit=6, kx=64, ky=64):
        seen.update(k_per_image=k_per_image, k=k, num_clusters=num_clusters, kx=kx, self=self)
        return orig(self, k_per_image=2, k=k, num_clusters=2, hard_limit=hard_limit, kx=K, ky=K)

    monkeypatch.setattr(pcm.CLIPRankCluster, "clustering", smaller)
    cache = str(tmp_path / "cache")
    cli(["clipmining", "--dataset", geo_dataset, "--cache", cache, "--clip_dir", d, "--batch_images", "2",
         "--device", "cpu"])
    rc = seen.pop("self")
    assert seen == dict(k_per_image=5, k=1000, num_clusters=32, kx=64)
    assert rc.device.type == "cpu" and rc.batch_images == 2 and rc.crop == 64
    for c in COUNTRIES:
        assert len(os.listdir(join(cache, "diff", "images", "clusters", c))) == 6
