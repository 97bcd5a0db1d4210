"""The cars domain through the port on the CPU, held to the JAX package: the
layout (a folder of images beside ``<folder>.json`` with a year per image),
images of two aspect ratios, the domain's short-side-256 rescale, the
same-shape groups of ``compute_batch`` and the sweep's artifacts with the
JAX draws injected; and the three names the tiny example needs,
``SD.init_tiny``, ``D.compute`` and ``get_country``.

The sweep keeps each image's own size (``native_res``): at the cars rule's
256 px the tiny stack's level-0 attention would be L = 24576, too long for
the CPU. 64x96 and 64x128 px give latents of 32x48 and 32x64 (TINY_VAE
halves), so the level-0 self-attention runs at L = 1536 and 2048, the
lengths of the free-aspect sweep on the card. Both sweeps run in float32;
artifacts are fp16, hence rtol 2e-3 and atol 1e-4, as in
tests/test_torch_port_pipeline.py."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffmining_tpu.typicality import compute as jcompute
from diffmining_tpu.typicality.engine import sample_noise_and_t
from diffmining_tpu.utils.export import save_pipeline_dir as j_save_pipeline_dir
from diffmining_tpu.utils.images import load_image as j_load_image

from diffmining_tpu_torch.typicality import compute as pcompute
from diffmining_tpu_torch.utils.images import load_image
from diffmining_tpu_torch.utils.weights import params_from_jax

torch.set_num_threads(1)
SEED, N, T_MIN, T_MAX = 42, 3, 0.1, 0.7
# (name, year, H, W): two decades, both aspect ratios in each, groups of unequal size
CARS = [("a1.png", 1955, 64, 96), ("a2.png", 1957, 64, 128), ("a3.png", 1951, 64, 96),
        ("b1.png", 1987, 64, 128), ("b2.png", 1983, 64, 128), ("b3.png", 1989, 64, 96)]


@pytest.fixture(scope="module")
def jax_tiny():
    return jcompute.SD.init_tiny("cars", ["1950", "1980"])


@pytest.fixture(scope="module")
def pipeline_dir(jax_tiny, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("pipe"))
    sd = jax_tiny
    j_save_pipeline_dir(out, sd.unet.config, jax.device_get(sd.unet_params), sd.vae.config,
                        jax.device_get(sd.vae_params), sd.clip.config, jax.device_get(sd.clip_params), sd.schedule)
    return out


@pytest.fixture(scope="module")
def cars(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    folder = root / "cars"
    os.makedirs(folder)
    rng = np.random.RandomState(11)
    for name, _year, h, w in CARS:
        Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(folder / name)
    with open(str(folder) + ".json", "w") as f:
        json.dump({name: {"year": year} for name, year, _h, _w in CARS}, f)
    return str(folder)


def _jax_draws(uid, latent_shape):
    """The JAX sweep's draws for one image in the port's NCHW layout (as in
    tests/test_torch_port_pipeline.py)."""
    c, h, w = latent_shape
    vae_key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(SEED), 7), uid)
    post = np.asarray(jax.random.normal(vae_key, (h, w, c), dtype=jnp.float32)).transpose(2, 0, 1)
    noise, t = sample_noise_and_t(jax.random.fold_in(jax.random.PRNGKey(SEED), uid), N, (h, w, c), T_MIN, T_MAX)
    return (torch.from_numpy(np.ascontiguousarray(post)),
            torch.from_numpy(np.ascontiguousarray(np.asarray(noise).transpose(0, 3, 1, 2))),
            torch.from_numpy(np.array(t)).long())


def test_cars_layout_equals_jax(cars, pipeline_dir):
    j = jcompute.Typicality("cars", None, cars, "unused")
    p = pcompute.Typicality("cars", None, cars, "unused", device="cpu")
    assert p.categories() == j.categories() == ["1950", "1980"]
    for c in p.categories():
        assert p.get_seeds_(c) == j.get_seeds_(c)
        assert len(p.get_seeds_(c)) == 3


@pytest.mark.parametrize("name", ["a1.png", "a2.png"])
def test_cars_rescale_equals_jax(cars, name):
    """The cars rule: short side 256, the long side free (384 and 512 here)."""
    got, _ = load_image(os.path.join(cars, name), "cars")
    want, _ = j_load_image(os.path.join(cars, name), "cars")
    assert got.shape == want.shape == ((256, 384, 3) if name == "a1.png" else (256, 512, 3))
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def swept(cars, pipeline_dir, tmp_path_factory):
    """Both packages sweep every category at native size, batch_images 2,
    with a spy on each one's group dispatch."""
    root = tmp_path_factory.mktemp("trees")
    groups = {"jax": [], "port": []}

    def spy(cls, key):
        original = cls._dispatch_group

        def dispatch(self, group):
            groups[key].append([os.path.basename(g[0]) for g in group])
            return original(self, group)

        return original, dispatch

    j_orig, j_spy = spy(jcompute.D, "jax")
    p_orig, p_spy = spy(pcompute.D, "port")
    jcompute.D._dispatch_group, pcompute.D._dispatch_group = j_spy, p_spy
    try:
        jt = jcompute.Typicality("cars", pipeline_dir, cars, str(root / "jax"), t_min=T_MIN, t_max=T_MAX, N=N,
                                 batch_images=2, native_res=True, dtype=jnp.float32)
        for c in jt.categories():
            jt.D[c].compute_batch([(s, c) for s in jt.get_seeds_(c)])
        pt = pcompute.Typicality("cars", pipeline_dir, cars, str(root / "port"), t_min=T_MIN, t_max=T_MAX, N=N,
                                 batch_images=2, native_res=True, dtype=torch.float32, device="cpu",
                                 draws=_jax_draws)
        for c in pt.categories():
            pt.D[c].compute_batch([(s, c) for s in pt.get_seeds_(c)])
    finally:
        jcompute.D._dispatch_group, pcompute.D._dispatch_group = j_orig, p_orig
    return str(root / "jax"), str(root / "port"), groups


def test_same_shape_groups_equal_jax(swept):
    _, _, groups = swept
    assert groups["port"] == groups["jax"]
    # per category: the 64x96 pair (or the 64x128 pair) as one group, the odd image alone
    assert sorted(map(len, groups["port"])) == [1, 1, 2, 2]


@pytest.mark.parametrize("name,year,h,w", CARS)
def test_cars_sweep_equals_jax(swept, name, year, h, w):
    jax_tree, port_tree, _ = swept
    decade = str(year // 10 * 10)
    npy = name.replace(".png", ".npy")
    want = np.load(os.path.join(jax_tree, decade, npy))
    got = np.load(os.path.join(port_tree, decade, npy))
    assert got.shape == want.shape == (N, 2, 4, h // 2, w // 2)
    assert got.dtype == np.float16
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), rtol=2e-3, atol=1e-4)


def test_d_compute_equals_jax(cars, pipeline_dir, tmp_path):
    """D.compute(country, path) is one item through compute_batch in both."""
    jsd = jcompute.SD.from_pipeline_dir("cars", pipeline_dir, ["1950"], dtype=jnp.float32)
    psd = pcompute.SD.from_pipeline_dir("cars", pipeline_dir, ["1950"], dtype=torch.float32, device="cpu")
    path = os.path.join(cars, "a2.png")
    jd = jcompute.D(jsd, str(tmp_path / "j"), which="cars", seed=SEED, N=N, t_min=T_MIN, t_max=T_MAX,
                    native_res=True)
    pd = pcompute.D(psd, str(tmp_path / "p"), which="cars", seed=SEED, N=N, t_min=T_MIN, t_max=T_MAX,
                    native_res=True, draws=_jax_draws)
    jd.compute("1950", path)
    pd.compute("1950", path)
    assert pd.exists(path) and jd.exists(path)
    got, want = pd(path), jd(path)
    assert got.shape == want.shape == (N, 2, 4, 32, 64) and got.dtype == np.float16
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), rtol=2e-3, atol=1e-4)


def test_init_tiny_matches_jax(jax_tiny):
    """The tiny stack: the same configs, float32, the same parameter names and
    shapes (the weights are drawn differently), the same schedule and the
    prompt embeddings of every category and the null prompt."""
    p = pcompute.SD.init_tiny("cars", ["1950", "1980"], device="cpu")
    j = jax_tiny
    for mod, model in ((p.unet, "unet"), (p.vae, "vae"), (p.clip, "clip_text")):
        assert all(t.dtype == torch.float32 and t.device.type == "cpu" for t in mod.state_dict().values())
        tree = {"unet": j.unet_params, "vae": j.vae_params, "clip_text": j.clip_params}[model]
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, tree), model)
        own = mod.state_dict()
        assert set(own) == set(want), model
        assert all(tuple(own[k].shape) == tuple(want[k].shape) for k in own), model
    for a, b in ((p.unet.config, j.unet.config), (p.vae.config, j.vae.config), (p.clip.config, j.clip.config)):
        for field in ("block_out_channels", "layers_per_block", "norm_num_groups", "hidden_size", "num_layers",
                      "vocab_size", "cross_attention_dim", "latent_channels"):
            assert getattr(a, field, None) == getattr(b, field, None), field
    np.testing.assert_allclose(p.schedule.alphas_cumprod.numpy(), np.asarray(j.schedule.alphas_cumprod), rtol=1e-6)
    assert sorted(p.country_embeds) == sorted(j.country_embeds) == ["", "1950", "1980"]
    assert all(tuple(p.country_embeds[c].shape) == tuple(np.shape(j.country_embeds[c])) for c in p.country_embeds)
    assert p.dtype == torch.float32 and p.tokenizer(["a car"]).shape == j.tokenizer(["a car"]).shape
    # seeded: the same seed gives the same weights, another seed others
    again = pcompute.SD.init_tiny("cars", [], device="cpu")
    other = pcompute.SD.init_tiny("cars", [], seed=1, device="cpu")
    w = "conv_in.weight"
    assert torch.equal(again.unet.state_dict()[w], p.unet.state_dict()[w])
    assert not torch.equal(other.unet.state_dict()[w], p.unet.state_dict()[w])


@pytest.mark.parametrize("path", ["gt--France__a1_0.jpg", "/data/parallel/France/Japan__b2_0.jpg",
                                  "inverted--United States__12_3.png", "projected--Brazil__x_1.jpg",
                                  "Japan.jpg", "dir/gt--South Korea__7__2.png", ""])
def test_get_country_equals_jax(path):
    assert pcompute.get_country(path) == jcompute.get_country(path)
