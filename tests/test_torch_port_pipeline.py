"""The port's typicality slice end to end on the CPU, held to the JAX
package: pipeline-dir loading through the port's own safetensors reader,
the sweep's artifacts against the JAX sweep's on the same checkpoint with
the JAX draws injected, the cluster-rank oracle over both trees, the CLI,
and the port's isolation from JAX.

This is tests/test_verify_checkpoint.py:136 (test_cluster_rank_cross_
framework) with the port in the torch oracle's place. Both sweeps run in
float32; artifacts are fp16, whose ulp is ~1e-3 relative, hence rtol=2e-3.
"""
import json
import os
import re
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffmining_tpu.typicality.compute import SD as JSD
from diffmining_tpu.typicality.compute import Typicality as JTypicality
from diffmining_tpu.typicality.engine import TypicalityEngine as JEngine
from diffmining_tpu.typicality.engine import sample_noise_and_t
from diffmining_tpu.typicality.templates import dift_prompt as j_dift_prompt
from diffmining_tpu.typicality.templates import typicality_prompt as j_typicality_prompt
from diffmining_tpu.utils.export import save_pipeline_dir
from diffmining_tpu.utils.images import image_uid as j_image_uid

import diffmining_tpu_torch
from diffmining_tpu_torch.typicality.compute import SD, Typicality
from diffmining_tpu_torch.typicality.compute import main as port_main
from diffmining_tpu_torch.typicality.templates import dift_prompt, typicality_prompt
from diffmining_tpu_torch.utils.images import image_uid
from diffmining_tpu_torch.utils.weights import params_from_jax, read_safetensors, read_safetensors_dir

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED, N, T_MIN, T_MAX = 42, 4, 0.1, 0.7


@pytest.fixture(scope="module")
def pipeline_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("pipe"))
    sd = JSD.init_tiny("ftt", ["1920"])
    save_pipeline_dir(
        out,
        sd.unet.config, jax.device_get(sd.unet_params),
        sd.vae.config, jax.device_get(sd.vae_params),
        sd.clip.config, jax.device_get(sd.clip_params),
        sd.schedule,
    )
    return out, sd


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """ftt layout: three 32px images in one decade and two 64px in another.
    TINY_VAE halves the size, so the 64px latents are 32x32 and the UNet's
    level-0 self-attention runs at L=1024, the kernel's gated length."""
    root = tmp_path_factory.mktemp("data") / "ftt"
    rng = np.random.RandomState(3)
    for decade, px, n in (("1920", 32, 3), ("1960", 64, 2)):
        os.makedirs(root / decade)
        for i in range(n):
            Image.fromarray(rng.randint(0, 255, (px, px, 3), dtype=np.uint8)).save(root / decade / f"f{i}.png")
    return str(root)


def test_safetensors_reader_matches_library(pipeline_dir, tmp_path):
    from safetensors.numpy import load_file

    out, _ = pipeline_dir
    for sub in ("unet", "vae", "text_encoder"):
        d = os.path.join(out, sub)
        for name in os.listdir(d):
            if name.endswith(".safetensors"):
                want = load_file(os.path.join(d, name))
                got = read_safetensors(os.path.join(d, name))
                assert set(got) == set(want)
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k])
    # a bf16 tensor, written by hand: bits of float32 values with zero low halves
    vals = np.array([[1.5, -2.0, 0.0078125], [3.0, -0.5, 65536.0]], np.float32)
    bits = (vals.view(np.uint32) >> 16).astype("<u2").tobytes()
    header = json.dumps({"w": {"dtype": "BF16", "shape": [2, 3], "data_offsets": [0, len(bits)]}}).encode()
    path = tmp_path / "bf16.safetensors"
    path.write_bytes(struct.pack("<Q", len(header)) + header + bits)
    np.testing.assert_array_equal(read_safetensors(str(path))["w"], vals)


def test_pipeline_dir_loads_into_the_port(pipeline_dir):
    """Every tensor of the exported dir lands in the port's modules (load_state
    raises on a missing or unexpected key; the VAE decoder is set aside), the
    schedule comes from scheduler_config.json, and the weights equal the JAX
    tree carried by params_from_jax."""
    out, jsd = pipeline_dir
    sd = SD.from_pipeline_dir("ftt", out, ["1920"], dtype=torch.float32, device="cpu")
    np.testing.assert_allclose(sd.schedule.alphas_cumprod.numpy(), np.asarray(jsd.schedule.alphas_cumprod), rtol=1e-6)
    carried = params_from_jax(jax.tree_util.tree_map(np.asarray, jsd.unet_params), "unet")
    own = sd.unet.state_dict()
    assert set(own) == set(carried)
    for k in own:
        torch.testing.assert_close(own[k], carried[k], rtol=0, atol=0)
    assert set(read_safetensors_dir(os.path.join(out, "text_encoder"))) == set(sd.clip.state_dict())


def _jax_draws(uid, latent_shape):
    """The JAX sweep's exact draws for one image, in the port's NCHW layout:
    the VAE posterior eps from fold_in(fold_in(PRNGKey(seed), 7), uid) and
    (eps, t) from sample_noise_and_t(engine.image_key(uid), ...)."""
    c, h, w = latent_shape
    vae_key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(SEED), 7), uid)
    post = np.asarray(jax.random.normal(vae_key, (h, w, c), dtype=jnp.float32)).transpose(2, 0, 1)
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), uid)
    noise, t = sample_noise_and_t(key, N, (h, w, c), T_MIN, T_MAX)
    return (torch.from_numpy(np.ascontiguousarray(post)),
            torch.from_numpy(np.ascontiguousarray(np.asarray(noise).transpose(0, 3, 1, 2))),
            torch.from_numpy(np.array(t)).long())


def test_image_key_is_the_engine_key():
    """_jax_draws rebuilds the JAX engine's per-image key by hand."""
    eng = JEngine(unet=None, unet_params={}, schedule=None, seed=SEED, cast_params=False)
    np.testing.assert_array_equal(np.asarray(eng.image_key(123)),
                                  np.asarray(jax.random.fold_in(jax.random.PRNGKey(SEED), 123)))


@pytest.fixture(scope="module")
def swept_trees(pipeline_dir, dataset, tmp_path_factory):
    out, _ = pipeline_dir
    root = tmp_path_factory.mktemp("trees")
    jax_tree, port_tree, subs = str(root / "jax"), str(root / "port"), str(root / "subs")
    jtyp = JTypicality("ftt", out, dataset, jax_tree, N=N, t_min=T_MIN, t_max=T_MAX,
                       batch_images=3, dtype=jnp.float32)
    for c in jtyp.categories():
        jtyp.D[c].compute_batch([(s, c) for s in jtyp.get_seeds_(c)])
    ptyp = Typicality("ftt", out, dataset, port_tree, N=N, t_min=T_MIN, t_max=T_MAX,
                      batch_images=3, dtype=torch.float32, device="cpu", draws=_jax_draws)
    ptyp.make_submission(dataset, subs, sub_split=1)
    ptyp.compute_submission(os.path.join(subs, "0.txt"))
    return jax_tree, port_tree


def test_port_sweep_reproduces_jax_artifacts(swept_trees, dataset):
    jax_tree, port_tree = swept_trees
    n = 0
    for decade, px in (("1920", 32), ("1960", 64)):
        for name in sorted(os.listdir(os.path.join(dataset, decade))):
            npy = name.replace(".png", ".npy")
            want = np.load(os.path.join(jax_tree, decade, npy))
            got = np.load(os.path.join(port_tree, decade, npy))
            assert got.shape == want.shape == (N, 2, 4, px // 2, px // 2)
            assert got.dtype == np.float16
            np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), rtol=2e-3, atol=1e-4)
            n += 1
    assert n == 5


def test_port_tree_passes_the_cluster_rank_oracle(pipeline_dir, dataset, swept_trees, tmp_path):
    from diffmining_tpu.utils.verify_checkpoint import cluster_rank_correlation

    out, _ = pipeline_dir
    jax_tree, port_tree = swept_trees
    per_cat = cluster_rank_correlation(
        out, dataset, "ftt", ours_tree=jax_tree, theirs_tree=port_tree,
        num_clusters=7, patch=16, cache_path=str(tmp_path / "rank"),
    )
    assert per_cat, "expected at least one category"
    assert all(v > 0.95 for v in per_cat.values()), per_cat


def test_cli_make_submission_then_compute(pipeline_dir, dataset, tmp_path):
    """python -m diffmining_tpu_torch typicality ... on the CPU: the shard
    file lists every image and the split's artifacts come out in the
    reference layout."""
    from diffmining_tpu_torch.__main__ import main as cli

    out, _ = pipeline_dir
    tree, subs = str(tmp_path / "tree"), str(tmp_path / "subs")
    cli(["typicality", "--which", "ftt", "-i", dataset, "-c", tree, "-s", subs, "-m", out,
         "--make_submission", "--N", "2", "--batch_images", "2", "--dtype", "fp32", "--device", "cpu"])
    with open(os.path.join(subs, "0.txt")) as f:
        assert len(f.read().split()) == 5
    a = np.load(os.path.join(tree, "1960", "f0.npy"))
    assert a.shape == (2, 2, 4, 32, 32) and a.dtype == np.float16 and np.isfinite(a).all()


def test_cli_rejects_a_model_path_without_model_index(dataset, tmp_path):
    with pytest.raises(SystemExit, match="model_index.json"):
        port_main(["--which", "ftt", "-i", dataset, "-c", str(tmp_path / "t"), "-s", str(tmp_path / "s"),
                   "-m", str(tmp_path), "--device", "cpu"])


def test_entry_points_default_to_cuda(pipeline_dir):
    """Without a GPU the default device raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out, _ = pipeline_dir
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SD.from_pipeline_dir("ftt", out, ["1920"])


@pytest.mark.parametrize("path", ["/a/b/f0.png", "x.jpg", "gt--Japan__123__4.jpg", "dir/naïve café.JPG", ""])
def test_image_uid_equals_jax(path):
    assert image_uid(path) == j_image_uid(path)


@pytest.mark.parametrize("which", ["ftt", "faces", "cars", "places", "geo"])
def test_templates_equal_jax(which):
    for c in ("", "1920", "living_room"):
        assert typicality_prompt(which, c) == j_typicality_prompt(which, c)
        for swapped in (True, False):
            assert dift_prompt(which, c, swapped) == j_dift_prompt(which, c, swapped)


def _port_sources():
    pkg = os.path.dirname(diffmining_tpu_torch.__file__)
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py")]
    return files + [os.path.join(ROOT, "chip_smoke.py")]


def test_port_sources_import_no_jax():
    bad = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|diffmining_tpu)(\.|\s|$)", re.M)
    for path in _port_sources():
        with open(path, encoding="utf-8") as f:
            assert not bad.search(f.read()), path


def test_port_imports_with_jax_blocked():
    """Every module of the port, and chip_smoke.py, imports in a process
    where jax and diffmining_tpu cannot be imported."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'flax', 'diffmining_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import diffmining_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'diffmining_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "print(len(names))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 15
