"""The port's verify_checkpoint (utils/verify_checkpoint.py) on a tiny
pipeline dir that the JAX package's ``save_pipeline_dir`` writes from
``SD.init_tiny``, on the CPU.

A clean export passes convert, structure, forward and the probes, which the
JAX package records (its models' activations on the same weights: the port
must meet them within the command's own gate, max|Δ| < 5e-2 and pearson >
0.999); the JAX command passes on the same dir and probes. A renamed key and
a transposed tensor fail the structure stage (and the command exits 1).
``--torch_oracle`` passes: the checkpoint's raw UNet tensors in the port's
copy of the hand transcription against the port's UNet, and the text tower
against transformers, which prints SKIP where transformers is absent. With
``--theirs`` a reference tree swept from the same checkpoint passes the
fidelity and cluster-rank stages at 1.0.
"""
import os
import shutil
import sys
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffmining_tpu.diffusion.schedule import add_noise as jadd_noise
from diffmining_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from diffmining_tpu.typicality.compute import SD as JSD
from diffmining_tpu.utils.export import save_pipeline_dir
from diffmining_tpu.utils.verify_checkpoint import main as jax_verify

from diffmining_tpu_torch.__main__ import main as port_main
from diffmining_tpu_torch.utils import verify_checkpoint as pv
from diffmining_tpu_torch.utils.weights import read_safetensors, write_safetensors

import torch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("pipe"))
    sd = JSD.init_tiny("cars", ["1920"])
    save_pipeline_dir(out, sd.unet.config, jax.device_get(sd.unet_params), sd.vae.config,
                      jax.device_get(sd.vae_params), sd.clip.config, jax.device_get(sd.clip_params), sd.schedule)
    return out, sd


@pytest.fixture(scope="module")
def probes(pipeline, tmp_path_factory):
    """The JAX package's activations on the dir's weights, in the NCHW
    probe contract (as tests/test_verify_checkpoint.py records them)."""
    _, sd = pipeline
    image = np.tanh(np.random.RandomState(0).randn(32, 32, 3)).astype(np.float32)
    prompt = "A car at the 1920s."
    hidden = np.asarray(sd.clip.apply(sd.clip_params, jnp.asarray(sd.tokenizer([prompt]))))[0]
    mean = np.asarray(sd.vae.apply(sd.vae_params, jnp.asarray(image)[None], method=JAutoencoderKL.encode)[0])[0]
    lat = jnp.asarray(mean)[None] * sd.vae.config.scaling_factor
    noisy = jadd_noise(sd.schedule, lat, jnp.zeros_like(lat), jnp.asarray([261]))
    eps = np.asarray(sd.unet.apply(sd.unet_params, noisy, jnp.asarray([261], jnp.int32), jnp.asarray(hidden)[None]))[0]
    path = str(tmp_path_factory.mktemp("probes") / "probes.npz")
    np.savez(path, image=image, prompt=np.asarray(prompt), t=np.asarray(261), text_hidden=hidden,
             vae_mean=mean.transpose(2, 0, 1), unet_eps=eps.transpose(2, 0, 1))
    return path


def _lines(capsys):
    return capsys.readouterr().out.splitlines()


def test_clean_export_passes_with_jax_probes(pipeline, probes, capsys):
    out, _ = pipeline
    assert pv.main([out, "--probes", probes, "--device", "cpu"]) == 0
    lines = _lines(capsys)
    for stage in ("[convert] PASS", "[structure:unet] PASS", "[structure:vae] PASS",
                  "[structure:text_encoder] PASS", "[forward] PASS", "[probe:text_hidden] PASS",
                  "[probe:vae_mean] PASS", "[probe:unet_eps] PASS"):
        assert any(line.startswith(stage) for line in lines), (stage, lines)
    assert lines[-1] == "verify_checkpoint: PASS"
    assert jax_verify([out, "--probes", probes]) == 0  # the same dir and probes pass the JAX command


def _corrupt(src, dst, edit):
    shutil.copytree(src, dst)
    path = join(dst, "unet", "diffusion_pytorch_model.safetensors")
    tensors = read_safetensors(path)
    edit(tensors)
    write_safetensors(path, tensors)
    return dst


def test_renamed_key_fails_structure(pipeline, tmp_path, capsys):
    out, _ = pipeline

    def rename(t):
        t["conv_in.weights"] = t.pop("conv_in.weight")

    bad = _corrupt(out, str(tmp_path / "renamed"), rename)
    assert pv.main([bad, "--device", "cpu"]) == 1
    lines = _lines(capsys)
    assert "[structure:unet] FAIL" in "\n".join(lines)
    assert any("missing from checkpoint: conv_in.weight" in line for line in lines)
    assert any("unexpected in checkpoint: conv_in.weights" in line for line in lines)
    assert any(line.startswith("[forward] FAIL") for line in lines)
    assert lines[-1] == "verify_checkpoint: FAIL"


def test_transposed_tensor_fails_structure(pipeline, tmp_path, capsys):
    out, _ = pipeline
    names = []

    def transpose(t):
        name = next(k for k, v in sorted(t.items()) if v.ndim == 2 and v.shape[0] != v.shape[1])
        t[name] = np.ascontiguousarray(t[name].T)
        names.append(name)

    bad = _corrupt(out, str(tmp_path / "transposed"), transpose)
    with pytest.raises(SystemExit) as e:
        port_main(["verify_checkpoint", bad, "--device", "cpu"])
    assert e.value.code == 1
    lines = _lines(capsys)
    assert any(line.startswith(f"    shape mismatch {names[0]}") for line in lines), lines
    assert "[structure:unet] FAIL" in "\n".join(lines)


def test_torch_oracle_stage(pipeline, capsys):
    out, _ = pipeline
    with pytest.raises(SystemExit) as e:
        port_main(["verify_checkpoint", out, "--torch_oracle", "--device", "cpu"])
    assert e.value.code == 0
    lines = _lines(capsys)
    assert any(line.startswith("[torch_oracle] PASS") for line in lines), lines
    text = [line for line in lines if line.startswith("[torch_oracle:text]")]
    assert len(text) == 1 and (text[0].startswith("[torch_oracle:text] PASS") or "SKIP" in text[0])


def test_torch_oracle_text_stage_skips_without_transformers(pipeline, monkeypatch, capsys):
    out, _ = pipeline
    monkeypatch.setitem(sys.modules, "transformers", None)  # import raises ImportError
    assert pv.main([out, "--torch_oracle", "--device", "cpu"]) == 0
    lines = _lines(capsys)
    assert "[torch_oracle:text] SKIP (transformers not installed)" in lines
    assert any(line.startswith("[torch_oracle] PASS") for line in lines)


def test_verify_defaults_to_the_card(pipeline, monkeypatch):
    out, _ = pipeline
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pv.main([out])


def test_fidelity_and_cluster_rank_stages_against_the_same_checkpoint(pipeline, tmp_path, capsys):
    """--theirs: a reference tree swept by the port from the same checkpoint
    (bitwise-equal trees by determinism) gives map correlation 1 and cluster
    rank spearman 1 (the JAX package's self-consistency anchor, its
    tests/test_verify_checkpoint.py stage 6 test, here on 3 images)."""
    from PIL import Image

    from diffmining_tpu_torch.typicality.compute import Typicality

    out, _ = pipeline
    data = tmp_path / "ftt"
    os.makedirs(data / "1920")
    rng = np.random.RandomState(3)
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (64, 64, 3), dtype=np.uint8)).save(data / "1920" / f"f{i}.jpg")
    theirs = str(tmp_path / "theirs")
    typ = Typicality("ftt", out, str(data), theirs, N=4, t_min=0.1, t_max=0.7, dtype=torch.float32, device="cpu")
    for c in typ.categories():
        typ.D[c].compute_batch([(s, c) for s in typ.get_seeds_(c)])
    rc = pv.main([out, "--which", "ftt", "--dataset", str(data), "--theirs", theirs, "--n_samples", "4",
                  "--sweep_images", "2", "--rank_images", "3", "--rank_clusters", "4", "--rank_patch", "16",
                  "--device", "cpu"])
    lines = _lines(capsys)
    assert rc == 0, lines
    assert any(line.startswith("[fidelity] PASS mean map correlation 1.0000") for line in lines), lines
    assert any(line.startswith("[cluster_rank] PASS mean spearman 1.0000") for line in lines), lines
