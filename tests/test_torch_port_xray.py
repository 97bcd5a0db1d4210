"""The port's X-ray localization (applications/xray.py) on the CPU at tiny
widths in float32, held to the JAX package: the helpers (prompts, the blur,
mean typicality, AUC-PR, the halved boxes and their seeded order, the
comparison table, predicted boxes, triplets) on the same inputs, and
``XRayTypicality.main`` end to end on the same checkpoint with the JAX
draws injected (pixel maps, report.json, auc.json), and the ``xray``
command.

Tolerances. Numpy helpers: equal, or rtol 1e-6 for float sums. The blur:
rtol 1e-5 against the numpy oracle. The sweep chain: rtol 2e-3 and atol
1e-4, the sweep pipeline's bound for fp16 loss artifacts, on report.json
and auc.json. A pixel map is a mean of differences of those fp16 losses
over N draws and C latent channels, near zero where cond and null agree:
where the two frameworks' float32 losses round to neighbouring fp16
values, a map element moves by up to one fp16 ulp of the loss over N·C,
with no relative scale to absorb it. The maps' atol is that one-flip bound
for the run's largest loss (9.8e-4 at the largest loss of 24.9; measured
on the CPU: 1.4e-4 on 2 of 4096 elements of one map).
"""
import csv
import json
import os
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffmining_tpu.applications import xray as jxray
from diffmining_tpu.typicality.compute import SD as JSD
from diffmining_tpu.typicality.engine import sample_noise_and_t
from diffmining_tpu.utils.export import save_pipeline_dir as jsave_pipeline_dir

from diffmining_tpu_torch.__main__ import main as port_cli
from diffmining_tpu_torch.applications import xray as pxray
from diffmining_tpu_torch.typicality.compute import SD

torch.set_num_threads(1)
SEED, N = 42, 4
CHAIN = dict(rtol=2e-3, atol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.mark.parametrize("c", ["", "no finding"] + pxray.DISEASES)
def test_prompts_match_jax(c):
    assert pxray.xray_prompt(c) == jxray.xray_prompt(c)
    assert pxray.DISEASES == jxray.DISEASES


@pytest.mark.parametrize("shape,sigma,ksize", [((64, 64), 4.0, 15), ((70, 90), 32.0, 127), ((5, 3), 2.0, 9)])
def test_gaussian_blur_matches_numpy_reference(shape, sigma, ksize):
    dm = np.random.RandomState(1).rand(*shape).astype(np.float32)
    want = jxray.gaussian_blur_np(dm, sigma, ksize)
    np.testing.assert_allclose(pxray.gaussian_blur_np(dm, sigma, ksize), want, rtol=1e-6, atol=1e-7)
    got = pxray.gaussian_blur(dm, sigma, ksize)
    assert got.dtype == dm.dtype and got.shape == dm.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_box_metrics_match_jax(seed):
    rng = np.random.RandomState(seed)
    dm = (rng.randn(48, 40) * 10.0 ** rng.uniform(-6, -1, (48, 40))).astype(np.float32)
    for bbox in [(3, 5, 20, 30), (0, 0, 40, 48), (10, 10, 11, 11)]:
        assert pxray.mean_typicality(bbox, dm) == jxray.mean_typicality(bbox, dm)
        np.testing.assert_allclose(pxray.aucpr(bbox, dm), jxray.aucpr(bbox, dm), rtol=1e-6)
    np.testing.assert_array_equal(pxray.predict_bboxes(dm, 8, 8, 4), jxray.predict_bboxes(dm, 8, 8, 4))
    np.testing.assert_array_equal(pxray.predict_bboxes(dm, 8, 6, 3, ascending=False),
                                  jxray.predict_bboxes(dm, 8, 6, 3, ascending=False))


@pytest.fixture(scope="module")
def xray_dataset(tmp_path_factory):
    """Six 64x64 images and one 48x48 (two shape groups), a findings table
    and a bbox table in the CSV's coordinates (twice the image's)."""
    root = tmp_path_factory.mktemp("cxr")
    os.makedirs(join(root, "images"))
    rng = np.random.RandomState(0)
    rows = [("a.png", "Cardiomegaly|Effusion", 64), ("b.png", "Cardiomegaly", 64), ("c.png", "Cardiomegaly", 64),
            ("d.png", "Cardiomegaly|Mass|Effusion", 48), ("e.png", "Pneumonia", 64), ("f.png", "Pneumonia", 64),
            ("g.png", "No Finding", 64)]
    for name, _, px in rows:
        Image.fromarray(rng.randint(0, 255, (px, px), dtype=np.uint8), mode="L").save(join(root, "images", name))
    with open(join(root, "metadata.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Image Index", "Finding Labels"])
        for name, labels, _ in rows:
            w.writerow([name, labels])
    with open(join(root, "BBox_List_2017.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Image Index", "Finding Label", "Bbox [x", "y", "w", "h]"])
        for name, labels, px in rows:
            label = labels.split("|")[0]
            if label != "No Finding":
                x, y = rng.uniform(0, px / 2, 2) * 2
                w.writerow([name, label, f"{x:.3f}", f"{y:.3f}", f"{px * 0.6:.3f}", f"{px * 0.5:.3f}"])
        w.writerow(["zz.png", "Mass", "1", "1", "4", "4"])  # not in the metadata
        w.writerow(["a.png", "Atelectasis", "1", "1", "4", "4"])  # a box whose label the image lacks
    return str(root)


@pytest.mark.parametrize("seed", [42, 7])
def test_load_paths_match_jax(xray_dataset, seed):
    diseases = ["Cardiomegaly", "Effusion", "Pneumonia", "Atelectasis", "Mass"]
    got = pxray.load_paths(xray_dataset, diseases, seed)
    want = jxray.load_paths(xray_dataset, diseases, seed)
    assert dict(got) == dict(want)
    assert len(got["Cardiomegaly"]) == 4 and "Effusion" not in got  # boxes only for the first label


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    jsd = JSD.init_tiny("xray", [])
    pipe = str(tmp_path_factory.mktemp("pipe"))
    jsave_pipeline_dir(pipe, jsd.unet.config, _np(jsd.unet_params), jsd.vae.config, _np(jsd.vae_params),
                       jsd.clip.config, _np(jsd.clip_params), jsd.schedule)
    return jsd, pipe


def _jax_draws(uid, latent_shape):
    """The JAX X-ray sweep's draws for one image, in the port's layout: the
    posterior eps and the (eps, t) pairs both from fold_in(PRNGKey(seed),
    uid) (xray.py:156-158 and the engine's image key), over the full t
    range."""
    c, h, w = latent_shape
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), uid)
    post = np.asarray(jax.random.normal(key, (h, w, c), dtype=jnp.float32)).transpose(2, 0, 1)
    noise, t = sample_noise_and_t(key, N, (h, w, c), 0.0, 1.0)
    return (torch.from_numpy(np.ascontiguousarray(post)),
            torch.from_numpy(np.ascontiguousarray(np.asarray(noise).transpose(0, 3, 1, 2))),
            torch.from_numpy(np.array(t)).long())


@pytest.fixture(scope="module")
def runs(bundles, xray_dataset, tmp_path_factory):
    """Both packages' main() over two diseases, groups of 2 (Cardiomegaly:
    a full group and a padded one of 64 px, a lone 48 px image)."""
    jsd, pipe = bundles
    root = tmp_path_factory.mktemp("runs")
    diseases = ["Pneumonia", "Cardiomegaly"]
    jx = jxray.XRayTypicality(jsd, xray_dataset, str(root / "jax"), diseases, seed=SEED, N=N)
    jreport, jauc = jx.main(batch_images=2)
    psd = SD.from_pipeline_dir("xray", pipe, [], dtype=torch.float32, device="cpu")
    px = pxray.XRayTypicality(psd, xray_dataset, str(root / "port"), diseases, seed=SEED, N=N, draws=_jax_draws)
    compute, max_loss = px.engine.compute, []

    def recorded(*a):
        losses = compute(*a)
        max_loss.append(float(losses.float().max()))
        return losses

    px.engine.compute = recorded
    preport, pauc = px.main(batch_images=2)
    px.engine.compute = compute
    # one fp16 rounding flip of the largest loss, over the N x C terms of a map element
    map_atol = 2.0 ** (np.floor(np.log2(max(max_loss))) - 10) / (N * 4)
    return dict(root=root, jax=(jreport, jauc), port=(preport, pauc), px=px, map_atol=map_atol)


def test_xray_main_matches_jax(runs):
    root = runs["root"]
    jreport, jauc = runs["jax"]
    preport, pauc = runs["port"]
    for d in ("Cardiomegaly", "Pneumonia"):
        names = sorted(os.listdir(root / "jax" / d / "typicality"))
        assert names == sorted(os.listdir(root / "port" / d / "typicality")) and names
        for n in names:
            want = np.load(root / "jax" / d / "typicality" / n)
            got = np.load(root / "port" / d / "typicality" / n)
            assert got.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=CHAIN["rtol"], atol=runs["map_atol"], err_msg=n)
    assert set(preport) == set(jreport) == {"Cardiomegaly", "Pneumonia"}
    for ours, theirs, name in ((preport, jreport, "report.json"), (pauc, jauc, "auc.json")):
        assert json.load(open(root / "port" / name)) == ours
        for d in theirs:
            assert set(ours[d]) == set(theirs[d])
            np.testing.assert_allclose([ours[d][k] for k in sorted(ours[d])],
                                       [theirs[d][k] for k in sorted(theirs[d])], err_msg=name, **CHAIN)


def test_cached_rerun_and_blur(runs, xray_dataset):
    """A second main() reads the cached maps; a blurred map is the blur of
    the unblurred one."""
    px = runs["px"]
    assert px.main(batch_images=2) == runs["port"]
    path = px.parent["Pneumonia"][0][0]
    plain = px.pixel_map("Pneumonia", path)
    px.blur = True
    try:
        blurred = px.pixel_map("Pneumonia", path)
    finally:
        px.blur = False
    np.testing.assert_allclose(blurred, pxray.gaussian_blur(plain), rtol=1e-5, atol=1e-9)


def test_compare_json_files_matches_jax(runs, tmp_path, capsys):
    root = runs["root"]
    pt, ft = str(root / "port"), str(tmp_path / "ft")
    os.makedirs(ft)
    for name in ("auc.json", "report.json"):  # a "finetuned" run: shifted scores, one image missing
        data = json.load(open(join(pt, name)))
        for d in data:
            data[d] = {k: v + 0.01 for k, v in sorted(data[d].items())[1:]}
        json.dump(data, open(join(ft, name), "w"))
    want = jxray.compare_json_files(pt, ft)
    want_out = capsys.readouterr().out
    got = pxray.compare_json_files(pt, ft)
    assert capsys.readouterr().out == want_out
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


def test_merge_triplets_matches_jax(runs, xray_dataset, tmp_path):
    pt, ft = tmp_path / "pt", tmp_path / "ft"
    rng = np.random.RandomState(5)
    for side in (pt, ft):
        os.makedirs(side / "Cardiomegaly")
        for name in ("a.png", "b.png"):
            Image.fromarray(rng.randint(0, 255, (64, 128, 3), dtype=np.uint8)).save(side / "Cardiomegaly" / name)
    os.remove(ft / "Cardiomegaly" / "b.png")  # missing on one side: skipped
    jxray.merge_triplets(str(pt), str(ft), xray_dataset, str(tmp_path / "jax"))
    pxray.merge_triplets(str(pt), str(ft), xray_dataset, str(tmp_path / "port"))
    assert os.listdir(tmp_path / "port" / "Cardiomegaly") == ["a.png"]
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / "Cardiomegaly" / "a.png")),
                                  np.asarray(Image.open(tmp_path / "jax" / "Cardiomegaly" / "a.png")))
    dm = rng.randn(64, 64).astype(np.float32)
    pil = Image.open(join(xray_dataset, "images", "a.png"))
    np.testing.assert_array_equal(np.asarray(pxray.visualize_boxes((5, 6, 30, 40), dm, pil)),
                                  np.asarray(jxray.visualize_boxes((5, 6, 30, 40), dm, pil)))


def test_xray_cli_on_the_cpu(bundles, xray_dataset, tmp_path, capsys):
    _, pipe = bundles
    out = str(tmp_path / "out")
    port_cli(["xray", "-i", xray_dataset, "-o", out, "-m", pipe, "--N", "2", "--batch_images", "2",
              "--dtype", "fp32", "--device", "cpu"])
    report = json.load(open(join(out, "report.json")))
    assert set(report) == {"Cardiomegaly", "Pneumonia"} and len(report["Cardiomegaly"]) == 4  # empty diseases dropped
    assert all(np.isfinite(v) for d in report.values() for v in d.values())
    port_cli(["xray", "--compare", out, out])
    assert "Cardiomegaly 0.0" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="A12"):
        port_cli(["xray", "-i", xray_dataset, "-o", out, "-m", pipe, "--mesh_dp", "2", "--device", "cpu"])
