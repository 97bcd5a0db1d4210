"""The port's mesh over torch.distributed on the CPU (gloo), held to the JAX
package's mesh helpers and to the JAX package's own dp-sharded sweeps; the
port's TF32 policy, and the typicality CLI's --profile.

  * pad_to_multiple and host_local_batch_slice against JAX's (its process
    count and index monkeypatched);
  * the sweep's dp shards cover every real row once (hypothesis);
  * two gloo ranks of the typicality sweep, through the CLI
    (--coordinator_address) and through the library (``Typicality`` with a
    mesh), with the JAX package's draws injected, against the JAX
    package's sweep over a dp=2 mesh of the same images on the same
    checkpoint: every real artifact written once, within rtol 2e-3, atol
    1e-4 (the fp16 artifact bound of tests/test_torch_port_pipeline.py);
  * two ranks of xray --mesh_dp 2 (torchrun's environment), JAX draws
    injected, against the JAX package's XRayTypicality over a dp=2 mesh:
    report.json and auc.json within rtol 2e-3, atol 1e-4, the maps within
    rtol 2e-3 and the one-flip atol of tests/test_torch_port_xray.py (a
    map element is a mean over N*C differences of fp16 losses, so one
    float32 loss rounding to the neighbouring fp16 value moves it by one
    fp16 ulp of the loss over N*C, with no relative scale to absorb it);
  * --mesh_dp 2 without a process group names torchrun;
  * the port's set-ups turn TF32 off for matmuls and cuDNN convolutions
    (the flags do nothing on the CPU, but are set there too).

A rank is a subprocess that imports the port and no JAX: the JAX draws
reach it through a .npy file per image, in place of the port's seeded ones.
"""
import glob
import json
import os
import socket
import subprocess
import sys
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from diffmining_tpu.applications import xray as jxray
from diffmining_tpu.parallel import mesh as jmesh
from diffmining_tpu.typicality.compute import SD as JSD
from diffmining_tpu.typicality.compute import Typicality as JTypicality
from diffmining_tpu.typicality.engine import sample_noise_and_t

from diffmining_tpu_torch.__main__ import main as port_cli
from diffmining_tpu_torch.applications import xray as pxray
from diffmining_tpu_torch.models.clip import TINY_CLIP_TEXT, TINY_CLIP_VISION, CLIPTextModelWithProjection
from diffmining_tpu_torch.models.tokenizer import tiny_tokenizer
from diffmining_tpu_torch.models.unet import TINY_UNET
from diffmining_tpu_torch.models.vae import TINY_VAE
from diffmining_tpu_torch.parallel import mesh as pmesh
from diffmining_tpu_torch.typicality.compute import SD
from diffmining_tpu_torch.typicality.compute import main as typicality_main
from diffmining_tpu_torch.typicality.engine import TypicalityEngine
from diffmining_tpu_torch.utils.device import resolve_device
from diffmining_tpu_torch.utils.export import save_pipeline_dir
from diffmining_tpu_torch.utils.images import image_uid
from diffmining_tpu_torch.utils.weights import write_safetensors

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED, N, T_MIN, T_MAX = 42, 2, 0.1, 0.9
CHAIN = dict(rtol=2e-3, atol=1e-4)
RANK_TIMEOUT_S = 150  # each subprocess's limit; a rank that loses its peer fails at the group's timeout first

# One rank: argv OUT DRAWS MODE ARGS. The JAX draws (DRAWS/{uid}.npz) take
# the place of the port's seeded ones; MODE "typicality" or "xray" runs
# that command with ARGS, "library" one rank of Typicality over a gloo
# group (ARGS[0] a JSON config). OUT records the artifacts the typicality
# sweep wrote and the largest loss the UNet sweep gave.
RANK = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from diffmining_tpu_torch.applications import xray
from diffmining_tpu_torch.parallel import mesh as pm
from diffmining_tpu_torch.typicality import compute, engine

out, draws_dir, mode, args = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4:]


def draws(uid, latent_shape):
    with np.load(f"{draws_dir}/{uid}.npz") as z:
        post, noise, t = (torch.from_numpy(z[k]) for k in ("post", "noise", "t"))
    assert tuple(post.shape) == tuple(latent_shape), (uid, post.shape, latent_shape)
    return post, noise, t


compute.SeededDraws = xray.SeededDraws = lambda *a, **k: draws
written, max_loss = [], [0.0]
save, sweep = compute.atomic_save_npy, engine.TypicalityEngine.compute
compute.atomic_save_npy = lambda path, a: (written.append(path), save(path, a))


def recorded(self, *a):
    losses = sweep(self, *a)
    max_loss[0] = max(max_loss[0], float(losses.float().max()))
    return losses


engine.TypicalityEngine.compute = recorded
if mode == "typicality":
    compute.main(args)
elif mode == "xray":
    from diffmining_tpu_torch.__main__ import main
    main(["xray", *args])
else:
    cfg = json.loads(args[0])
    pm.initialize_distributed(cfg["address"], 2, cfg["rank"], device="cpu")
    typ = compute.Typicality("ftt", cfg["pipe"], cfg["data"], cfg["tree"], t_min=cfg["t_min"], t_max=cfg["t_max"],
                             N=cfg["N"], batch_images=3, dtype=torch.float32, device="cpu", mesh=pm.make_mesh(),
                             draws=draws)
    if typ.mesh.rank == 0:
        typ.make_submission(cfg["data"], cfg["subs"], sub_split=1)
    pm.host_barrier("submission")
    typ.compute_submission(f"{cfg['subs']}/0.txt")
    pm.destroy()
with open(out, "w") as f:
    json.dump(dict(written=written, max_loss=max_loss[0]), f)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(argvs, envs):
    """Start one process an argv, wait for all within RANK_TIMEOUT_S, and
    kill the rest if one fails or hangs."""
    procs = [subprocess.Popen([sys.executable, *a], cwd=ROOT, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for a, e in zip(argvs, envs)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return outs


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _mesh(dp, rank, world=None):
    return pmesh.Mesh(dp=dp, rank=rank, world=world or dp)


def test_pad_to_multiple_equals_jax():
    for n in range(0, 40):
        for m in range(1, 9):
            assert pmesh.pad_to_multiple(n, m) == jmesh.pad_to_multiple(n, m)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_host_local_batch_slice_equals_jax(world, monkeypatch):
    monkeypatch.setattr(jax, "process_count", lambda: world)
    for rank in range(world):
        monkeypatch.setattr(jax, "process_index", lambda rank=rank: rank)
        for batch in range(world, 5 * world + 1, world):
            assert pmesh.host_local_batch_slice(batch, _mesh(world, rank)) == jmesh.host_local_batch_slice(batch)
        if world > 1:
            for impl in (lambda b: pmesh.host_local_batch_slice(b, _mesh(world, rank)), jmesh.host_local_batch_slice):
                with pytest.raises(AssertionError, match="divide"):
                    impl(world + 1)


def test_rank_outside_the_mesh_takes_no_rows():
    """dp 2 over a world of 4: ranks 0 and 1 split the batch, 2 and 3 take
    none."""
    assert [pmesh.host_local_batch_slice(6, _mesh(2, r, world=4)) for r in range(4)] == [
        slice(0, 3), slice(3, 6), slice(0, 0), slice(0, 0)]


@settings(max_examples=60, deadline=None, database=None)
@given(st.integers(1, 12), st.integers(1, 4))
def test_dp_shards_cover_every_real_row_once(batch, dp):
    """engine.shard pads a group to a multiple of dp with its last item;
    over the ranks, the real rows (positions < batch) are each swept by
    exactly one rank, and the padding is less than dp."""
    seen = []
    for rank in range(dp):
        eng = TypicalityEngine(unet=None, schedule=None, n_samples=1, chunk=1, mesh=_mesh(dp, rank))
        group, rows = eng.shard(list(range(batch)))
        assert len(group) % dp == 0 and len(group) - batch < dp
        assert group[:batch] == list(range(batch)) and set(group[batch:]) <= {batch - 1}
        seen += [i for i in range(rows.start, rows.stop) if i < batch]
    assert sorted(seen) == list(range(batch))


def test_mesh_without_a_group_allows_only_dp_1():
    assert pmesh.make_mesh(dp=1) == pmesh.make_mesh() == pmesh.Mesh(dp=1, rank=0, world=1)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2 .*--distributed"):
        pmesh.make_mesh(dp=2)


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    """A tiny float32 stack drawn from a seed and exported by the port as a
    pipeline dir, which both packages load."""
    out = str(tmp_path_factory.mktemp("pipe"))
    sd = SD.init_random("ftt", [], TINY_UNET, TINY_VAE, TINY_CLIP_TEXT, seed=5, dtype=torch.float32, device="cpu")
    save_pipeline_dir(out, sd.unet.config, sd.unet.state_dict(), sd.vae.config, sd.vae.state_dict(),
                      sd.clip.config, sd.clip.state_dict(), sd.schedule)
    return out


def _save_jax_draws(out, paths, vae_fold, t_min, t_max):
    """The JAX sweep's draws of each image (TINY_VAE halves the size), in
    the port's NCHW layout, as OUT/{uid}.npz: the posterior eps from
    fold_in(PRNGKey(seed), uid), folded with 7 first for the typicality
    sweep (``vae_fold``), and (eps, t) from sample_noise_and_t(fold_in(
    PRNGKey(seed), uid), ...)."""
    os.makedirs(out, exist_ok=True)
    for p in paths:
        uid = image_uid(p)
        with Image.open(p) as im:
            w, h = im.size
        shape = (h // 2, w // 2, 4)
        root = jax.random.PRNGKey(SEED)
        vae_key = jax.random.fold_in(jax.random.fold_in(root, 7) if vae_fold else root, uid)
        post = np.asarray(jax.random.normal(vae_key, shape, dtype=jnp.float32)).transpose(2, 0, 1)
        noise, t = sample_noise_and_t(jax.random.fold_in(root, uid), N, shape, t_min, t_max)
        np.savez(join(out, f"{uid}.npz"), post=np.ascontiguousarray(post),
                 noise=np.ascontiguousarray(np.asarray(noise).transpose(0, 3, 1, 2)), t=np.array(t).astype(np.int64))
    return out


@pytest.fixture(scope="module")
def ftt(tmp_path_factory):
    """Three 32px images in one decade, two 64px in another: at batch_images
    3 over dp 2 the first group pads to 4 (rank 1 sweeps one real row and
    one pad), the second to 3 and then 4 (rank 1 sweeps only pads)."""
    root = tmp_path_factory.mktemp("data") / "ftt"
    rng = np.random.RandomState(11)
    for decade, px, n in (("1920", 32, 3), ("1960", 64, 2)):
        os.makedirs(root / decade)
        for i in range(n):
            Image.fromarray(rng.randint(0, 255, (px, px, 3), dtype=np.uint8)).save(root / decade / f"i{decade}_{i}.png")
    return str(root)


@pytest.fixture(scope="module")
def ftt_jax(ftt, pipe, tmp_path_factory):
    """The JAX package's sweep of the images over a dp=2 mesh (its pad to a
    multiple of dp included), and its draws for the port's ranks."""
    root = tmp_path_factory.mktemp("ftt_jax")
    tree = str(root / "tree")
    jtyp = JTypicality("ftt", pipe, ftt, tree, N=N, t_min=T_MIN, t_max=T_MAX, batch_images=3, dtype=jnp.float32,
                       mesh=jmesh.make_mesh(dp=2, fsdp=1))
    for c in jtyp.categories():
        jtyp.D[c].compute_batch([(s, c) for s in jtyp.get_seeds_(c)])
    draws = _save_jax_draws(str(root / "draws"), sorted(glob.glob(join(ftt, "*", "*.png"))), True, T_MIN, T_MAX)
    return tree, draws


def _typicality_argv(ftt, pipe, tree, subs, *extra):
    return ["--which", "ftt", "-i", ftt, "-c", tree, "-s", subs, "-m", pipe, "--make_submission", "--N", str(N),
            "--t_min", str(T_MIN), "--t_max", str(T_MAX), "--batch_images", "3", "--dtype", "fp32", "--device",
            "cpu", *extra]


def _npys(tree):
    return {os.path.relpath(p, tree): np.load(p) for p in sorted(glob.glob(join(tree, "*", "*.npy")))}


@pytest.mark.parametrize("entry", ["cli", "library"])
def test_two_gloo_processes_write_what_jax_writes(entry, ftt, pipe, ftt_jax, tmp_path):
    """Two gloo ranks over dp 2 write every real image once, and the union
    of their artifacts is the JAX package's dp=2 sweep within rtol 2e-3,
    atol 1e-4."""
    jax_tree, draws = ftt_jax
    want = _npys(jax_tree)
    assert len(want) == 5

    tree, subs, port = str(tmp_path / "tree"), str(tmp_path / "subs"), _free_port()
    logs = [str(tmp_path / f"rank{r}.json") for r in range(2)]
    if entry == "cli":
        args = [_typicality_argv(ftt, pipe, tree, subs, "--coordinator_address", f"127.0.0.1:{port}",
                                 "--num_processes", "2", "--process_id", str(r)) for r in range(2)]
    else:
        args = [[json.dumps(dict(address=f"127.0.0.1:{port}", rank=r, pipe=pipe, data=ftt, tree=tree, subs=subs, N=N,
                                 t_min=T_MIN, t_max=T_MAX))] for r in range(2)]
    outs = _run_ranks([["-c", RANK, logs[r], draws, "typicality" if entry == "cli" else "library", *args[r]]
                       for r in range(2)], [_env()] * 2)
    written = [json.load(open(p))["written"] for p in logs]
    # every real image once across the ranks: rank 0 two of 1920 and both of
    # 1960, rank 1 the third of 1920 (its other rows are pads)
    assert sorted(os.path.relpath(p, tree) for p in written[0] + written[1]) == sorted(want)
    assert len(written[0]) == 4 and len(written[1]) == 1
    assert "padding sweep batch 3 -> 4 to shard over dp=2" in outs[0][0]
    assert "imgs/hr" in outs[0][0] and "imgs/hr" not in outs[1][0]  # progress on rank 0 only
    got = _npys(tree)
    for name, w in want.items():
        assert got[name].dtype == np.float16 and got[name].shape == w.shape == (N, 2, 4, w.shape[-1], w.shape[-1])
        np.testing.assert_allclose(got[name].astype(np.float32), w.astype(np.float32), err_msg=name, **CHAIN)


def test_typicality_mesh_dp_without_a_group_names_torchrun(ftt, pipe, tmp_path):
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        typicality_main(_typicality_argv(ftt, pipe, str(tmp_path / "t"), str(tmp_path / "s"), "--mesh_dp", "2"))


def test_profile_writes_a_trace(ftt, pipe, tmp_path, capsys):
    prof = str(tmp_path / "prof")
    typicality_main(_typicality_argv(ftt, pipe, str(tmp_path / "t"), str(tmp_path / "s"), "--profile", prof))
    with open(join(prof, "trace_rank0.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "typicality group" for e in events)
    assert "typicality sweep (traced) took" in capsys.readouterr().out


@pytest.fixture(scope="module")
def cxr(tmp_path_factory):
    """Three 64px Cardiomegaly images and one 48px, two 64px Pneumonia
    (tests/test_torch_port_xray.py's layout): groups of 2 over dp 2 give
    each rank one row, a pad on the odd groups."""
    import csv

    root = str(tmp_path_factory.mktemp("cxr"))
    os.makedirs(join(root, "images"))
    rng = np.random.RandomState(2)
    rows = [("a.png", "Cardiomegaly", 64), ("b.png", "Cardiomegaly|Effusion", 64), ("c.png", "Cardiomegaly", 64),
            ("d.png", "Cardiomegaly", 48), ("e.png", "Pneumonia", 64), ("f.png", "Pneumonia", 64)]
    for name, _, px in rows:
        Image.fromarray(rng.randint(0, 255, (px, px), dtype=np.uint8), mode="L").save(join(root, "images", name))
    with open(join(root, "metadata.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Image Index", "Finding Labels"])
        w.writerows([(n, labels) for n, labels, _ in rows])
    with open(join(root, "BBox_List_2017.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Image Index", "Finding Label", "Bbox [x", "y", "w", "h]"])
        for name, labels, px in rows:
            x, y = rng.uniform(0, px / 2, 2) * 2
            w.writerow([name, labels.split("|")[0], f"{x:.3f}", f"{y:.3f}", f"{px * 0.6:.3f}", f"{px * 0.5:.3f}"])
    return root


def _xray_outputs(out):
    maps = {os.path.relpath(p, out): np.load(p) for p in sorted(glob.glob(join(out, "*", "typicality", "*.npy")))}
    return maps, json.load(open(join(out, "report.json"))), json.load(open(join(out, "auc.json")))


def test_xray_mesh_dp_2_under_torchrun_matches_jax(cxr, pipe, tmp_path):
    """Two ranks of ``xray --mesh_dp 2`` in groups of 2 (each rank sweeps
    one image a group) against the JAX package's XRayTypicality over a dp=2
    mesh, both over the command's diseases: the maps, report.json and
    auc.json."""
    jout = str(tmp_path / "jax")
    jsd = JSD.from_pipeline_dir("xray", pipe, [], dtype=jnp.float32)
    jxray.XRayTypicality(jsd, cxr, jout, pxray.DISEASES, seed=SEED, N=N, mesh=jmesh.make_mesh(dp=2, fsdp=1)).main(
        batch_images=2)
    maps, report, auc = _xray_outputs(jout)
    assert len(maps) == 6 and set(report) == {"Cardiomegaly", "Pneumonia"}

    draws = _save_jax_draws(str(tmp_path / "draws"), sorted(glob.glob(join(cxr, "images", "*.png"))), False, 0.0, 1.0)
    out, port = str(tmp_path / "port"), _free_port()
    logs = [str(tmp_path / f"rank{r}.json") for r in range(2)]
    argv = ["-i", cxr, "-o", out, "-m", pipe, "--N", str(N), "--batch_images", "2", "--mesh_dp", "2", "--dtype",
            "fp32", "--device", "cpu"]
    _run_ranks([["-c", RANK, logs[r], draws, "xray", *argv] for r in range(2)],
               [_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=r, LOCAL_RANK=r, WORLD_SIZE=2,
                     LOCAL_WORLD_SIZE=2) for r in range(2)])
    got_maps, got_report, got_auc = _xray_outputs(out)
    # one fp16 rounding flip of the largest loss, over the N x C terms of a map element
    max_loss = max(json.load(open(p))["max_loss"] for p in logs)
    map_atol = 2.0 ** (np.floor(np.log2(max_loss)) - 10) / (N * 4)
    assert sorted(got_maps) == sorted(maps)
    for name, m in maps.items():
        assert got_maps[name].dtype == np.float32 and got_maps[name].shape == m.shape
        np.testing.assert_allclose(got_maps[name], m, rtol=CHAIN["rtol"], atol=map_atol, err_msg=name)
    for got, want, name in ((got_report, report, "report.json"), (got_auc, auc, "auc.json")):
        assert {d: sorted(v) for d, v in got.items()} == {d: sorted(v) for d, v in want.items()}
        for d in want:
            np.testing.assert_allclose([got[d][k] for k in sorted(want[d])], [want[d][k] for k in sorted(want[d])],
                                       err_msg=name, **CHAIN)


def test_xray_mesh_dp_without_torchrun_names_it(cxr, pipe, tmp_path):
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node 2"):
        port_cli(["xray", "-i", cxr, "-o", str(tmp_path / "o"), "-m", pipe, "--mesh_dp", "2", "--device", "cpu"])


# --- TF32: the port's set-ups turn it off ------------------------------------
#
# resolve_device owns the policy; each case builds its inputs, turns both
# flags on (TF32 everywhere), then makes the set-up a float32 run of the
# port makes, which must leave both off.


def _tiny_towers():
    from diffmining_tpu_torch.baselines.clipmining import random_vision_tower

    vision = random_vision_tower(TINY_CLIP_VISION, torch.Generator().manual_seed(0))
    text = CLIPTextModelWithProjection(TINY_CLIP_TEXT, projection_dim=TINY_CLIP_VISION.projection_dim)
    return vision, text


def _ranker(tmp_path, **towers):
    from diffmining_tpu_torch.baselines.clipmining import CLIPRankCluster

    os.makedirs(tmp_path / "geo", exist_ok=True)
    return lambda: CLIPRankCluster(str(tmp_path / "geo"), str(tmp_path / "clip_cache"), device="cpu", **towers)


def _sd_f32(tmp_path):
    return lambda: SD.init_random("ftt", [], TINY_UNET, TINY_VAE, TINY_CLIP_TEXT, seed=1, dtype=torch.float32,
                                  device="cpu")


def _trainer_no_mixed_precision(tmp_path):
    from diffmining_tpu_torch.finetuning.args import parse_args
    from diffmining_tpu_torch.finetuning.base import BaseTrainer

    sd = SD.init_random("ftt", [], TINY_UNET, TINY_VAE, TINY_CLIP_TEXT, seed=1, dtype=torch.bfloat16, device="cpu")
    args = parse_args(["--data_path", str(tmp_path), "--output_dir", str(tmp_path / "run"), "--mixed_precision", "no",
                       "--device", "cpu"])
    return lambda: BaseTrainer("ftt", args, sd=sd)


def _clip_random_towers(tmp_path):
    vision, text = _tiny_towers()
    return _ranker(tmp_path, vision=vision, text=text)


def _clip_loaded_towers(tmp_path):
    """The clipmining command's set-up with --clip_dir: load_towers, then
    the ranker on the device."""
    from diffmining_tpu_torch.baselines.clipmining import load_towers

    d = str(tmp_path / "clip")
    os.makedirs(d)
    vision, text = _tiny_towers()
    write_safetensors(join(d, "model.safetensors"),
                      {k: v.numpy() for k, v in {**vision.state_dict(), **text.state_dict()}.items()})
    tv, tt = TINY_CLIP_VISION, TINY_CLIP_TEXT
    with open(join(d, "config.json"), "w") as f:
        json.dump({"projection_dim": tv.projection_dim,
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

    def setup():
        vision, text, tokenizer = load_towers(d)
        return _ranker(tmp_path, vision=vision, text=text, tokenizer=tokenizer)()

    return setup


def _cluster_clip_mode(tmp_path):
    from diffmining_tpu_torch.typicality.cluster import Cluster

    vision, _ = _tiny_towers()
    os.makedirs(tmp_path / "ftt")

    def setup():
        cl = Cluster("ftt", str(tmp_path / "typ"), str(tmp_path / "ftt"), str(tmp_path / "cache"), device="cpu",
                     dtype=torch.float32, clip_bundle={"config": TINY_CLIP_VISION, "state_dict": vision.state_dict()})
        cl.init_clip()

    return setup


@pytest.mark.parametrize("setup", [_sd_f32, _trainer_no_mixed_precision, _clip_random_towers, _clip_loaded_towers,
                                   _cluster_clip_mode, lambda tmp_path: lambda: resolve_device("cpu")],
                         ids=["sd_fp32", "finetune_mixed_precision_no", "clip_random_towers", "clip_loaded_towers",
                              "cluster_clip_mode", "resolve_device"])
def test_float32_setups_turn_tf32_off(setup, tmp_path):
    """Both flags on first, then the set-up: it leaves both off. PyTorch's
    defaults (matmul off, cuDNN on) are restored after."""
    run = setup(tmp_path)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        run()
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
