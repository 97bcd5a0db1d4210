"""The port's mining stage over dp (torch.distributed, gloo on the CPU) held
to the JAX package's own dp=2 runs:

  * ``SDFeaturizer`` over two gloo ranks, each running the UNet on four of
    the eight DIFT draws, against JAX's ``SDFeaturizer`` over a dp=2 mesh,
    within rtol 1e-3, atol 2e-4 (the UNet tests' framework-to-framework
    bound, tests/test_torch_port_mining.py TOL); an ensemble that does not
    divide over dp raises, and dp 1 without a process group is the plain
    path, bit for bit;
  * ``cluster --mesh_dp 2`` as two ranks under torchrun's environment
    against JAX's ``Cluster`` over dp=2, both mining one typicality tree:
    the patch tables equal, every embedding within TOL, the ranked clusters
    the same (both k-means start from JAX's k-means++ draws), every pickle
    written once, by rank 0; then the same run again over a cache with part
    of its embeddings removed, which must finish within the rank timeout
    (every rank lists the cache before rank 0 writes, so the ranks send the
    same images through the DIFT all-reduce) and give the same result;
  * ``parallel --mesh_dp 2``, the compute stage and then the cluster stage,
    against JAX's ``ParallelTypicality`` and ``ParallelCluster`` over dp=2:
    the artifacts within rtol 2e-3, atol 1e-4 (the fp16 artifact bound of
    tests/test_torch_port_mesh.py), the embeddings within TOL, the ranked
    clusters the same.

A rank is a subprocess that imports the port and no JAX: the JAX draws and
k-means++ seeds reach it through files, in place of the port's seeded ones.
"""
import glob
import json
import os
import pickle
import shutil
import socket
import subprocess
import sys
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffmining_tpu.applications.parallel import ParallelCluster as JParallelCluster
from diffmining_tpu.applications.parallel import ParallelTypicality as JParallelTypicality
from diffmining_tpu.ops import kmeans as jkm
from diffmining_tpu.parallel import mesh as jmesh
from diffmining_tpu.typicality.cluster import Cluster as JCluster
from diffmining_tpu.typicality.compute import SD as JSD
from diffmining_tpu.typicality.dift import SDFeaturizer as JFeaturizer
from diffmining_tpu.typicality.engine import sample_noise_and_t

from diffmining_tpu_torch.models.clip import TINY_CLIP_TEXT
from diffmining_tpu_torch.models.unet import TINY_UNET
from diffmining_tpu_torch.models.vae import TINY_VAE
from diffmining_tpu_torch.parallel import mesh as pmesh
from diffmining_tpu_torch.typicality.compute import SD, Typicality
from diffmining_tpu_torch.typicality.dift import SDFeaturizer
from diffmining_tpu_torch.utils.export import save_pipeline_dir
from diffmining_tpu_torch.utils.images import image_uid

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-3, atol=2e-4)
CHAIN = dict(rtol=2e-3, atol=1e-4)
MAP_TOL = dict(rtol=1e-5, atol=1e-6)
DECADES, COUNTRIES = ["1930", "1990"], ["France", "Japan"]
SEED, N, E = 42, 2, 8  # the sweep's and DIFT's seed in both packages; sweep samples; DIFT draws
RANK_TIMEOUT_S = 150  # each subprocess's limit; a rank that loses its peer fails at the group's timeout first

# One rank: argv OUT DRAWS MODE ARGS. DRAWS holds the JAX draws (dift_{uid}
# .npz, sweep_{uid}.npz) and k-means++ seeds (kmeans_inits.npy, one a
# restart in call order), which take the place of the port's seeded ones.
# MODE "dift": one rank of SDFeaturizer over a gloo group (ARGS[0] a JSON
# config); otherwise the port's command MODE with ARGS. OUT records every
# pickle and artifact the process wrote.
RANK = r"""
import itertools, json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from diffmining_tpu_torch.applications import parallel
from diffmining_tpu_torch.ops import kmeans
from diffmining_tpu_torch.parallel import mesh as pm
from diffmining_tpu_torch.typicality import cluster, compute, dift

out, draws_dir, mode, args = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4:]


def dift_draws(uid, latent_shape, ensemble_size):
    with np.load(f"{draws_dir}/dift_{uid}.npz") as z:
        vae, noise = torch.from_numpy(z["vae"]), torch.from_numpy(z["noise"])
    assert tuple(vae.shape) == tuple(latent_shape) and len(noise) == ensemble_size, (uid, vae.shape, latent_shape)
    return vae, noise


def sweep_draws(uid, latent_shape):
    with np.load(f"{draws_dir}/sweep_{uid}.npz") as z:
        post, noise, t = (torch.from_numpy(z[k]) for k in ("post", "noise", "t"))
    assert tuple(post.shape) == tuple(latent_shape), (uid, post.shape, latent_shape)
    return post, noise, t


calls = itertools.count()
dift.DiftDraws = lambda *a, **k: dift_draws
compute.SeededDraws = lambda *a, **k: sweep_draws
kmeans.kmeanspp_init = lambda g, x, k: torch.from_numpy(np.load(f"{draws_dir}/kmeans_inits.npy")[next(calls)]).to(x)
written = []
for mod, name in ((cluster, "atomic_save_pickle"), (parallel, "atomic_save_pickle"), (compute, "atomic_save_npy")):
    save = getattr(mod, name)
    setattr(mod, name, lambda path, obj, save=save: (written.append(path), save(path, obj)))
if mode == "dift":
    cfg = json.loads(args[0])
    pm.initialize_distributed(cfg["address"], 2, cfg["rank"], device="cpu")
    sd = compute.SD.from_pipeline_dir("ftt", cfg["pipe"], [], dtype=torch.float32, device="cpu")
    feat = dift.SDFeaturizer(sd, mesh=pm.make_mesh()).forward(np.load(cfg["img"]), cfg["prompt"], t=161,
                                                              uid=cfg["uid"])
    np.save(cfg["feat"], feat)
    pm.destroy()
else:
    from diffmining_tpu_torch.__main__ import main
    main([mode, *args])
with open(out, "w") as f:
    json.dump(dict(written=written, kmeans_calls=next(calls)), f)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(out_dir, draws, mode, argvs, torchrun: bool):
    """Two ranks of RANK in MODE, one argv each, under torchrun's
    environment or not; waits for both within RANK_TIMEOUT_S, kills the
    other if one fails or hangs, and returns what each wrote."""
    os.makedirs(out_dir, exist_ok=True)
    port, logs = _free_port(), [join(out_dir, f"rank{r}.json") for r in range(2)]
    procs = []
    for r, argv in enumerate(argvs):
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        if torchrun:
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                       LOCAL_WORLD_SIZE="2")
        procs.append(subprocess.Popen([sys.executable, "-c", RANK, logs[r], draws, mode, *argv], cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [json.load(open(p)) for p in logs]


def _save_dift_draws(draws, uids, latent_shape):
    """JAX SDFeaturizer's draws of each uid (dift.py:81-88: the VAE eps from
    fold_in(fold_in(PRNGKey(seed), 11), uid), the E noises from 13), in the
    port's NCHW layout."""
    os.makedirs(draws, exist_ok=True)
    c, h, w = latent_shape
    base = jax.random.PRNGKey(SEED)
    for uid in uids:
        kvae = jax.random.fold_in(jax.random.fold_in(base, 11), uid)
        kens = jax.random.fold_in(jax.random.fold_in(base, 13), uid)
        vae = np.asarray(jax.random.normal(kvae, (1, h, w, c), dtype=jnp.float32))[0].transpose(2, 0, 1)
        noise = np.asarray(jax.random.normal(kens, (E, h, w, c), dtype=jnp.float32)).transpose(0, 3, 1, 2)
        np.savez(join(draws, f"dift_{uid}.npz"), vae=np.ascontiguousarray(vae), noise=np.ascontiguousarray(noise))


def _save_sweep_draws(draws, paths, t_min, t_max):
    """The JAX sweep's draws of each image (TINY_VAE halves the size): the
    posterior eps from fold_in(fold_in(PRNGKey(seed), 7), uid) and (eps, t)
    from sample_noise_and_t(fold_in(PRNGKey(seed), uid), ...)."""
    os.makedirs(draws, exist_ok=True)
    root = jax.random.PRNGKey(SEED)
    for p in paths:
        uid = image_uid(p)
        with Image.open(p) as im:
            w, h = im.size
        shape = (h // 2, w // 2, 4)
        post = np.asarray(jax.random.normal(jax.random.fold_in(jax.random.fold_in(root, 7), uid), shape,
                                            dtype=jnp.float32)).transpose(2, 0, 1)
        noise, t = sample_noise_and_t(jax.random.fold_in(root, uid), N, shape, t_min, t_max)
        np.savez(join(draws, f"sweep_{uid}.npz"), post=np.ascontiguousarray(post),
                 noise=np.ascontiguousarray(np.asarray(noise).transpose(0, 3, 1, 2)), t=np.array(t).astype(np.int64))


class _RecordInits:
    """JAX's kmeanspp_init, recording each restart's seeds in call order."""

    def __init__(self, monkeypatch):
        self.inits, self._init = [], jkm.kmeanspp_init
        monkeypatch.setattr(jkm, "kmeanspp_init", self)

    def __call__(self, key, x, k):
        c = self._init(key, x, k)
        self.inits.append(np.asarray(c))
        return c

    def save(self, draws):
        np.save(join(draws, "kmeans_inits.npy"), np.stack(self.inits))


def _pickles(d):
    return {os.path.basename(p): pickle.load(open(p, "rb")) for p in sorted(glob.glob(join(d, "*.pkl")))}


def _crops(parent):
    """(cluster rank, patch id) of every member crop, named
    {rank}-{member}-{num_clusters}_{id}.png: members sort by distance to the
    centre, where near-ties may fall either way."""
    return sorted((n.split("-")[0], n.split("_", 1)[1]) for n in os.listdir(parent))


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    """A tiny float32 stack drawn from a seed and exported by the port as a
    pipeline dir, which both packages load."""
    out = str(tmp_path_factory.mktemp("pipe"))
    sd = SD.init_random("ftt", [], TINY_UNET, TINY_VAE, TINY_CLIP_TEXT, seed=5, dtype=torch.float32, device="cpu")
    save_pipeline_dir(out, sd.unet.config, sd.unet.state_dict(), sd.vae.config, sd.vae.state_dict(),
                      sd.clip.config, sd.clip.state_dict(), sd.schedule)
    return out


# ------------------------------------------------------------------ DIFT


def test_dift_over_two_gloo_ranks_matches_jax(pipe, tmp_path):
    img = np.random.RandomState(7).uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    jsd = JSD.from_pipeline_dir("ftt", pipe, [], dtype=jnp.float32)
    want = JFeaturizer(jsd, mesh=jmesh.make_mesh(dp=2, fsdp=1)).forward(img, "a photo", t=161, uid=5)
    draws = str(tmp_path / "draws")
    _save_dift_draws(draws, [5], (4, 16, 16))
    np.save(tmp_path / "img.npy", img)
    address = f"127.0.0.1:{_free_port()}"
    cfgs = [json.dumps(dict(address=address, rank=r, pipe=pipe, img=str(tmp_path / "img.npy"), prompt="a photo",
                            uid=5, feat=str(tmp_path / f"feat{r}.npy"))) for r in range(2)]
    _run_ranks(str(tmp_path), draws, "dift", [[c] for c in cfgs], torchrun=False)
    got = [np.load(tmp_path / f"feat{r}.npy") for r in range(2)]
    np.testing.assert_array_equal(got[0], got[1])  # the all-reduce leaves one sum on every rank
    assert got[0].shape == want.shape and got[0].dtype == np.float32
    np.testing.assert_allclose(got[0], want, **TOL)


def test_dift_ensemble_must_divide_over_dp_and_dp_1_is_the_plain_path(pipe):
    psd = SD.from_pipeline_dir("ftt", pipe, [], dtype=torch.float32, device="cpu")
    img = np.random.RandomState(8).uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="ensemble_size=3 must divide over dp=2"):
        SDFeaturizer(psd, mesh=pmesh.Mesh(dp=2, rank=0, world=2)).forward(img, "a photo", ensemble_size=3)
    plain = SDFeaturizer(psd).forward(img, "a photo", t=161, uid=3)
    one = SDFeaturizer(psd, mesh=pmesh.make_mesh(dp=1)).forward(img, "a photo", t=161, uid=3)
    np.testing.assert_array_equal(one, plain)


# ------------------------------------------------------------------ cluster


@pytest.fixture(scope="module")
def ftt(pipe, tmp_path_factory):
    """Three 32px images in each of two decades (names unique across them:
    the draws key on the file name) and their typicality tree, swept by the
    port at N=2: both packages mine this one tree."""
    root = tmp_path_factory.mktemp("ftt")
    rng = np.random.RandomState(0)
    for dec in DECADES:
        os.makedirs(root / dec)
        for i in range(3):
            Image.fromarray(rng.randint(0, 255, (32, 32, 3), dtype=np.uint8)).save(root / dec / f"img_{dec}_{i}.png")
    tree = str(tmp_path_factory.mktemp("tree"))
    typ = Typicality("ftt", pipe, str(root), tree, t_min=0.1, t_max=0.7, N=N, dtype=torch.float32, device="cpu")
    for dec in DECADES:
        typ.D[dec].compute_batch([(p, dec) for p in typ.get_seeds_(dec)])
    return str(root), tree


@pytest.fixture(scope="module")
def cluster_runs(ftt, pipe, tmp_path_factory):
    """JAX's Cluster over a dp=2 mesh (its k-means++ seeds recorded), then
    two ranks of ``cluster --mesh_dp 2`` under torchrun's environment on
    the same tree, with JAX's draws and seeds."""
    root, tree = ftt
    base = tmp_path_factory.mktemp("cluster")
    draws = str(base / "draws")
    with pytest.MonkeyPatch.context() as mp:
        rec = _RecordInits(mp)
        jsd = JSD.from_pipeline_dir("ftt", pipe, [], dtype=jnp.float32)
        jcl = JCluster("ftt", tree, root, str(base / "jax"), sd=jsd, dift_sd=jsd, kx=8, ky=8,
                       mesh=jmesh.make_mesh(dp=2, fsdp=1))
        jcl.clustering("dift-161", k_per_image=5, k=9, num_clusters=3)
    _save_dift_draws(draws, [image_uid(p) for p in glob.glob(join(root, "*", "*.png"))], (4, 16, 16))
    rec.save(draws)
    argv = ["-w", "ftt", "-d", root, "-t", tree, "-c", str(base / "port"), "-m", pipe, "--k", "8", "--cluster",
            "--num_clusters", "3", "--num_images", "9", "--dtype", "fp32", "--device", "cpu", "--mesh_dp", "2"]
    ranks = _run_ranks(str(base), draws, "cluster", [argv, argv], torchrun=True)
    return dict(jax=str(base / "jax"), port=str(base / "port"), draws=draws, argv=argv, ranks=ranks,
                n_inits=len(rec.inits), base=str(base))


def _cluster_outputs_match(port, jax_cache):
    for dec in DECADES:
        got, want = (pickle.load(open(join(c, "clusters", f"{dec}.pkl"), "rb")) for c in (port, jax_cache))
        for g, w in zip(got, want):
            cols = ["seed", "x_start", "y_start", "x_end", "y_end", "origin"]
            assert list(g.columns) == list(w.columns) and g[cols].equals(w[cols]) and len(g) == 15
            np.testing.assert_allclose(g["D"].values, w["D"].values, **MAP_TOL)
        parent = join("images", "clusters", "ranked", "dift-161", dec)
        assert _crops(join(port, parent)) == _crops(join(jax_cache, parent)) and len(_crops(join(port, parent))) == 9
    got, want = (_pickles(join(c, "embeddings", "dift-161")) for c in (port, jax_cache))
    assert sorted(got) == sorted(want) and len(want) == 2 * 9
    for name, w in want.items():
        assert got[name].shape == w.shape
        np.testing.assert_allclose(got[name], w, err_msg=name, **TOL)


def test_cluster_mesh_dp_2_under_torchrun_matches_jax(cluster_runs):
    """The patch tables, embeddings and ranked clusters of two ranks equal
    JAX's dp=2 run; rank 0 wrote every pickle once and rank 1 none; both
    ranks' k-means started from JAX's seeds."""
    run = cluster_runs
    _cluster_outputs_match(run["port"], run["jax"])
    written = [[os.path.relpath(p, run["port"]) for p in r["written"]] for r in run["ranks"]]
    assert sorted(written[0]) == sorted(set(written[0])) and written[1] == []
    assert sorted(written[0]) == sorted([join("clusters", f"{d}.pkl") for d in DECADES] + [
        join("embeddings", "dift-161", n) for n in os.listdir(join(run["port"], "embeddings", "dift-161"))])
    assert [r["kmeans_calls"] for r in run["ranks"]] == [run["n_inits"]] * 2 == [2 * 10] * 2


def test_cluster_mesh_dp_2_over_a_partial_cache(cluster_runs, tmp_path):
    """The same run again over a copy of the cache whose embeddings of every
    other patch and member crops were removed: it finishes, rank 0 writes
    exactly the removed pickles, and the result is the same."""
    run = cluster_runs
    cache = str(tmp_path / "cache")
    shutil.copytree(run["port"], cache)
    shutil.rmtree(join(cache, "images"))
    emb = join(cache, "embeddings", "dift-161")
    removed = sorted(os.listdir(emb))[::2]
    for n in removed:
        os.remove(join(emb, n))
    argv = list(run["argv"])
    argv[argv.index("-c") + 1] = cache
    ranks = _run_ranks(str(tmp_path), run["draws"], "cluster", [argv, argv], torchrun=True)
    assert sorted(os.path.relpath(p, emb) for p in ranks[0]["written"]) == removed and ranks[1]["written"] == []
    _cluster_outputs_match(cache, run["jax"])


# ------------------------------------------------------------------ parallel


@pytest.fixture(scope="module")
def translated(tmp_path_factory):
    """PnP's output layout: {root}/{source}/gt--{source}___{sid}.jpg and a
    {target}___{sid}.jpg translation for the other country."""
    root = tmp_path_factory.mktemp("parallel")
    rng = np.random.RandomState(0)
    for src in COUNTRIES:
        os.makedirs(join(root, src))
        for sid in ["a1", "b2"]:
            for prefix in [f"gt--{src}"] + [c for c in COUNTRIES if c != src]:
                Image.fromarray(rng.randint(0, 255, (32, 32, 3), dtype=np.uint8)).save(
                    join(root, src, f"{prefix}___{sid}.jpg"))
    return str(root)


def test_parallel_mesh_dp_2_both_stages_match_jax(translated, pipe, tmp_path, monkeypatch):
    """``parallel --mesh_dp 2``: the compute stage's artifacts, then the
    cluster stage's embeddings and ranked clusters, against JAX's
    ParallelTypicality and ParallelCluster over dp=2; rank 0 writes every
    pickle once."""
    mesh = jmesh.make_mesh(dp=2, fsdp=1)
    jsd = JSD.from_pipeline_dir("geo", pipe, COUNTRIES, dtype=jnp.float32)
    jtree, jcache = str(tmp_path / "jtree"), str(tmp_path / "jcache")
    jtyp = JParallelTypicality(None, translated, jtree, sd=jsd, N=N, mesh=mesh)
    for c in COUNTRIES:
        jtyp.D[c].compute_batch([(p, c) for p in jtyp.get_seeds_(c)])
    rec = _RecordInits(monkeypatch)
    JParallelCluster(jtree, translated, jcache, sd=jsd, dift_sd=jsd, kx=8, ky=8, mesh=mesh).clustering(
        "dift-161", k=8, num_clusters=2, num_components=2)
    monkeypatch.undo()
    draws = str(tmp_path / "draws")
    paths = sorted(glob.glob(join(translated, "*", "*.jpg")))
    _save_sweep_draws(draws, paths, 0.0, 1.0)
    ids = [n[:-4] for n in os.listdir(join(jcache, "embeddings", "dift-161"))]
    _save_dift_draws(draws, [image_uid(i + c) for i in ids for c in COUNTRIES], (4, 16, 16))
    rec.save(draws)

    tree, subs, cache = str(tmp_path / "tree"), str(tmp_path / "subs"), str(tmp_path / "cache")
    common = ["-i", translated, "-t", tree, "-c", cache, "-m", pipe, "--N", str(N), "--dtype", "fp32", "--device",
              "cpu", "--mesh_dp", "2"]
    compute_argv = [*common, "--make_submission", "--compute", "--submission_path", subs]
    ranks = _run_ranks(str(tmp_path / "compute"), draws, "parallel", [compute_argv] * 2, torchrun=True)
    written = [os.path.relpath(p, tree) for r in ranks for p in r["written"]]
    want = {os.path.relpath(p, jtree): np.load(p) for p in glob.glob(join(jtree, "*", "*.npy"))}
    assert sorted(written) == sorted(want) and len(want) == 8  # every file once, over both ranks
    # a country's four files are padded to the CLI's batch_images 8, as in
    # JAX: its real rows are rank 0's, and rank 1 sweeps the pads
    assert len(ranks[0]["written"]) == 8 and ranks[1]["written"] == []
    for name, w in want.items():
        g = np.load(join(tree, name))
        assert g.dtype == np.float16 and g.shape == w.shape
        np.testing.assert_allclose(g.astype(np.float32), w.astype(np.float32), err_msg=name, **CHAIN)

    cluster_argv = [*common, "--cluster", "--k", "8", "--num_images", "8", "--num_clusters", "2",
                    "--num_components", "2"]
    ranks = _run_ranks(str(tmp_path / "cluster"), draws, "parallel", [cluster_argv] * 2, torchrun=True)
    emb, jemb = (_pickles(join(c, "embeddings", "dift-161")) for c in (cache, jcache))
    assert sorted(emb) == sorted(jemb) and len(jemb) == 8
    for name, w in jemb.items():
        assert emb[name].shape == w.shape
        np.testing.assert_allclose(emb[name], w, err_msg=name, **TOL)
    assert sorted(os.path.relpath(p, cache) for p in ranks[0]["written"]) == sorted(
        [join("clusters", "all.pkl")] + [join("embeddings", "dift-161", n) for n in emb]) and ranks[1]["written"] == []
    assert [r["kmeans_calls"] for r in ranks] == [len(rec.inits)] * 2 == [10] * 2
    parent = join("images", "clusters", "8", "2", "ranked", "dift-161")
    assert _crops(join(cache, parent)) == _crops(join(jcache, parent)) and len(_crops(join(cache, parent))) == 8
