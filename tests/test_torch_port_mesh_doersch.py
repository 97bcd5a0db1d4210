"""The port's Doersch baseline over dp (torch.distributed, gloo on the CPU)
held to the JAX package's own dp=2 runs, on the mini dataset of
tests/test_doersch.py (two decades of three 128 px images):

  * ``dense_search`` over two gloo ranks, each searching its half of the
    detectors, against JAX's ``dense_search`` over a dp=2 mesh on the same
    shards: at K = 8, at K = 5 (padded to 6 with the last detector, the
    padding dropped) and with a fold; every detector's (score, bbox, path)
    list equal with the scores to 4 decimals, as tests/test_sharding.py
    compares JAX's sharded search with its plain one, and the same on both
    ranks;
  * ``doersch --mesh_dp 2`` as two ranks under torchrun's environment
    against JAX's ``Doersch`` over dp=2, both from one hog cache (the HOG of
    8-bit images may bin a pixel differently in the two frameworks,
    tests/test_torch_port_hog.py): the init detectors equal, every trained
    detector's accuracy equal, its hits as tests/test_torch_port_doersch.py
    compares them and its weights within the SVM's bound; every pickle and
    shard written once, by rank 0.

A rank is a subprocess that imports the port and no JAX.
"""
import json
import os
import pickle
import shutil
import socket
import subprocess
import sys
from os.path import join

import numpy as np
import pytest
import torch
from PIL import Image

from diffmining_tpu.baselines import doersch as jd
from diffmining_tpu.parallel import mesh as jmesh

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_TOL = dict(rtol=1e-5, atol=1e-6)  # tests/test_torch_port_doersch.py's
RANK_TIMEOUT_S = 150  # each subprocess's limit; a rank that loses its peer fails at the group's timeout first
CASES = {"K8": dict(K=8, top_k=3), "K5_padded": dict(K=5, top_k=3), "K8_fold": dict(K=8, top_k=5, fold=(1, 3))}

# One rank: argv OUT MODE ARGS. MODE "search": one rank of dense_search over
# a gloo group (ARGS[0] a JSON config) for every case, the results pickled to
# OUT; "doersch": the command with ARGS, OUT recording every pickle and shard
# the process wrote.
RANK = r"""
import json, pickle, sys
import numpy as np
import torch
torch.set_num_threads(1)
from diffmining_tpu_torch.baselines import doersch
from diffmining_tpu_torch.parallel import mesh as pm

out, mode, args = sys.argv[1], sys.argv[2], sys.argv[3:]
if mode == "search":
    cfg = json.loads(args[0])
    pm.initialize_distributed(cfg["address"], 2, cfg["rank"], device="cpu")
    ws, mesh = np.load(cfg["ws"]), pm.make_mesh()
    res = {name: doersch.dense_search(ws[:c["K"]], cfg["shards"], top_k=c["top_k"],
                                      fold=tuple(c["fold"]) if "fold" in c else None, mesh=mesh, device="cpu")
           for name, c in cfg["cases"].items()}
    pm.destroy()
    with open(out, "wb") as f:
        pickle.dump(res, f)
else:
    written = []
    for name in ("atomic_save_pickle", "write_safetensors"):
        save = getattr(doersch, name)
        setattr(doersch, name, lambda path, obj, save=save: (written.append(path), save(path, obj)))
    from diffmining_tpu_torch.__main__ import main
    main(["doersch", *args])
    with open(out, "w") as f:
        json.dump(dict(written=written), f)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(out_dir, mode, argvs, torchrun: bool):
    """Two ranks of RANK in MODE, one argv each, under torchrun's
    environment or not; waits for both within RANK_TIMEOUT_S, kills the
    other if one fails or hangs, and returns their OUT paths."""
    port, outs = _free_port(), [join(out_dir, f"rank{r}.out") for r in range(2)]
    procs = []
    for r, argv in enumerate(argvs):
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        if torchrun:
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                       LOCAL_WORLD_SIZE="2")
        procs.append(subprocess.Popen([sys.executable, "-c", RANK, outs[r], mode, *argv], cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        logs = [p.communicate(timeout=RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err[-3000:]
    return outs


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
def searches(mini_dataset, tmp_path_factory):
    """The JAX package's shards of all six images (blocks of two, split over
    two files) and eight random detectors; JAX's dp=2 search and the two
    ranks' of every case."""
    root = tmp_path_factory.mktemp("search")
    store = jd.FeatureStore(str(root / "cache"), str(root / "shards"))
    paths = [join(mini_dataset, d, f"d{d}_{i}.jpg") for d in ("1930", "1990") for i in range(3)]
    shards = store.build_shards(paths, "t", num_splits=2, batch_size=2)
    ws = (np.random.RandomState(0).randn(8, 2112) * 0.02).astype(np.float32)
    np.save(root / "ws.npy", ws)
    mesh = jmesh.make_mesh(dp=2, fsdp=1)
    want = {name: jd.dense_search(ws[:c["K"]], shards, top_k=c["top_k"], fold=c.get("fold"), mesh=mesh)
            for name, c in CASES.items()}
    address = f"127.0.0.1:{_free_port()}"
    cfgs = [json.dumps(dict(address=address, rank=r, ws=str(root / "ws.npy"), shards=shards, cases=CASES))
            for r in range(2)]
    outs = _run_ranks(str(root), "search", [[c] for c in cfgs], torchrun=False)
    return want, [pickle.load(open(o, "rb")) for o in outs]


def _rounded(lists):
    return [[(round(x[0], 4), x[1], x[2]) for x in hits] for hits in lists]


@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_search_over_two_ranks_matches_jax(searches, case):
    want, ranks = searches
    got = ranks[0][case]
    assert len(got) == len(want[case]) == CASES[case]["K"]
    assert all(len(h) == CASES[case]["top_k"] for h in got)
    assert _rounded(ranks[1][case]) == _rounded(got)  # every rank walks the same heaps
    assert _rounded(got) == _rounded(want[case])


def _detectors(root, c="1930"):
    d = join(root, "ftt", c, "detectors", "50")
    return {f: pickle.load(open(join(d, f), "rb")) for f in sorted(os.listdir(d))}


def _same_hits(got, want):
    """Scores equal to SCORE_TOL; the (bbox, path) of each hit equal where
    its score is clear of its neighbours by more than that (heap order may
    swap hits within rounding of each other)."""
    assert len(got) == len(want)
    sg, sw = np.asarray([g[0] for g in got]), np.asarray([w[0] for w in want])
    np.testing.assert_allclose(sg, sw, **SCORE_TOL)
    tol = SCORE_TOL["atol"] + SCORE_TOL["rtol"] * np.abs(sw)
    for i, (g, w) in enumerate(zip(got, want)):
        if all(abs(sw[i] - sw[j]) > tol[i] + tol[j] for j in (i - 1, i + 1) if 0 <= j < len(sw)):
            assert g[1:3] == w[1:3], (i, g[:3], w[:3])


def test_doersch_mesh_dp_2_under_torchrun_matches_jax(mini_dataset, tmp_path):
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    jd.Doersch(jroot, "ftt", mini_dataset, how_many=6, threshold=50, mesh=jmesh.make_mesh(dp=2, fsdp=1)).get_top(
        "1930")
    os.makedirs(join(proot, "ftt"))
    shutil.copytree(join(jroot, "ftt", "hog_cache"), join(proot, "ftt", "hog_cache"))
    argv = ["--dataset_path", mini_dataset, "--which", "ftt", "--category", "1930", "--how_many", "6", "--main_dir",
            proot, "--device", "cpu", "--mesh_dp", "2"]
    outs = _run_ranks(str(tmp_path), "doersch", [argv, argv], torchrun=True)
    written = [json.load(open(o))["written"] for o in outs]
    init = join("1930", "init_ws_42_50_6_1000_hog.pkl")
    ij, ip = (pickle.load(open(join(r, "ftt", init), "rb")) for r in (jroot, proot))
    assert [(k, p) for k, p, _ in ip] == [(k, p) for k, p, _ in ij]
    for (_, _, a), (_, _, b) in zip(ip, ij):
        np.testing.assert_array_equal(a, b)
    det_j, det_p = _detectors(jroot), _detectors(proot)
    assert list(det_p) == list(det_j) and len(det_p) == 5
    for f in det_j:
        acc_j, hits_j, _, w_j = det_j[f]
        acc_p, hits_p, _, w_p = det_p[f]
        assert acc_p == acc_j
        _same_hits(hits_p, hits_j)
        np.testing.assert_allclose(w_p, w_j, rtol=1e-4, atol=1e-5)
    assert os.path.isfile(join(proot, "ftt", "1930", "top_42_50_6_hog_final.png"))
    rel = sorted(os.path.relpath(p, join(proot, "ftt")) for p in written[0])
    assert rel == sorted(set(rel)) and written[1] == []  # each once, by rank 0
    assert sorted(p for p in rel if p.endswith(".pkl")) == sorted(
        [join("1930", f"{s}_all_42_hog.pkl") for s in ("neg", "pos")] + [init]
        + [join("1930", "detectors", "50", f) for f in det_p])
    assert [p for p in rel if p.endswith(".safetensors")]
