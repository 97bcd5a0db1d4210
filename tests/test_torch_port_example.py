"""The port's tiny example (examples/run_tiny_pipeline_torch.py) on the
CPU, held to the JAX example (examples/run_tiny_pipeline.py): all nine
stages run in one process without JAX, and the tree of files they write is
the JAX example's once the parts the draws decide are blanked out (patch
boxes, the image a mined patch comes from, cluster ranks and member
indices, detector ids). Two framework files are left out: the JAX trainer's
tensorboard event file and the port's trainer_args.json; a checkpoint's
inner layout (orbax in JAX, one state.pt in the port) is blanked too.

JAX_TREE is the listing of a run of the JAX example on the CPU (about three
minutes), normalised by ``normalize``; the slow test makes both runs and
compares them live."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
# the port's example in a process where jax and the JAX package cannot be imported
BLOCKED = (
    "import runpy, sys\n"
    "for m in ('jax', 'flax', 'optax', 'diffmining_tpu'):\n"
    "    sys.modules[m] = None\n"
    "sys.argv = [sys.argv[1]] + sys.argv[2:]\n"
    "runpy.run_path(sys.argv[0], run_name='__main__')\n"
)


def normalize(rel, root):
    """A file's path under the example's root with the draw-decided parts
    blanked; None for the two framework-only files."""
    rel = rel.replace(root.replace(os.sep, "_"), "DEMO")  # the HOG cache names its images by absolute path
    if re.match(r"models/ft/(logs/events\.out\.tfevents|trainer_args\.json)", rel):
        return None
    rel = re.sub(r"^(models/ft/checkpoint-\d+)/.*$", r"\1/STATE", rel)
    rel = re.sub(r"_\d+-\d+-\d+-\d+(\.\w+)$", r"_BOX\1", rel)
    rel = re.sub(r"(^|/)\d+-\d+-(\d+)_", r"\1R-M-\2_", rel)
    rel = re.sub(r"(^|/)\d+__hard_limit", r"\1R__hard_limit", rel)
    rel = re.sub(r"(img_\d+)_\d+_BOX", r"\1_I_BOX", rel)
    rel = re.sub(r"(detectors/\d+)/\d+_\d+\.pkl$", r"\1/ID.pkl", rel)
    return rel


def tree(root):
    out = set()
    for d, _, files in os.walk(root):
        for f in files:
            name = normalize(os.path.relpath(os.path.join(d, f), root), root)
            if name is not None:
                out.add(name)
    return out


def artifacts(root):
    """Every typicality .npy of the run: relative path -> (shape, dtype)."""
    out = {}
    for sub in ("typicality", "ptypicality"):
        for d, _, files in os.walk(os.path.join(root, sub)):
            for f in files:
                a = np.load(os.path.join(d, f))
                assert np.isfinite(a.astype(np.float32)).all(), f
                out[os.path.relpath(os.path.join(d, f), root)] = (a.shape, a.dtype)
    return out


def run_port_example(root):
    r = subprocess.run([sys.executable, "-c", BLOCKED, os.path.join(ROOT, "examples", "run_tiny_pipeline_torch.py"),
                        root, "--device", "cpu"], cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def stage_lines(stdout):
    return [line for line in stdout.splitlines() if re.match(r"\[\d\] ", line)]


def check_stages(stdout):
    lines = stage_lines(stdout)
    assert [line[:3] for line in lines] == [f"[{i}]" for i in range(9)], lines
    parallel = re.search(r"\[7\] parallel clusters: \[(.*)\]", stdout).group(1)
    assert len(parallel.split(",")) == 2  # two cross-country clusters


def test_port_example_reproduces_the_jax_tree(tmp_path):
    root = str(tmp_path / "demo")
    check_stages(run_port_example(root))
    got = tree(root)
    want = set(JAX_TREE.split())
    assert got == want, (sorted(got - want), sorted(want - got))
    arts = artifacts(root)
    assert len(arts) == 16
    for rel, (shape, dtype) in arts.items():
        n = 8 if rel.startswith("typicality") else 4  # N of the sweep and of the parallel sweep
        assert shape == (n, 2, 4, 16, 16) and dtype == np.float16, rel


@pytest.mark.slow
def test_port_example_against_a_live_jax_run(tmp_path):
    jax_root, port_root = str(tmp_path / "jax"), str(tmp_path / "port")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "examples", "run_tiny_pipeline.py"), jax_root], cwd=ROOT,
                       env=dict(ENV, JAX_PLATFORMS="cpu"), capture_output=True, text=True, timeout=1800)
    assert r.returncode == 0, r.stderr[-3000:]
    port_out = run_port_example(port_root)
    check_stages(port_out)
    assert [line[:3] for line in stage_lines(r.stdout)] == [line[:3] for line in stage_lines(port_out)]
    assert tree(port_root) == tree(jax_root)
    assert artifacts(port_root) == artifacts(jax_root)


JAX_TREE = """
cache/clusters/1930-gt_least.pkl
cache/clusters/1930.pkl
cache/clusters/1990-gt_least.pkl
cache/clusters/1990.pkl
cache/embeddings/dift-161/img_1930_I_BOX.pkl
cache/embeddings/dift-161/img_1990_I_BOX.pkl
cache/images/clusters/ranked/dift-161/1930/R-M-2_img_1930_I_BOX.png
cache/images/clusters/ranked/dift-161/1990/R-M-2_img_1990_I_BOX.png
cache/images/topk/D/1930/0.png
cache/images/topk/D/1930/1.png
cache/images/topk/D/1930/2.png
cache/images/topk/D/1930/3.png
cache/images/topk/D/1930/4.png
cache/images/topk/D/1930/5.png
cache/images/topk/D/1930/alpha-0.png
cache/images/topk/D/1930/alpha-1.png
cache/images/topk/D/1930/alpha-2.png
cache/images/topk/D/1930/alpha-3.png
cache/images/topk/D/1930/alpha-4.png
cache/images/topk/D/1930/alpha-5.png
cache/images/topk/D/1990/0.png
cache/images/topk/D/1990/1.png
cache/images/topk/D/1990/2.png
cache/images/topk/D/1990/3.png
cache/images/topk/D/1990/4.png
cache/images/topk/D/1990/5.png
cache/images/topk/D/1990/alpha-0.png
cache/images/topk/D/1990/alpha-1.png
cache/images/topk/D/1990/alpha-2.png
cache/images/topk/D/1990/alpha-3.png
cache/images/topk/D/1990/alpha-4.png
cache/images/topk/D/1990/alpha-5.png
cache/images/topk/D_least/1930/0.png
cache/images/topk/D_least/1930/1.png
cache/images/topk/D_least/1930/2.png
cache/images/topk/D_least/1930/3.png
cache/images/topk/D_least/1930/4.png
cache/images/topk/D_least/1930/5.png
cache/images/topk/D_least/1990/0.png
cache/images/topk/D_least/1990/1.png
cache/images/topk/D_least/1990/2.png
cache/images/topk/D_least/1990/3.png
cache/images/topk/D_least/1990/4.png
cache/images/topk/D_least/1990/5.png
cache/images/topk/random/1930/0.png
cache/images/topk/random/1930/1.png
cache/images/topk/random/1930/2.png
cache/images/topk/random/1930/3.png
cache/images/topk/random/1930/4.png
cache/images/topk/random/1930/5.png
cache/images/topk/random/1990/0.png
cache/images/topk/random/1990/1.png
cache/images/topk/random/1990/2.png
cache/images/topk/random/1990/3.png
cache/images/topk/random/1990/4.png
cache/images/topk/random/1990/5.png
clip_cache/diff/dfs/France__2-8-8.pkl
clip_cache/diff/dfs/Japan__2-8-8.pkl
clip_cache/diff/figures/France.png
clip_cache/diff/figures/Japan.png
clip_cache/diff/images/clusters/France/R-M-2_gt--France__a1_0_BOX.png
clip_cache/diff/images/clusters/France/R-M-2_gt--France__b2_0_BOX.png
clip_cache/diff/images/clusters/Japan/R-M-2_gt--Japan__a1_0_BOX.png
clip_cache/diff/images/clusters/Japan/R-M-2_gt--Japan__b2_0_BOX.png
doersch/ftt/1930/detectors/50/ID.pkl
doersch/ftt/1930/init_ws_42_50_6_1000_hog.pkl
doersch/ftt/1930/neg_all_42_hog.pkl
doersch/ftt/1930/pos_all_42_hog.pkl
doersch/ftt/1930/top_42_50_6_hog_final.png
doersch/ftt/hog_cache/DEMO_doersch_data_1930_d1930_0.jpg.npy
doersch/ftt/hog_cache/DEMO_doersch_data_1930_d1930_1.jpg.npy
doersch/ftt/hog_cache/DEMO_doersch_data_1930_d1930_2.jpg.npy
doersch/ftt/hog_cache/DEMO_doersch_data_1990_d1990_0.jpg.npy
doersch/ftt/hog_cache/DEMO_doersch_data_1990_d1990_1.jpg.npy
doersch/ftt/hog_cache/DEMO_doersch_data_1990_d1990_2.jpg.npy
doersch/ftt/safetensors/1930-all/0.safetensors
doersch/ftt/safetensors/1930-all/1930-all_paths.json
doersch/ftt/safetensors/1930-neg/0.safetensors
doersch/ftt/safetensors/1930-neg/1930-neg_paths.json
doersch/ftt/safetensors/1930-pos/0.safetensors
doersch/ftt/safetensors/1930-pos/1930-pos_paths.json
doersch_data/1930/d1930_0.jpg
doersch_data/1930/d1930_1.jpg
doersch_data/1930/d1930_2.jpg
doersch_data/1990/d1990_0.jpg
doersch_data/1990/d1990_1.jpg
doersch_data/1990/d1990_2.jpg
figures/ft/0.1-0.7/clusters/1930_ranked.png
figures/ft/0.1-0.7/clusters/1990_ranked.png
figures/ft/0.1-0.7/topk/1930/D.png
figures/ft/0.1-0.7/topk/1930/D_least.png
figures/ft/0.1-0.7/topk/1930/random.png
figures/ft/0.1-0.7/topk/1990/D.png
figures/ft/0.1-0.7/topk/1990/D_least.png
figures/ft/0.1-0.7/topk/1990/random.png
figures_parallel/clusters/ranked/dift-161/2/R__hard_limit_6__top_k_5__min_im_1.png
ftt/train/1930/img_1930_0.jpg
ftt/train/1930/img_1930_1.jpg
ftt/train/1930/img_1930_2.jpg
ftt/train/1930/img_1930_3.jpg
ftt/train/1990/img_1990_0.jpg
ftt/train/1990/img_1990_1.jpg
ftt/train/1990/img_1990_2.jpg
ftt/train/1990/img_1990_3.jpg
geo_base/France/France__a1_0.jpg
geo_base/France/France__b2_0.jpg
geo_base/Japan/Japan__a1_0.jpg
geo_base/Japan/Japan__b2_0.jpg
html/figures/ft/0.1-0.7/clusters/1930_ranked.png
html/figures/ft/0.1-0.7/clusters/1990_ranked.png
html/figures/ft/0.1-0.7/topk/1930/D.png
html/figures/ft/0.1-0.7/topk/1930/D_least.png
html/figures/ft/0.1-0.7/topk/1930/random.png
html/figures/ft/0.1-0.7/topk/1990/D.png
html/figures/ft/0.1-0.7/topk/1990/D_least.png
html/figures/ft/0.1-0.7/topk/1990/random.png
html/index.html
models/base/model_index.json
models/base/scheduler/scheduler_config.json
models/base/text_encoder/config.json
models/base/text_encoder/model.safetensors
models/base/unet/config.json
models/base/unet/diffusion_pytorch_model.safetensors
models/base/vae/config.json
models/base/vae/diffusion_pytorch_model.safetensors
models/ft/checkpoint-2/STATE
models/ft/checkpoint-4/STATE
models/ft/export/model_index.json
models/ft/export/scheduler/scheduler_config.json
models/ft/export/text_encoder/config.json
models/ft/export/text_encoder/model.safetensors
models/ft/export/unet/config.json
models/ft/export/unet/diffusion_pytorch_model.safetensors
models/ft/export/vae/config.json
models/ft/export/vae/diffusion_pytorch_model.safetensors
models/ft/logs/metrics.jsonl
pcache/clusters/all.pkl
pcache/embeddings/dift-161/gt--France__a1_0_BOX.pkl
pcache/embeddings/dift-161/gt--France__b2_0_BOX.pkl
pcache/embeddings/dift-161/gt--Japan__a1_0_BOX.pkl
pcache/embeddings/dift-161/gt--Japan__b2_0_BOX.pkl
pcache/images/clusters/8/2/ranked/dift-161/R-M-2_gt--France__a1_0_BOX.png
pcache/images/clusters/8/2/ranked/dift-161/R-M-2_gt--France__b2_0_BOX.png
pcache/images/clusters/8/2/ranked/dift-161/R-M-2_gt--Japan__a1_0_BOX.png
pcache/images/clusters/8/2/ranked/dift-161/R-M-2_gt--Japan__b2_0_BOX.png
ptypicality/France/France__a1_0.npy
ptypicality/France/France__b2_0.npy
ptypicality/France/gt--France__a1_0.npy
ptypicality/France/gt--France__b2_0.npy
ptypicality/Japan/Japan__a1_0.npy
ptypicality/Japan/Japan__b2_0.npy
ptypicality/Japan/gt--Japan__a1_0.npy
ptypicality/Japan/gt--Japan__b2_0.npy
submission/0.txt
translated/France/Japan__a1_0.jpg
translated/France/Japan__b2_0.jpg
translated/France/gt--France__a1_0.jpg
translated/France/gt--France__b2_0.jpg
translated/France/inverted--France__a1_0.jpg
translated/France/inverted--France__b2_0.jpg
translated/France/projected--France__a1_0.jpg
translated/France/projected--France__b2_0.jpg
translated/Japan/France__a1_0.jpg
translated/Japan/France__b2_0.jpg
translated/Japan/gt--Japan__a1_0.jpg
translated/Japan/gt--Japan__b2_0.jpg
translated/Japan/inverted--Japan__a1_0.jpg
translated/Japan/inverted--Japan__b2_0.jpg
translated/Japan/projected--Japan__a1_0.jpg
translated/Japan/projected--Japan__b2_0.jpg
typicality/1930/img_1930_0.npy
typicality/1930/img_1930_1.npy
typicality/1930/img_1930_2.npy
typicality/1930/img_1930_3.npy
typicality/1990/img_1990_0.npy
typicality/1990/img_1990_1.npy
typicality/1990/img_1990_2.npy
typicality/1990/img_1990_3.npy
"""
