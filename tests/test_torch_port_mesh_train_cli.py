"""``finetune`` over a mesh through the port's CLI on the CPU: gloo ranks
(``--coordinator_address``) at tiny widths in float32, against the port's
one process on the same global batches (tests/test_torch_port_mesh_train.py
holds the steps to the JAX package):

  * ``--mesh_dp 2``, 2 optimizer steps: the same step count and losses; one
    ``checkpoint-N`` a step, one export and one ``metrics.jsonl``, each
    written by rank 0 alone; the checkpoint in the one-process format; the
    parameters and EMA to tests/test_torch_port_finetune.py's criterion
    (within 2·lr, 99% within 1e-3·lr);
  * a dp 2 checkpoint resumed by one process finishes as the uninterrupted
    run does (the same criterion);
  * a one-process checkpoint resumed at ``--mesh_fsdp 2`` (AdamW and 8-bit
    Adam) finishes bit for bit as the uninterrupted one-process run: the
    checkpoint's parameters, EMA and optimizer state, gathered by rank 0
    into the one-process format, and the export.

A rank is a subprocess running the CLI (it imports no JAX) and recording
what it wrote.
"""
import json
import os
import shutil
import socket
import subprocess
import sys
from os.path import join

import numpy as np
import pytest
import torch
from PIL import Image

from diffmining_tpu_torch.__main__ import main as port_cli
from diffmining_tpu_torch.models.clip import TINY_CLIP_TEXT
from diffmining_tpu_torch.models.unet import TINY_UNET
from diffmining_tpu_torch.models.vae import TINY_VAE
from diffmining_tpu_torch.typicality.compute import SD
from diffmining_tpu_torch.utils.export import save_pipeline_dir
from diffmining_tpu_torch.utils.weights import load_pipeline_dir

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
RANK_TIMEOUT_S = 240

# One rank: argv OUT ARGS. Runs the finetune command with ARGS and writes to
# OUT (JSON) the files it saved with torch.save, the pipeline dirs it
# exported and the metrics files it opened.
RANK = r"""
import json, sys
import torch
torch.set_num_threads(1)
from diffmining_tpu_torch.__main__ import main
from diffmining_tpu_torch.finetuning import base

out, args = sys.argv[1], sys.argv[2:]
wrote = {"torch.save": [], "export": [], "metrics": []}
save, export, metrics = torch.save, base.save_pipeline_dir, base.MetricsLogger
base.torch.save = lambda obj, path, *a, **k: (wrote["torch.save"].append(str(path)), save(obj, path, *a, **k))
base.save_pipeline_dir = lambda path, *a, **k: (wrote["export"].append(path), export(path, *a, **k))
base.MetricsLogger = lambda path, *a, **k: (wrote["metrics"].append(path), metrics(path, *a, **k))[1]
main(["finetune", *args])
with open(out, "w") as f:
    json.dump(wrote, f)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_ranks(tmp_path, tag, argv, n=2):
    """``n`` ranks of ``finetune ARGV`` as a gloo group; returns the
    processes and their record files."""
    address = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    logs = [str(tmp_path / f"{tag}{r}.json") for r in range(n)]
    procs = [subprocess.Popen([sys.executable, "-c", RANK, logs[r], *argv, "--coordinator_address", address,
                               "--num_processes", str(n), "--process_id", str(r)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(n)]
    return procs, logs


def _wait(procs, logs):
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [json.load(open(log)) for log in logs]


@pytest.fixture(scope="module")
def base_dir(tmp_path_factory):
    """A tiny float32 pipeline dir drawn from a seed and exported by the
    port."""
    out = str(tmp_path_factory.mktemp("pipe"))
    sd = SD.init_random("ftt", [], TINY_UNET, TINY_VAE, TINY_CLIP_TEXT, seed=5, dtype=torch.float32, device="cpu")
    save_pipeline_dir(out, sd.unet.config, sd.unet.state_dict(), sd.vae.config, sd.vae.state_dict(), sd.clip.config,
                      sd.clip.state_dict(), sd.schedule)
    return out


@pytest.fixture(scope="module")
def ftt_data(tmp_path_factory):
    """Two decades x 4 images: two global batches of 4 an epoch."""
    root = tmp_path_factory.mktemp("ftt")
    rng = np.random.RandomState(18)
    for dec in ("1930", "1990"):
        os.makedirs(root / dec)
        for i in range(4):
            Image.fromarray(rng.randint(0, 255, (36, 36, 3), dtype=np.uint8)).save(root / dec / f"f{dec}_{i}.png")
    return str(root)


def _argv(base_dir, data, out, *extra):
    return ["--which", "ftt", "--base_name_or_path", base_dir, "--data_path", data, "--output_dir", out,
            "--train_batch_size", "4", "--max_train_steps", "2", "--checkpointing_steps", "1", "--resolution", "32",
            "--learning_rate", str(LR), "--mixed_precision", "no", "--use_ema", "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def one_process(base_dir, ftt_data, tmp_path_factory):
    """The port's one process, 2 steps, AdamW and 8-bit Adam: {optimizer:
    output dir}."""
    outs = {}
    for opt, extra in (("adamw", ()), ("8bit", ("--use_8bit_adam",))):
        outs[opt] = str(tmp_path_factory.mktemp(f"one_{opt}"))
        port_cli(["finetune", *_argv(base_dir, ftt_data, outs[opt], *extra)])
    return outs


def _state(out, step):
    return torch.load(join(out, f"checkpoint-{step}", "state.pt"), map_location="cpu", weights_only=True)


def _losses(out):
    with open(join(out, "logs", "metrics.jsonl")) as f:
        return [(r["step"], r["train_loss"]) for r in map(json.loads, f)]


def _structure(tree):
    """A checkpoint's keys, list lengths, tensor shapes and dtypes."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    return type(tree)


def _assert_step_close(got, want):
    diffs = torch.cat([(got[k] - w).detach().abs().flatten() for k, w in want.items()])
    assert float(diffs.max()) <= 2 * LR + 1e-6
    assert float((diffs <= 1e-3 * LR).float().mean()) >= 0.99


def _assert_equal_trees(got, want, path="state"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_equal_trees(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal_trees(g, w, f"{path}[{i}]")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    else:
        assert got == want, path


def test_finetune_mesh_dp_2_writes_once_and_matches_one_process(base_dir, ftt_data, one_process, tmp_path):
    """Two ranks of ``finetune --mesh_dp 2``: the one process's step count
    and losses (the dp mean, within rtol 1e-5), checkpoints in its format
    with parameters and EMA to the one-process criterion, and every file
    written by rank 0 alone; then one process resumes the dp 2
    checkpoint-1 and finishes as the uninterrupted run."""
    one = one_process["adamw"]
    out = str(tmp_path / "dp2")
    wrote = _wait(*_start_ranks(tmp_path, "dp2_", _argv(base_dir, ftt_data, out, "--mesh_dp", "2")))
    assert sorted(d for d in os.listdir(out) if d.startswith("checkpoint")) == ["checkpoint-1", "checkpoint-2"]
    assert [len(w["torch.save"]) for w in wrote] == [2, 0]
    assert [w["export"] for w in wrote] == [[join(out, "export")], []]
    assert [len(w["metrics"]) for w in wrote] == [1, 0]
    got, want = _losses(out), _losses(one)
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2]
    np.testing.assert_allclose([x for _, x in got], [x for _, x in want], rtol=1e-5)
    with open(join(out, "trainer_args.json")) as f:
        assert json.load(f)["mesh_dp"] == 2
    for step in (1, 2):
        g, w = _state(out, step), _state(one, step)
        assert _structure(g) == _structure(w) and g["step"] == w["step"] == step
        _assert_step_close(g["params"], w["params"])
        _assert_step_close(g["ema_params"], w["ema_params"])
    exported = load_pipeline_dir(join(out, "export"))["unet"]["state_dict"]
    ema = _state(out, 2)["ema_params"]
    assert all(torch.equal(exported[k], v) for k, v in ema.items())

    # one process resumes the dp 2 run at step 1 and takes step 2
    resumed = str(tmp_path / "resumed")
    os.makedirs(resumed)
    shutil.copytree(join(out, "checkpoint-1"), join(resumed, "checkpoint-1"))
    port_cli(["finetune", *_argv(base_dir, ftt_data, resumed, "--resume_from_checkpoint", "latest")])
    g, w = _state(resumed, 2), _state(one, 2)
    assert _structure(g) == _structure(w) and g["step"] == 2 and g["adam"]["count"] == 2
    _assert_step_close(g["params"], w["params"])
    _assert_step_close(g["ema_params"], w["ema_params"])


@pytest.mark.parametrize("opt", ["adamw", "8bit"])
def test_one_process_checkpoint_resumes_at_fsdp_2_bit_for_bit(base_dir, ftt_data, one_process, tmp_path, opt):
    """Two ranks of ``finetune --mesh_fsdp 2`` resume the one process's
    checkpoint-1 (each copying in its pieces of the moments, or of the int8
    blocks and scales, and of the EMA) and take step 2: the checkpoint-2
    that rank 0 gathers is the uninterrupted one-process run's bit for bit,
    and so is the export."""
    one = one_process[opt]
    out = str(tmp_path / "fsdp2")
    os.makedirs(out)
    shutil.copytree(join(one, "checkpoint-1"), join(out, "checkpoint-1"))
    extra = ("--use_8bit_adam",) if opt == "8bit" else ()
    wrote = _wait(*_start_ranks(tmp_path, "fsdp2_", _argv(base_dir, ftt_data, out, "--mesh_fsdp", "2",
                                                            "--resume_from_checkpoint", "latest", *extra)))
    assert [len(w["torch.save"]) for w in wrote] == [1, 0]
    _assert_equal_trees(_state(out, 2), _state(one, 2))
    assert [s for s, _ in _losses(out)] == [2]
    got = load_pipeline_dir(join(out, "export"))["unet"]["state_dict"]
    want = load_pipeline_dir(join(one, "export"))["unet"]["state_dict"]
    assert set(got) == set(want) and all(torch.equal(got[k], v) for k, v in want.items())
