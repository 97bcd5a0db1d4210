"""The port's shell scripts (scripts_gpu/) on the CPU: each parses as bash;
every command they run, with their variables filled in, is accepted by the
module's own parser and carries --device where the module has the flag; no
script names the JAX package; typicality.sh runs end to end with DEVICE=cpu;
convert_models.py reaches verify_checkpoint's PASS and fails loudly on a
parameter it cannot place.

The commands are recorded by running each script with stand-ins for
``python`` and ``torchrun`` first on PATH, which write their argv to a file
and exit 0."""
import argparse
import glob
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from diffmining_tpu_torch.typicality.compute import SD
from diffmining_tpu_torch.utils.export import save_pipeline_dir
from diffmining_tpu_torch.utils.weights import read_safetensors, write_safetensors

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts_gpu")
SHELL_SCRIPTS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(SCRIPTS, "*.sh")))
ENV = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")


def test_the_mirror_is_whole():
    assert SHELL_SCRIPTS == ["clipmining.sh", "doersch.sh", "finetuning.sh", "parallel.sh", "typicality.sh",
                             "xray.sh"]
    assert os.path.isfile(os.path.join(SCRIPTS, "convert_models.py"))


@pytest.mark.parametrize("script", SHELL_SCRIPTS)
def test_script_parses_as_bash(script):
    r = subprocess.run(["bash", "-n", os.path.join(SCRIPTS, script)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("script", SHELL_SCRIPTS + ["convert_models.py"])
def test_script_names_no_jax_package(script):
    with open(os.path.join(SCRIPTS, script)) as f:
        text = f.read()
    assert not re.search(r"diffmining_tpu\.|diffmining_tpu\b(?!_torch)|scripts_tpu/|\bjax\b", text), script


STUB = """#!{python}
import json, os, sys
with open(os.environ["STUB_LOG"], "a") as f:
    f.write(json.dumps([os.path.basename(sys.argv[0])] + sys.argv[1:]) + "\\n")
"""


def record(tmp_path, script, args=(), env=()):
    """Run ``script`` with recording stand-ins for python and torchrun; the
    commands it ran, each as [program, *argv]."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    for name in ("python", "torchrun"):
        (bin_dir / name).write_text(STUB.format(python=sys.executable))
        (bin_dir / name).chmod(0o755)
    log = tmp_path / "argv.jsonl"
    log.write_text("")
    run_env = dict(ENV, PATH=f"{bin_dir}:{os.environ['PATH']}", STUB_LOG=str(log), **dict(env))
    r = subprocess.run(["bash", os.path.join(SCRIPTS, script), *args], cwd=tmp_path, env=run_env,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    return [json.loads(line) for line in log.read_text().splitlines()]


class _Parsed(Exception):
    def __init__(self, parser, namespace):
        self.parser, self.namespace = parser, namespace


def parse_with_module(module_name, argv, monkeypatch):
    """Hand ``argv`` to ``module_name``'s own entry point, stopped just after
    its parser accepted it; returns (parser, namespace). make_html takes
    positional arguments without argparse: its generate_html call stands in."""
    import importlib

    module = importlib.import_module(module_name)
    original = argparse.ArgumentParser.parse_args

    def parse_args(self, args=None, namespace=None):
        raise _Parsed(self, original(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    if module_name.endswith("make_html"):
        def generate_html(*a):
            raise _Parsed(None, a)

        monkeypatch.setattr(module, "generate_html", generate_html)
    with pytest.raises(_Parsed) as caught:
        module.main(list(argv))
    monkeypatch.undo()
    return caught.value.parser, caught.value.namespace


def module_command(cmd):
    """[program, *argv] -> (module, its argv, torchrun's argv or None)."""
    prog, argv = cmd[0], cmd[1:]
    i = argv.index("-m")
    if prog == "torchrun":
        return argv[i + 1], argv[i + 2:], argv[:i + 2]
    assert prog == "python" and i == 0, cmd
    return argv[1], argv[2:], None


CASES = {  # name: (script, arguments, environment, commands it runs)
    "typicality ft": ("typicality.sh", ["cars", "models/ft", "data/cars", "4"], {}, 4),
    "typicality pt+ft": ("typicality.sh", ["ftt", "models/ft", "data/ftt"], {"WHICH_FEATURE": "clip"}, 7),
    "typicality MESH_DP": ("typicality.sh", ["geo", "models/ft", "data/geo", "16"], {"MESH_DP": "2"}, 4),
    "finetuning": ("finetuning.sh", [], {"BASE": "models/base"}, 3),
    "xray": ("xray.sh", [], {}, 2),
    "parallel translate": ("parallel.sh", ["translate"], {"SHARD_ID": "3"}, 1),
    "parallel compute": ("parallel.sh", ["compute"], {"SUB_SPLIT": "4"}, 1),
    "parallel cluster": ("parallel.sh", ["cluster"], {}, 1),
    "clipmining": ("clipmining.sh", ["dataset/parallel"], {}, 1),
    "clipmining clip_dir": ("clipmining.sh", ["dataset/parallel", "clip", "sim", "models/clip"], {}, 1),
    "doersch": ("doersch.sh", ["ftt", "dataset/ftt", "1930"], {}, 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_script_commands_are_accepted_by_their_parsers(case, tmp_path, monkeypatch):
    script, args, env, count = CASES[case]
    if case == "typicality pt+ft":  # a vanilla pipeline dir at the default PT_MODEL_PATH
        os.makedirs(tmp_path / "models" / "sd-v1-5")
        (tmp_path / "models" / "sd-v1-5" / "model_index.json").write_text("{}")
    cmds = record(tmp_path, script, args, dict(env, DEVICE="cpu"))
    assert len(cmds) == count, cmds  # without models/sd-v1-5, typicality.sh skips the pt mode
    for cmd in cmds:
        module, argv, launcher = module_command(cmd)
        assert module.startswith("diffmining_tpu_torch."), cmd
        parser, ns = parse_with_module(module, argv, monkeypatch)
        if parser is not None and "--device" in parser._option_string_actions:
            assert ns.device == "cpu", cmd  # DEVICE reached the command
        if launcher is not None:
            from torch.distributed.run import get_args_parser

            assert case == "typicality MESH_DP"
            targs = get_args_parser().parse_args(launcher)
            assert targs.module and targs.standalone and targs.nproc_per_node == env["MESH_DP"]
            assert ns.distributed and ns.mesh_dp == int(env["MESH_DP"])
    if script == "typicality.sh":
        sweeps = [c for c in cmds if "diffmining_tpu_torch.typicality.compute" in c]
        assert all(c[0] == ("torchrun" if "MESH_DP" in env else "python") for c in sweeps)
        assert len(sweeps) == (2 if case == "typicality pt+ft" else 1)
        # the last command is the HTML viewer over both modes' figures
        assert cmds[-1][1:] == ["-m", "diffmining_tpu_torch.typicality.make_html", f"results/{args[0]}/figures",
                                f"results/{args[0]}/html"]


@pytest.fixture(scope="module")
def tiny_pipeline(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("pipe"))
    sd = SD.init_tiny("ftt", [], device="cpu")
    save_pipeline_dir(out, sd.unet.config, sd.unet.state_dict(), sd.vae.config, sd.vae.state_dict(),
                      sd.clip.config, sd.clip.state_dict(), sd.schedule)
    return out


def test_typicality_script_runs_on_the_cpu(tiny_pipeline, tmp_path):
    """DEVICE=cpu scripts_gpu/typicality.sh ftt PIPE DATA 2 end to end: the
    sweep at the CLI's defaults (N = 100, bf16, batch_images 8), the
    clustering, the figures and the HTML. The figure stage draws only
    clusters of at least 5 members (--min_row's default) among 32, so the
    script reaches the HTML only when a label has more than 32 x 4 patches:
    26 images a label, 5 patches each, of 16 px to keep the sweep short."""
    rng = np.random.RandomState(5)
    data = tmp_path / "data"
    for decade in ("1930", "1990"):
        os.makedirs(data / decade)
        for i in range(26):
            Image.fromarray(rng.randint(0, 256, (16, 16, 3), dtype=np.uint8)).save(data / decade / f"{decade}_{i}.png")
    r = subprocess.run(["bash", os.path.join(SCRIPTS, "typicality.sh"), "ftt", tiny_pipeline, str(data), "2"],
                       cwd=tmp_path, env=dict(ENV, DEVICE="cpu"), capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "skipping pt mode" in r.stderr
    res = tmp_path / "results" / "ftt"
    for decade in ("1930", "1990"):
        arts = sorted(glob.glob(str(res / "typicality" / "ft" / "0.1-0.7" / decade / "*.npy")))
        assert len(arts) == 26
        for a in arts[:3]:
            x = np.load(a)
            assert x.shape == (100, 2, 4, 8, 8) and x.dtype == np.float16 and np.isfinite(x).all()
        assert (res / "cache" / "ft" / "0.1-0.7" / "clusters" / f"{decade}.pkl").is_file()
        assert (res / "figures" / "ft" / "0.1-0.7" / "clusters" / f"{decade}_ranked.png").is_file()
    assert (res / "html" / "index.html").is_file()
    assert (res / "html" / "figures" / "ft" / "0.1-0.7" / "clusters" / "1930_ranked.png").is_file()


@pytest.mark.parametrize("fault", [None, "unmapped", "misshapen"])
def test_convert_models(tiny_pipeline, tmp_path, fault):
    """A pipeline dir converts and verify_checkpoint passes on the CPU; a
    parameter the port's modules have no place for, or one of another
    shape, fails the load before anything is written."""
    import shutil

    src = str(tmp_path / "src")
    shutil.copytree(tiny_pipeline, src)
    if fault is not None:
        path = os.path.join(src, "unet", "diffusion_pytorch_model.safetensors")
        tensors = read_safetensors(path)
        name = "conv_in.weight"
        if fault == "unmapped":
            tensors["conv_in.weight_renamed"] = tensors.pop(name)
        else:
            tensors[name] = tensors[name][:, :1]
        write_safetensors(path, tensors)
    dst = str(tmp_path / "dst")
    r = subprocess.run([sys.executable, os.path.join(SCRIPTS, "convert_models.py"), src, dst, "--device", "cpu"],
                       cwd=tmp_path, env=ENV, capture_output=True, text=True, timeout=300)
    if fault is None:
        assert r.returncode == 0, r.stdout + r.stderr
        assert "verify_checkpoint: PASS" in r.stdout and "FAIL" not in r.stdout
        for sub, fname in (("unet", "diffusion_pytorch_model"), ("vae", "diffusion_pytorch_model"),
                           ("text_encoder", "model")):
            a = read_safetensors(os.path.join(src, sub, fname + ".safetensors"))
            b = read_safetensors(os.path.join(dst, sub, fname + ".safetensors"))
            assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)
    else:
        assert r.returncode != 0
        assert ("unexpected" if fault == "unmapped" else "size mismatch") in r.stderr
        assert not os.path.exists(dst)


def test_convert_models_usage():
    r = subprocess.run([sys.executable, os.path.join(SCRIPTS, "convert_models.py")], env=ENV, capture_output=True,
                       text=True, timeout=60)
    assert r.returncode != 0 and "usage" in r.stderr
