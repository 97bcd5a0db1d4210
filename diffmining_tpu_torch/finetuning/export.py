"""export_model: turn a training checkpoint dir into a pipeline dir on demand
(counterpart of diffmining_tpu/finetuning/export.py; the reference's
typicality/compute.py:343-362 re-invokes the trainer with --export-only, here
it is an in-process call)."""
from __future__ import annotations

import json
import os
from os.path import join
from typing import Optional


def export_model(which: str, model_path: str, base_name_or_path: Optional[str] = None, device: str = "cuda") -> str:
    """``model_path`` points at ``{output_dir}/checkpoint-{N}``; writes
    ``{model_path}-export`` as a diffusers pipeline dir and returns it. The
    base pipeline (VAE, text encoder, configs) is ``base_name_or_path``, or
    the one the run recorded in ``{output_dir}/trainer_args.json``."""
    model_path = model_path.rstrip("/")
    export_dir = model_path + "-export"
    if os.path.isfile(join(export_dir, "model_index.json")):
        return export_dir
    from diffmining_tpu_torch.finetuning.args import parse_args
    from diffmining_tpu_torch.finetuning.base import BaseTrainer

    output_dir, checkpoint = os.path.split(model_path)
    recorded = join(output_dir, "trainer_args.json")
    if base_name_or_path is None and os.path.isfile(recorded):
        with open(recorded) as f:
            base_name_or_path = json.load(f).get("base_name_or_path")
    argv = [
        "--output_dir", output_dir,
        "--resume_from_checkpoint", checkpoint,
        "--export-only",
        "--export-dir", export_dir,
        "--train_batch_size", "1",
        "--device", device,
    ]
    if base_name_or_path:
        argv += ["--base_name_or_path", base_name_or_path]
    BaseTrainer(which, parse_args(argv)).train()  # export_only: resume, then end_training
    return export_dir
