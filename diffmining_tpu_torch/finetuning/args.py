"""Training flags: the same surface as diffmining_tpu/finetuning/args.py (the
reference's parser_base, diffmining/finetuning/args.py:4-254), plus
``--device``; ``trainer_mesh`` turns the mesh flags into the trainer's mesh
(one process a GPU, under torchrun). The reference's dead and hub-only
flags are accepted and inert, so its launch scripts parse.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

from diffmining_tpu_torch.parallel.mesh import Mesh, cli_mesh


def parser_base() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SD finetuning (PyTorch/CUDA)")
    # model / data
    p.add_argument("--base_name_or_path", type=str, default="runwayml/stable-diffusion-v1-5",
                   help="pipeline dir with SD weights (diffusers layout)")
    p.add_argument("--clip_path", type=str, default=None,
                   help="override text-encoder dir (e.g. StreetCLIP for geo)")
    p.add_argument("--data_path", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="sd-model-finetuned")
    p.add_argument("--cache_dir", type=str, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    # training
    p.add_argument("--train_batch_size", type=int, default=8)
    p.add_argument("--num_train_epochs", type=int, default=100)
    p.add_argument("--max_train_steps", type=int, default=None)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--gradient_accumulation_dtype", type=str, default="f32", choices=["f32", "bf16"],
                   help="storage dtype of the gradient accumulator (bf16 halves it)")
    p.add_argument("--gradient_checkpointing", action="store_true",
                   help="recompute UNet blocks in the backward (torch.utils.checkpoint)")
    p.add_argument("--gradient_checkpointing_policy", type=str, default="full",
                   choices=["full", "attn", "dots"],
                   help="full=every block; attn=transformer blocks only; dots=both, keeping "
                        "matmul and convolution outputs (models/unet.py)")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--scale_lr", action="store_true",
                   help="scale lr by grad accumulation x batch (reference base.py:209)")
    p.add_argument("--lr_scheduler", type=str, default="constant",
                   choices=["constant", "linear", "cosine", "constant_with_warmup",
                            "cosine_with_restarts", "polynomial"])
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--ema_decay", type=float, default=0.9999)
    p.add_argument("--non_ema_revision", type=str, default=None)
    # optimizer (reference args.py:155-158)
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_weight_decay", type=float, default=1e-2)
    p.add_argument("--adam_epsilon", type=float, default=1e-08)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--use_8bit_adam", action="store_true",
                   help="int8 Adam moments in 256-element blocks (ops/optim8bit.py)")
    # precision / hardware
    p.add_argument("--mixed_precision", type=str, default="bf16", choices=["no", "fp16", "bf16"],
                   help="bf16/fp16: bf16 autocast over float32 master weights; no: float32 throughout "
                        "(on the GPU through the float32 flash kernels, forward and backward)")
    p.add_argument("--allow_tf32", action="store_true", help="inert")
    p.add_argument("--xformers", action="store_true", help="inert: attention kernels are built in")
    p.add_argument("--enable_xformers_memory_efficient_attention", action="store_true")
    p.add_argument("--local_rank", type=int, default=-1)
    p.add_argument("--dataloader_num_workers", type=int, default=4, help="inert: one loader thread")
    p.add_argument("--mesh_dp", type=int, default=None,
                   help="data-parallel size (default under a process group: gcd(train_batch_size, ranks // fsdp))")
    p.add_argument("--mesh_fsdp", type=int, default=1,
                   help="shard the optimizer state and the EMA over this many ranks (mesh_dp x mesh_fsdp = ranks)")
    p.add_argument("--distributed", action="store_true",
                   help="join the process group torchrun describes (one process a GPU)")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of the group's rendezvous, with --num_processes and --process_id")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    # lora
    p.add_argument("--lora", action="store_true",
                   help="train rank-r factors of the attention projections on a frozen UNet")
    p.add_argument("--lora_rank", type=int, default=4)
    # checkpoint / logging
    p.add_argument("--checkpointing_steps", type=int, default=None)
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    p.add_argument("--logging_steps", type=int, default=None)
    p.add_argument("--logging_dir", type=str, default="logs")
    p.add_argument("--report_to", type=str, default="tensorboard", help="inert: metrics go to JSONL")
    p.add_argument("--tracker_project_name", type=str, default="sd-finetune")
    # export
    p.add_argument("--export-only", dest="export_only", action="store_true")
    p.add_argument("--export-dir", dest="export_dir", type=str, default=None)
    # reference-CLI compatibility: flags the reference declares but never
    # reads, or hub-only ones; accepted so its launch scripts parse, inert
    p.add_argument("--pretrained_model_name_or_path", type=str, default=None)
    p.add_argument("--pretrained", action="store_true")
    p.add_argument("--revision", type=str, default=None)
    p.add_argument("--tag", type=str, default=None)
    p.add_argument("--noise_offset", type=float, default=0.0)
    p.add_argument("--noise_steps", type=int, default=None)
    p.add_argument("--max_train_samples", type=int, default=None)
    p.add_argument("--val_batch_size", type=int, default=None)
    p.add_argument("--geoguessr_loss_factor", type=float, default=None)
    p.add_argument("--probabilistic_dataloader", action="store_true")
    p.add_argument("--push_to_hub", action="store_true", help="inert: no hub egress")
    p.add_argument("--hub_model_id", type=str, default=None)
    p.add_argument("--hub_token", type=str, default=None)
    # misc parity flags
    p.add_argument("--random_subset", type=int, default=None)
    p.add_argument("--num_samples_log", type=int, default=5)
    p.add_argument("--log_previews", action="store_true",
                   help="DDIM preview grids of the domain's prompts at each logging step and at the end")
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--num_inference_steps", type=int, default=50)
    return p


def trainer_mesh(args) -> Optional[Mesh]:
    """The trainer's mesh from its flags (JAX args.py:129-139 and
    base.py:88-95): ``--distributed`` or ``--coordinator_address`` join the
    process group, where ``--mesh_dp`` defaults to gcd(train_batch_size,
    ranks // mesh_fsdp). More than one rank outside a group raises, naming
    torchrun; so does a mesh that leaves ranks idle (dp x fsdp must be the
    number of processes, where JAX takes the first dp x fsdp devices) or
    whose dp does not divide the global batch. None without the flags."""
    ranks = (args.mesh_dp or 1) * args.mesh_fsdp
    if ranks > 1 and not (args.distributed or args.coordinator_address is not None):
        raise SystemExit(
            f"finetune --mesh_dp {args.mesh_dp or 1} --mesh_fsdp {args.mesh_fsdp} runs one process a GPU: launch it "
            f"as `torchrun --nproc_per_node {ranks} -m diffmining_tpu_torch finetune ... --distributed --mesh_dp "
            f"{args.mesh_dp or 1} --mesh_fsdp {args.mesh_fsdp}`"
        )
    mesh = cli_mesh("finetune", args.mesh_dp, args.device, distributed=args.distributed,
                    coordinator_address=args.coordinator_address, num_processes=args.num_processes,
                    process_id=args.process_id, mesh_fsdp=args.mesh_fsdp, batch=args.train_batch_size)
    if mesh is not None and mesh.dp * mesh.fsdp != mesh.world:
        raise SystemExit(
            f"finetune over dp {mesh.dp} x fsdp {mesh.fsdp} would leave {mesh.world - mesh.dp * mesh.fsdp} of the "
            f"{mesh.world} processes idle: give --mesh_dp and --mesh_fsdp whose product is the number of processes"
        )
    if mesh is not None and args.train_batch_size % mesh.dp:
        raise SystemExit(f"--train_batch_size {args.train_batch_size} (the global batch) must divide by dp {mesh.dp}")
    return mesh


def parse_args(argv=None):
    args = parser_base().parse_args(argv)
    env_local_rank = int(os.environ.get("LOCAL_RANK", -1))
    if env_local_rank != -1 and env_local_rank != args.local_rank:
        args.local_rank = env_local_rank
    if args.non_ema_revision is not None:
        args.use_ema = True
    return args
