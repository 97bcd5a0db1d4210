"""Write a diffusers-layout pipeline dir (counterpart of
diffmining_tpu/utils/export.py).

The inter-stage contract of the reference (finetuning/base.py:245-259
``end_training``; read at typicality/compute.py:65-73): one directory per
component with ``config.json`` and float32 safetensors under diffusers /
transformers tensor names, ``scheduler/scheduler_config.json``,
``tokenizer/`` and ``model_index.json``. The port's modules already use
those names, so their state dicts go out as they are, through the port's
own safetensors writer. The JAX package and the port read the result.
"""
from __future__ import annotations

import json
import os
import shutil
from os.path import join
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from diffmining_tpu_torch.diffusion.schedule import Schedule
from diffmining_tpu_torch.models.clip import CLIPTextConfig
from diffmining_tpu_torch.models.unet import UNetConfig
from diffmining_tpu_torch.models.vae import VAEConfig
from diffmining_tpu_torch.utils.weights import write_safetensors


def unet_config_to_json(cfg: UNetConfig) -> Dict[str, Any]:
    down = ["CrossAttnDownBlock2D" if a else "DownBlock2D" for a in cfg.down_block_has_attn]
    up = ["CrossAttnUpBlock2D" if a else "UpBlock2D" for a in cfg.up_block_has_attn]
    return {
        "_class_name": "UNet2DConditionModel",
        "in_channels": cfg.in_channels,
        "out_channels": cfg.out_channels,
        "block_out_channels": list(cfg.block_out_channels),
        "layers_per_block": cfg.layers_per_block,
        "cross_attention_dim": cfg.cross_attention_dim,
        "attention_head_dim": cfg.num_attention_heads,  # SD-v1.5's field holds the head count
        "down_block_types": down,
        "up_block_types": up,
        "norm_num_groups": cfg.norm_num_groups,
        "freq_shift": cfg.freq_shift,
        "flip_sin_to_cos": cfg.flip_sin_to_cos,
        "sample_size": cfg.sample_size,
    }


def vae_config_to_json(cfg: VAEConfig) -> Dict[str, Any]:
    n = len(cfg.block_out_channels)
    return {
        "_class_name": "AutoencoderKL",
        "in_channels": cfg.in_channels,
        "out_channels": cfg.out_channels,
        "latent_channels": cfg.latent_channels,
        "block_out_channels": list(cfg.block_out_channels),
        "layers_per_block": cfg.layers_per_block,
        "norm_num_groups": cfg.norm_num_groups,
        "scaling_factor": cfg.scaling_factor,
        "down_block_types": ["DownEncoderBlock2D"] * n,
        "up_block_types": ["UpDecoderBlock2D"] * n,
    }


def clip_config_to_json(cfg: CLIPTextConfig) -> Dict[str, Any]:
    return {
        "architectures": ["CLIPTextModel"],
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "max_position_embeddings": cfg.max_position_embeddings,
        "hidden_act": cfg.hidden_act,
        "layer_norm_eps": cfg.layer_norm_eps,
    }


def schedule_config_to_json(s: Schedule) -> Dict[str, Any]:
    betas = s.betas.cpu().numpy()
    return {
        "_class_name": "DDPMScheduler",
        "num_train_timesteps": s.num_train_timesteps,
        "beta_start": float(np.sqrt(betas[0]) ** 2),
        "beta_end": float(betas[-1]),
        "beta_schedule": "scaled_linear",
        "prediction_type": s.prediction_type,
        "steps_offset": 1,
        "clip_sample": False,
        "set_alpha_to_one": False,
    }


def _numpy(state: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    return {k: (v.detach().float().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32))
            for k, v in state.items()}


def save_pipeline_dir(
    path: str,
    unet_config: UNetConfig,
    unet_state: Mapping[str, Any],
    vae_config: VAEConfig,
    vae_state: Mapping[str, Any],
    clip_config: CLIPTextConfig,
    clip_state: Mapping[str, Any],
    schedule: Schedule,
    tokenizer_src_dir: Optional[str] = None,
) -> None:
    """Write the pipeline dir from diffusers-keyed state dicts (torch tensors
    or numpy arrays, stored float32)."""

    def write(sub: str, cfg: Dict[str, Any], state: Mapping[str, Any], fname: str):
        os.makedirs(join(path, sub), exist_ok=True)
        with open(join(path, sub, "config.json"), "w") as f:
            json.dump(cfg, f, indent=2)
        write_safetensors(join(path, sub, fname), _numpy(state))

    write("unet", unet_config_to_json(unet_config), unet_state, "diffusion_pytorch_model.safetensors")
    write("vae", vae_config_to_json(vae_config), vae_state, "diffusion_pytorch_model.safetensors")
    write("text_encoder", clip_config_to_json(clip_config), clip_state, "model.safetensors")
    os.makedirs(join(path, "scheduler"), exist_ok=True)
    with open(join(path, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump(schedule_config_to_json(schedule), f, indent=2)
    os.makedirs(join(path, "tokenizer"), exist_ok=True)
    if tokenizer_src_dir and os.path.isfile(join(tokenizer_src_dir, "vocab.json")):
        for name in ("vocab.json", "merges.txt", "tokenizer_config.json", "special_tokens_map.json"):
            src = join(tokenizer_src_dir, name)
            if os.path.isfile(src):
                shutil.copy(src, join(path, "tokenizer", name))
    with open(join(path, "model_index.json"), "w") as f:
        json.dump(
            {
                "_class_name": "StableDiffusionPipeline",
                "_diffusers_version": "diffmining_tpu_torch-0.1.0",
                "unet": ["diffusers", "UNet2DConditionModel"],
                "vae": ["diffusers", "AutoencoderKL"],
                "text_encoder": ["transformers", "CLIPTextModel"],
                "tokenizer": ["transformers", "CLIPTokenizer"],
                "scheduler": ["diffusers", "DDPMScheduler"],
            },
            f,
            indent=2,
        )
