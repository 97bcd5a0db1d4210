"""Pipeline-dir loading, a safetensors reader, and JAX-tree conversion
(counterpart of diffmining_tpu/utils/weights.py and the rename rules of
diffmining_tpu/utils/export.py).

The port's modules keep diffusers/transformers state-dict keys, so a
pipeline dir (unet/ vae/ text_encoder/ scheduler/ tokenizer/,
model_index.json) loads with ``load_state_dict`` and no renaming. The
schedule comes from ``scheduler/scheduler_config.json``, never from
constants. ``read_safetensors`` and ``write_safetensors`` are the port's own
reader and writer (the format is an 8-byte little-endian header length, a
JSON header, then raw little-endian tensor data), so no ``safetensors``
package is needed.

``params_from_jax`` maps a flax parameter tree (of numpy arrays) of the JAX
package's UNet, VAE or CLIP text encoder to the port's state dict: the
port's own copy of ``unconvert_unet``/``unconvert_vae``/``unconvert_clip_text``
(export.py:55/81/102). The tests carry JAX parameters across with it.
"""
from __future__ import annotations

import json
import os
import re
import struct
from typing import Any, Dict, Iterable

import numpy as np
import torch

from diffmining_tpu_torch.diffusion.schedule import Schedule, make_schedule
from diffmining_tpu_torch.models.clip import CLIPTextConfig
from diffmining_tpu_torch.models.unet import UNetConfig
from diffmining_tpu_torch.models.vae import VAEConfig

StateDict = Dict[str, torch.Tensor]

_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Read every tensor of one .safetensors file as numpy (bf16 -> float32)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        raw = data[start:end]
        shape = tuple(info["shape"])
        if info["dtype"] == "BF16":
            bits = raw.view("<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32).reshape(shape)
        else:
            arr = np.array(raw.view(np.dtype(_ST_DTYPES[info["dtype"]]).newbyteorder("<")).reshape(shape))
        out[name] = arr
    return out


def write_safetensors(path: str, tensors: Dict[str, np.ndarray]) -> None:
    """Write numpy arrays as one .safetensors file (names sorted, data
    contiguous in that order, the header space-padded to 8 bytes, as the
    library writes it). Written to a temporary name and renamed into place."""
    names = sorted(tensors)
    arrays = [np.ascontiguousarray(tensors[n]) for n in names]
    codes = {np.dtype(v): k for k, v in _ST_DTYPES.items()}
    header, offset = {}, 0
    for name, a in zip(names, arrays):
        dt = a.dtype.newbyteorder("=")
        if dt not in codes:
            raise TypeError(f"safetensors: no dtype code for {name} ({a.dtype})")
        header[name] = {"dtype": codes[dt], "shape": list(a.shape), "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for a in arrays:
            f.write(a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes())
    os.replace(tmp, path)


def read_safetensors_dir(path: str) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for name in sorted(os.listdir(path)):
        if name.endswith(".safetensors"):
            out.update(read_safetensors(os.path.join(path, name)))
    if not out:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    return out


def to_state_dict(arrays: Dict[str, np.ndarray]) -> StateDict:
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)) for k, v in arrays.items()}


def load_state(module: torch.nn.Module, state: StateDict, ignore_prefixes: Iterable[str] = ()) -> None:
    """load_state_dict that raises on any missing or unexpected key, except
    tensors under ``ignore_prefixes`` (parts a later slice ports)."""
    ignore = tuple(ignore_prefixes)
    state = {k: v for k, v in state.items() if not k.startswith(ignore)}
    # transformers checkpoints may carry the position_ids buffer; it is derived
    state.pop("text_model.embeddings.position_ids", None)
    missing, unexpected = module.load_state_dict(state, strict=False)
    if missing or unexpected:
        raise KeyError(f"state dict does not fit {type(module).__name__}: missing={missing} unexpected={unexpected}")


# ---------------------------------------------------------------------------
# configs and schedule
# ---------------------------------------------------------------------------


def unet_config_from_json(cfg: Dict[str, Any]) -> UNetConfig:
    down_types = cfg.get("down_block_types", ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"])
    heads = cfg.get("attention_head_dim", 8)  # SD-v1.5's field holds the HEAD COUNT
    if isinstance(heads, (list, tuple)):
        heads = heads[0]
    return UNetConfig(
        in_channels=cfg.get("in_channels", 4),
        out_channels=cfg.get("out_channels", 4),
        block_out_channels=tuple(cfg.get("block_out_channels", (320, 640, 1280, 1280))),
        layers_per_block=cfg.get("layers_per_block", 2),
        cross_attention_dim=cfg.get("cross_attention_dim", 768),
        num_attention_heads=heads,
        down_block_has_attn=tuple("CrossAttn" in t for t in down_types),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        freq_shift=cfg.get("freq_shift", 0),
        flip_sin_to_cos=cfg.get("flip_sin_to_cos", True),
        sample_size=cfg.get("sample_size", 64),
    )


def vae_config_from_json(cfg: Dict[str, Any]) -> VAEConfig:
    return VAEConfig(
        in_channels=cfg.get("in_channels", 3),
        out_channels=cfg.get("out_channels", 3),
        latent_channels=cfg.get("latent_channels", 4),
        block_out_channels=tuple(cfg.get("block_out_channels", (128, 256, 512, 512))),
        layers_per_block=cfg.get("layers_per_block", 2),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        scaling_factor=cfg.get("scaling_factor", 0.18215),
    )


def clip_config_from_json(cfg: Dict[str, Any]) -> CLIPTextConfig:
    return CLIPTextConfig(
        vocab_size=cfg.get("vocab_size", 49408),
        hidden_size=cfg.get("hidden_size", 768),
        intermediate_size=cfg.get("intermediate_size", 3072),
        num_layers=cfg.get("num_hidden_layers", 12),
        num_heads=cfg.get("num_attention_heads", 12),
        max_position_embeddings=cfg.get("max_position_embeddings", 77),
        hidden_act=cfg.get("hidden_act", "quick_gelu"),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
    )


def schedule_from_json(cfg: Dict[str, Any]) -> Schedule:
    return make_schedule(
        num_train_timesteps=cfg.get("num_train_timesteps", 1000),
        beta_start=cfg.get("beta_start", 0.00085),
        beta_end=cfg.get("beta_end", 0.012),
        beta_schedule=cfg.get("beta_schedule", "scaled_linear"),
        prediction_type=cfg.get("prediction_type", "epsilon"),
    )


def _read_json(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        return json.load(f)


def load_pipeline_dir(path: str) -> Dict[str, Any]:
    """Read a diffusers-layout pipeline dir: unet/vae/text_encoder as
    {"config", "state_dict"} (CPU float32 tensors, diffusers keys), plus
    "schedule" and "tokenizer_dir"."""
    if not os.path.isfile(os.path.join(path, "model_index.json")):
        raise FileNotFoundError(
            f"{path} is not a diffusers pipeline dir (no model_index.json); export a "
            "finetuning checkpoint to one with finetuning/export.py export_model"
        )
    out: Dict[str, Any] = {}
    for sub, from_json in (("unet", unet_config_from_json), ("vae", vae_config_from_json),
                           ("text_encoder", clip_config_from_json)):
        d = os.path.join(path, sub)
        out[sub] = dict(config=from_json(_read_json(os.path.join(d, "config.json"))),
                        state_dict=to_state_dict(read_safetensors_dir(d)))
    out["schedule"] = schedule_from_json(_read_json(os.path.join(path, "scheduler", "scheduler_config.json")))
    out["tokenizer_dir"] = os.path.join(path, "tokenizer")
    return out


# ---------------------------------------------------------------------------
# flax tree -> state dict
# ---------------------------------------------------------------------------


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _leaf_to_torch(name: str, w: np.ndarray):
    module, leaf = name.rsplit(".", 1)
    if leaf == "kernel":
        if w.ndim == 4:
            return module + ".weight", w.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        return module + ".weight", w.transpose(1, 0)
    if leaf in ("scale", "embedding"):
        return module + ".weight", w
    if leaf == "bias":
        return module + ".bias", w
    return name, w


def _rename_unet(n: str) -> str:
    n = re.sub(r"^down_(\d+)_res_(\d+)\.", r"down_blocks.\1.resnets.\2.", n)
    n = re.sub(r"^down_(\d+)_tf_(\d+)\.", r"down_blocks.\1.attentions.\2.", n)
    n = re.sub(r"^down_(\d+)_downsample\.", r"down_blocks.\1.downsamplers.0.", n)
    n = re.sub(r"^up_(\d+)_res_(\d+)\.", r"up_blocks.\1.resnets.\2.", n)
    n = re.sub(r"^up_(\d+)_tf_(\d+)\.", r"up_blocks.\1.attentions.\2.", n)
    n = re.sub(r"^up_(\d+)_upsample\.", r"up_blocks.\1.upsamplers.0.", n)
    n = re.sub(r"^mid_res_(\d+)\.", r"mid_block.resnets.\1.", n)
    n = re.sub(r"^mid_tf\.", "mid_block.attentions.0.", n)
    n = re.sub(r"transformer_blocks_(\d+)\.", r"transformer_blocks.\1.", n)
    n = n.replace("to_out_0.", "to_out.0.")
    n = n.replace("ff.net_0_proj.", "ff.net.0.proj.")
    return n.replace("ff.net_2.", "ff.net.2.")


def _rename_vae(n: str) -> str:
    n = re.sub(r"^(encoder|decoder)\.down_(\d+)_res_(\d+)\.", r"\1.down_blocks.\2.resnets.\3.", n)
    n = re.sub(r"^(encoder|decoder)\.down_(\d+)_downsample\.", r"\1.down_blocks.\2.downsamplers.0.conv.", n)
    n = re.sub(r"^(encoder|decoder)\.up_(\d+)_res_(\d+)\.", r"\1.up_blocks.\2.resnets.\3.", n)
    n = re.sub(r"^(encoder|decoder)\.up_(\d+)_upsample\.", r"\1.up_blocks.\2.upsamplers.0.conv.", n)
    n = re.sub(r"^(encoder|decoder)\.mid_res_(\d+)\.", r"\1.mid_block.resnets.\2.", n)
    n = re.sub(r"^(encoder|decoder)\.mid_attn\.", r"\1.mid_block.attentions.0.", n)
    return n.replace(".to_out_0.", ".to_out.0.")


def _rename_clip_text(n: str) -> str:
    if n == "token_embedding.embedding":
        return "text_model.embeddings.token_embedding.embedding"
    if n == "position_embedding":
        return "text_model.embeddings.position_embedding.embedding"
    return "text_model." + re.sub(r"^layers_(\d+)\.", r"encoder.layers.\1.", n)


_RENAMES = {"unet": _rename_unet, "vae": _rename_vae, "clip_text": _rename_clip_text}


def params_from_jax(tree: Dict[str, Any], model: str) -> StateDict:
    """A flax parameter tree (``{"params": ...}`` or its inside, leaves numpy)
    of the JAX package's ``model`` ("unet", "vae" or "clip_text") -> the
    port's float32 state dict (conv HWIO -> OIHW, dense (in,out) -> (out,in),
    norm scale -> weight)."""
    rename = _RENAMES[model]
    out = {}
    for name, w in _flatten(tree.get("params", tree)).items():
        tn, tw = _leaf_to_torch(rename(name), w)
        out[tn] = torch.from_numpy(np.array(tw, dtype=np.float32, order="C"))
    return out
