"""Convert HF diffusers checkpoints into verified local pipeline dirs, through
the PyTorch port (the GPU twin of the TPU scripts' convert_models.py).

Replacement for the reference's hub fetchers (reference: scripts/
download-models.py + download-cardb.py use huggingface_hub snapshot_download).
Nothing is downloaded: an already-present diffusers checkpoint directory is
validated and converted:

    python scripts_gpu/convert_models.py /path/to/stable-diffusion-v1-5 out/sd-v1-5 [--device cpu]

The conversion is a load (utils/weights.load_pipeline_dir: safetensors ->
diffusers-keyed state dicts), a strict load of every state dict into the
port's modules (built on the meta device: shapes and names only, so an
unmapped or misshapen parameter fails loudly), a re-export
(utils/export.save_pipeline_dir) and the port's verify_checkpoint on the
result, on ``--device`` (cuda by default). Exits non-zero on any FAIL.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(src: str, dst: str, device: str = "cuda") -> None:
    import torch

    from diffmining_tpu_torch.models.clip import CLIPTextModel
    from diffmining_tpu_torch.models.unet import UNet2DCondition
    from diffmining_tpu_torch.models.vae import AutoencoderKL
    from diffmining_tpu_torch.utils.export import save_pipeline_dir
    from diffmining_tpu_torch.utils.weights import load_pipeline_dir, load_state

    p = load_pipeline_dir(src)
    with torch.device("meta"):
        modules = {"unet": UNet2DCondition(p["unet"]["config"]), "vae": AutoencoderKL(p["vae"]["config"]),
                   "text_encoder": CLIPTextModel(p["text_encoder"]["config"])}
    for sub, module in modules.items():
        load_state(module, p[sub]["state_dict"])
    n_params = sum(t.numel() for t in p["unet"]["state_dict"].values())
    print(f"unet: {n_params/1e6:.1f}M params; vae + text encoder loaded")
    save_pipeline_dir(
        dst,
        p["unet"]["config"], p["unet"]["state_dict"],
        p["vae"]["config"], p["vae"]["state_dict"],
        p["text_encoder"]["config"], p["text_encoder"]["state_dict"],
        p["schedule"],
        tokenizer_src_dir=p["tokenizer_dir"],
    )
    print(f"wrote pipeline to {dst}; validating (structure/forward)...")
    from diffmining_tpu_torch.utils.verify_checkpoint import main as verify

    rc = verify([dst, "--device", device])
    if rc != 0:
        raise SystemExit(rc)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="a diffusers pipeline dir")
    ap.add_argument("dst", help="where the converted pipeline dir is written")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu, for the verification")
    a = ap.parse_args()
    main(a.src, a.dst, a.device)
