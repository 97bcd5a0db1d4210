"""diffmining_tpu_torch — the PyTorch/CUDA port of diffmining_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same layout so each module's
counterpart is easy to find:

  models/       SD-v1.5 UNet (eps path), VAE encoder, CLIP text encoder, tokenizer
  diffusion/    schedule math (make_schedule, add_noise)
  ops/          attention dispatch and the hand-written CUDA flash kernel
  typicality/   the typicality sweep engine, artifact store, work queue, CLI
  utils/        pipeline-dir loading (own safetensors reader), images, artifacts

Modules are ``torch.nn.Module``s with diffusers/transformers state-dict keys,
tensors are NCHW, every random draw takes an explicit ``torch.Generator``,
and entry points run on the GPU unless the caller passes ``device="cpu"``.
The package imports neither JAX nor ``diffmining_tpu``.
"""

__version__ = "0.1.0"
