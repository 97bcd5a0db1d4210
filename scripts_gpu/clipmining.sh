#!/usr/bin/env bash
# CLIP patch-ranking baseline on the GPU, through the PyTorch port (the GPU twin
# of the TPU clipmining.sh, which mirrors reference clipmining/ranking.py CLI).
#   ./scripts_gpu/clipmining.sh DATASET [CACHE] [MODE] [CLIP_DIR]
# CLIP_DIR: a CLIPModel checkpoint dir (e.g. converted StreetCLIP); omitted ->
# random towers (tests/dev only).
set -e
DEVICE="${DEVICE:-cuda}"  # cuda | cpu, passed as --device: the part JAX_PLATFORMS plays for the TPU scripts
ARGS=(--dataset "$1" --cache "${2:-clip}" --mode "${3:-diff}" --device "${DEVICE}")
if [ -n "$4" ]; then ARGS+=(--clip_dir "$4"); fi
python -m diffmining_tpu_torch.baselines.clipmining "${ARGS[@]}"
