#!/usr/bin/env bash
# Doersch-2012 HOG+SVM baseline on the GPU, through the PyTorch port (the GPU twin
# of the TPU doersch.sh, which mirrors reference doersch/doersch.py CLI).
set -e
DEVICE="${DEVICE:-cuda}"  # cuda | cpu, passed as --device: the part JAX_PLATFORMS plays for the TPU scripts
python -m diffmining_tpu_torch.baselines.doersch --which "${1:-geo}" --dataset_path "$2" --category "${3:-United States}" --main_dir doersch-hog --device "${DEVICE}"
