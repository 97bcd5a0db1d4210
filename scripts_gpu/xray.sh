#!/usr/bin/env bash
# X-ray finetune + localization eval on the GPU, through the PyTorch port (the GPU
# twin of the TPU xray.sh, which mirrors reference scripts/xray.sh).
set -e
BASE="${BASE:-models/sd-v1-5}"
DEVICE="${DEVICE:-cuda}"  # cuda | cpu, passed as --device: the part JAX_PLATFORMS plays for the TPU scripts
python -m diffmining_tpu_torch.finetuning.xray --base_name_or_path "$BASE" --data_path dataset/CXR8/ --train_batch_size 8 --output_dir models/xray --num_train_epochs 100 --device "$DEVICE"
# the output dir is -o (--output_path): the TPU xray.sh's -t names no flag of either package's xray CLI
python -m diffmining_tpu_torch.applications.xray -o results/xray -m models/xray -i dataset/CXR8 --device "$DEVICE"
