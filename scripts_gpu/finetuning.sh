#!/usr/bin/env bash
# Finetune SD on each dataset on the GPU, through the PyTorch port (the GPU twin
# of the TPU finetuning.sh, which mirrors reference scripts/finetuning.sh).
# BASE is a converted SD-v1.5 pipeline dir (scripts_gpu/convert_models.py).
set -e
BASE="${BASE:-models/sd-v1-5}"
DEVICE="${DEVICE:-cuda}"  # cuda | cpu, passed as --device: the part JAX_PLATFORMS plays for the TPU scripts
python -m diffmining_tpu_torch.finetuning.geo   --base_name_or_path "$BASE" --train_batch_size 8  --num_train_epochs 100 --data_path dataset/g3/   --output_dir models/g3   --device "$DEVICE"
python -m diffmining_tpu_torch.finetuning.cars  --base_name_or_path "$BASE" --train_batch_size 64 --num_train_epochs 100 --data_path dataset/cars/ --output_dir models/cars --device "$DEVICE"
python -m diffmining_tpu_torch.finetuning.ftt   --base_name_or_path "$BASE" --train_batch_size 64 --num_train_epochs 100 --data_path dataset/ftt/  --output_dir models/ftt  --device "$DEVICE"
