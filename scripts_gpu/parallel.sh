#!/usr/bin/env bash
# PnP translation + parallel typicality + cross-country clustering on the GPU,
# through the PyTorch port (the GPU twin of the TPU parallel.sh, which mirrors
# reference scripts/parallel.sh; SLURM arrays -> SHARD_ID env).
set -e
STAGE="$1"; MODEL_PATH="${MODEL_PATH:-models/g3/export}"
SAVE_DIR="${SAVE_DIR:-dataset/parallel}"; BASE_PATH="${BASE_PATH:-dataset/base}"
TYP="results-parallel/typicality-0.1-0.7"; SUB="results-parallel/submission"
DEVICE="${DEVICE:-cuda}"  # cuda | cpu, passed as --device: the part JAX_PLATFORMS plays for the TPU scripts
case "$STAGE" in
  translate)
    python -m diffmining_tpu_torch.applications.pnp --model_path "${MODEL_PATH}" \
        --save_dir "${SAVE_DIR}" --base_path "${BASE_PATH}" \
        --idx_start "${SHARD_ID:-0}" --batch_size 10 --device "${DEVICE}" ;;
  compute)
    python -m diffmining_tpu_torch.applications.parallel --compute --make_submission \
        -d "${SAVE_DIR}" -t "${TYP}" -c results-parallel/cache -m "${MODEL_PATH}" \
        --submission_path "${SUB}" --split_id "${SHARD_ID:-0}" --sub_split "${SUB_SPLIT:-1}" --device "${DEVICE}" ;;
  cluster)
    python -m diffmining_tpu_torch.applications.parallel --cluster \
        -d "${SAVE_DIR}" -t "${TYP}" -c results-parallel/cache -m "${MODEL_PATH}" \
        --k 64 --feature_which dift-161 --num_clusters 32 \
        --figure_path results-parallel/figures --device "${DEVICE}" ;;
  *) echo "usage: parallel.sh {translate|compute|cluster}"; exit 1 ;;
esac
