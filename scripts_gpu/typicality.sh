#!/usr/bin/env bash
# Full typicality pipeline for one domain on the GPU, through the PyTorch port
# (the GPU twin of the TPU typicality.sh, which mirrors reference scripts/typicality.sh):
#   ./scripts_gpu/typicality.sh {ftt|cars|geo|places} FT_MODEL_PATH DATA_PATH [K] [PT_MODEL_PATH]
# Runs, for each of pt (vanilla SD-v1.5) and ft (finetuned) modes:
#   submission -> GPU sweep -> mining/clustering -> figures, then one HTML
#   viewer over both.
# PT_MODEL_PATH defaults to models/sd-v1-5 (a converted vanilla SD-v1.5
# pipeline dir, reference typicality.sh MODEL_PATH_SD="runwayml/stable-diffusion-v1-5");
# the pt pass is skipped with a warning if that directory does not exist.
set -e
WHICH="$1"; FT_MODEL_PATH="$2"; DATA_PATH="$3"; k="${4:-64}"
PT_MODEL_PATH="${5:-models/sd-v1-5}"
MAIN_PATH="results/${WHICH}"
WHICH_FEATURE="${WHICH_FEATURE:-dift-161}"   # dift-{t} | clip | clip+dift-{t}
t_min="0.1"; t_max="0.7"
DEVICE="${DEVICE:-cuda}"  # cuda | cpu, passed as --device: the part JAX_PLATFORMS plays for the TPU scripts
SWEEP=(python -m diffmining_tpu_torch.typicality.compute)
# MESH_DP=N: the sweep as N processes under torchrun, one GPU each (the port's --mesh_dp > 1 needs a process group)
[ -n "${MESH_DP:-}" ] && SWEEP=(torchrun --standalone --nproc_per_node "${MESH_DP}" -m diffmining_tpu_torch.typicality.compute --distributed --mesh_dp "${MESH_DP}")
for mode in pt ft; do
  if [ "${mode}" = "pt" ]; then
    MODEL_PATH="${PT_MODEL_PATH}"
    if [ ! -e "${MODEL_PATH}/model_index.json" ]; then
      echo "typicality.sh: no vanilla SD pipeline at ${MODEL_PATH}; skipping pt mode" >&2
      continue
    fi
  else
    MODEL_PATH="${FT_MODEL_PATH}"
  fi
  TYPICALITY="${MAIN_PATH}/typicality/${mode}/${t_min}-${t_max}"
  CACHE_PATH="${MAIN_PATH}/cache/${mode}/${t_min}-${t_max}"
  SUBMISSION_PATH="${MAIN_PATH}/submission/${mode}/${t_min}-${t_max}"
  FIGURE_PATH="${MAIN_PATH}/figures/${mode}/${t_min}-${t_max}"
  # No shape-bucket warmup (the TPU scripts' warmup_buckets.py): eager PyTorch
  # compiles no per-shape program, and the kernels build once, at first use.
  "${SWEEP[@]}" --typicality_path "${TYPICALITY}" \
      -i "${DATA_PATH}" -m "${MODEL_PATH}" --submission_path "${SUBMISSION_PATH}" \
      --make_submission --sub_split 1 --which "${WHICH}" --t_min ${t_min} --t_max ${t_max} --device "${DEVICE}"
  MAIN=(python -m diffmining_tpu_torch.typicality.cluster --which "${WHICH}" --typicality_path "${TYPICALITY}" --cache_path "${CACHE_PATH}" --model_path "${MODEL_PATH}" --k "${k}" -d "${DATA_PATH}" --device "${DEVICE}")
  "${MAIN[@]}" --cluster --feature_which "${WHICH_FEATURE}"
  "${MAIN[@]}" --figure_path "${FIGURE_PATH}" --feature_which "${WHICH_FEATURE}"
done
python -m diffmining_tpu_torch.typicality.make_html "${MAIN_PATH}/figures" "${MAIN_PATH}/html"
