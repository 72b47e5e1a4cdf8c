#!/usr/bin/env bash
# The PyTorch port's twin of scripts/eval_descriptor.sh (on the card).
# Mirror of the reference's eval.sh: descriptor-track eval with score norm.
set -euo pipefail
Q=${1:?usage: torch_eval_descriptor.sh QUERY_NPZ REF_NPZ NOISE_NPZ OUT_DIR [GT_CSV]}
R=${2:?}; N=${3:?}; OUT=${4:?}
GT_ARGS=()
[ $# -ge 5 ] && GT_ARGS=(--ground_truth "$5" --plots)
python -m vsc22_tpu_torch.pipelines.descriptor_eval --query_features "$Q" \
    --ref_features "$R" --score_norm_features "$N" --output_path "$OUT" \
    --overwrite "${GT_ARGS[@]}"
