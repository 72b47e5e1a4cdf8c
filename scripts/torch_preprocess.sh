#!/usr/bin/env bash
# The PyTorch port's twin of scripts/preprocess.sh (host work only).
# Mirror of the reference's preprocess.sh: videos -> 1-fps frame store.
set -euo pipefail
VIDEOS=${1:?usage: torch_preprocess.sh VIDEOS_DIR STORE_PATH}
STORE=${2:?}
python -m vsc22_tpu_torch.pipelines.preprocess --videos "$VIDEOS" --store "$STORE" --fps 1 "${@:3}"
