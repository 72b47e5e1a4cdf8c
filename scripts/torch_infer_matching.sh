#!/usr/bin/env bash
# The PyTorch port's twin of scripts/infer_matching.sh (on the card; add --device cpu for the CPU).
# Mirror of the reference's infer.sh (matching track).
set -euo pipefail
exec python -m vsc22_tpu_torch.pipelines.matching_cli "$@"
