#!/usr/bin/env bash
# The PyTorch port's twin of scripts/infer_ref.sh (on the card; add --device cpu for the CPU).
# Mirror of the reference's infer_ref.sh: per-model reference extraction.
set -euo pipefail
exec python -m vsc22_tpu_torch.pipelines.ref_cli "$@"
