#!/usr/bin/env bash
# The PyTorch port's twin of scripts/infer_query.sh (on the card; add --device cpu for the CPU).
# Mirror of the reference's infer_query.sh: flagship query extraction.
set -euo pipefail
exec python -m vsc22_tpu_torch.pipelines.query_cli "$@"
