#!/usr/bin/env bash
# The PyTorch port's twin of scripts/train_matching.sh (on the card; add --device cpu for the CPU).
# Mirror of the reference's matching-track training entry.
set -euo pipefail
exec python -m vsc22_tpu_torch.train.matching_cli "$@"
