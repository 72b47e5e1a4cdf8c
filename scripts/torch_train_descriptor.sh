#!/usr/bin/env bash
# The PyTorch port's twin of scripts/train_descriptor.sh (on the card; add --device cpu after WORK_DIR for the CPU).
# Mirror of the reference's train.sh / train_v106.sh: one descriptor model.
set -euo pipefail
CONFIG=${1:?usage: torch_train_descriptor.sh CONFIG STORE WORK_DIR [extra args]}
STORE=${2:?}
WORK_DIR=${3:?}
python -m vsc22_tpu_torch.train.descriptor_cli --config "$CONFIG" --store "$STORE" \
    --work_dir "$WORK_DIR" --batch_size 128 --epochs 40 --lr 5e-5 --t 0.05 \
    --entropy_weight 30 --do_ema --do_fgm "${@:4}"
