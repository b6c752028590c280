#!/bin/bash
# Train a prompt-learning trainer on base classes.
# usage: base2new_fewshot_train.sh TRAINER CFG DATASET DATA SHOTS SEED [CALIBRATION_CFG]
TRAINER=$1; CFG=$2; DATASET=$3; DATA=$4; SHOTS=$5; SEED=$6; CALIBRATION_CFG=$7
SUB=base
DIR=output/base2new/train_base/${DATASET}/shots_${SHOTS}/${TRAINER}/${CFG}/seed${SEED}
if [ -d "$DIR" ]; then
  echo "Results are available in ${DIR}. Resuming..."
else
  echo "Run this job and save the output to ${DIR}"
fi
python -m clip_calibration_tpu_torch.train \
  --root "${DATA}" \
  --seed "${SEED}" \
  --trainer "${TRAINER}" \
  --dataset-config-file configs/datasets/${DATASET}.yaml \
  --config-file configs/trainers/${TRAINER}/${CFG}.yaml \
  --calibration-config "${CALIBRATION_CFG}" \
  --output-dir "${DIR}" \
  --device "${DEVICE:-cuda}" \
  DATASET.NUM_SHOTS "${SHOTS}" \
  DATASET.SUBSAMPLE_CLASSES ${SUB}
