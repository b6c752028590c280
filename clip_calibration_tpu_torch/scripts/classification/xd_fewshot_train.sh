#!/bin/bash
# Cross-dataset: train on ImageNet (all classes).
# usage: xd_fewshot_train.sh TRAINER CFG DATA SHOTS SEED [CALIBRATION_CFG]
TRAINER=$1; CFG=$2; DATA=$3; SHOTS=$4; SEED=$5; CALIBRATION_CFG=$6
DIR=output/xd/xd_train/${TRAINER}/${CFG}/imagenet/shots_${SHOTS}/seed${SEED}
if [ -d "$DIR" ]; then
  echo "Results are available in ${DIR}."
  exit 0
fi
echo "Run this job and save the output to ${DIR}"
python -m clip_calibration_tpu_torch.train \
  --root "${DATA}" \
  --seed "${SEED}" \
  --trainer "${TRAINER}" \
  --dataset-config-file configs/datasets/imagenet.yaml \
  --config-file configs/trainers/${TRAINER}/${CFG}.yaml \
  --calibration-config "${CALIBRATION_CFG}" \
  --output-dir "${DIR}" \
  --device "${DEVICE:-cuda}" \
  DATASET.NUM_SHOTS "${SHOTS}" \
  DATASET.SUBSAMPLE_CLASSES all
