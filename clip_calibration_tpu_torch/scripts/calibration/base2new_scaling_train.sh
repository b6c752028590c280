#!/bin/bash
# Train the temperature-scaling calibrator on a base-trained model.
# usage: base2new_scaling_train.sh TRAINER CFG DATASET DATA SHOTS SEED CALIBRATION_CFG
TRAINER=$1; CFG=$2; DATASET=$3; DATA=$4; SHOTS=$5; SEED=$6; CALIBRATION_CFG=$7
SUB=base
COMMON_DIR=${DATASET}/shots_${SHOTS}/${TRAINER}/${CFG}/seed${SEED}
DIR=output/base2new/train_base/${COMMON_DIR}
if [ -d "$DIR" ]; then
  echo "Origin results are available in ${DIR}. Begin calibration"
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
  --base-dir "${DIR}" \
  --output-dir "${DIR}" \
  --device "${DEVICE:-cuda}" \
  DATASET.NUM_SHOTS "${SHOTS}" \
  DATASET.SUBSAMPLE_CLASSES ${SUB}
