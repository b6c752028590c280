#!/bin/bash
# Evaluate temperature-scaled model on new classes.
# usage: base2new_scaling_test.sh TRAINER CFG DATASET DATA SHOTS SEED LOADEP CALIBRATION_CFG
TRAINER=$1; CFG=$2; DATASET=$3; DATA=$4; SHOTS=$5; SEED=$6; LOADEP=$7; CALIBRATION_CFG=$8
SUB=new
COMMON_DIR=${DATASET}/shots_${SHOTS}/${TRAINER}/${CFG}/seed${SEED}
MODEL_DIR=output/base2new/train_base/${COMMON_DIR}
DIR=output/base2new/test_${SUB}/${COMMON_DIR}
echo "Evaluating model"
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
  --base-dir "${MODEL_DIR}" \
  --output-dir "${DIR}" \
  --model-dir "${MODEL_DIR}" \
  --load-epoch "${LOADEP}" \
  --eval-only \
  --device "${DEVICE:-cuda}" \
  DATASET.NUM_SHOTS "${SHOTS}" \
  DATASET.SUBSAMPLE_CLASSES ${SUB}
