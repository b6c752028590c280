#!/bin/bash
# Cross-dataset: zero-shot CLIP on a shifted test set.
# usage: xd_zeroshot_test.sh CFG DATASET DATA SEED [CALIBRATION_CFG]
CFG=$1; DATASET=$2; DATA=$3; SEED=$4; CALIBRATION_CFG=$5
TRAINER=ZeroshotCLIP
DIR=output/xd/xd_test/${TRAINER}/${CFG}/${DATASET}/seed${SEED}
if [ -d "$DIR" ]; then
  echo "Results are available in ${DIR}. Skip this job"
  exit 0
fi
echo "Run this job and save the output to ${DIR}"
python -m clip_calibration_tpu_torch.train \
  --root "${DATA}" \
  --seed "${SEED}" \
  --trainer ${TRAINER} \
  --dataset-config-file configs/datasets/${DATASET}.yaml \
  --config-file configs/trainers/${TRAINER}/${CFG}.yaml \
  --calibration-config "${CALIBRATION_CFG}" \
  --output-dir "${DIR}" \
  --device "${DEVICE:-cuda}" \
  DATASET.SUBSAMPLE_CLASSES all
