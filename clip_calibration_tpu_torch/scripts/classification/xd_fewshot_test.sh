#!/bin/bash
# Cross-dataset: evaluate an ImageNet-trained model on a shifted test set.
# usage: xd_fewshot_test.sh TRAINER CFG DATASET DATA SHOTS SEED LOADEP [CALIBRATION_CFG]
TRAINER=$1; CFG=$2; DATASET=$3; DATA=$4; SHOTS=$5; SEED=$6; LOADEP=$7; CALIBRATION_CFG=$8
MODEL_DIR=output/xd/xd_train/${TRAINER}/${CFG}/imagenet/shots_${SHOTS}/seed${SEED}
DIR=output/xd/xd_test/${TRAINER}/${CFG}/${DATASET}/shots_${SHOTS}/seed${SEED}
if [ -d "$DIR" ]; then
  echo "Results are available in ${DIR}. Skip this job"
  exit 0
fi
echo "Run this job and save the output to ${DIR}"
python -m clip_calibration_tpu_torch.train \
  --root "${DATA}" \
  --seed "${SEED}" \
  --trainer "${TRAINER}" \
  --dataset-config-file configs/datasets/${DATASET}.yaml \
  --config-file configs/trainers/${TRAINER}/${CFG}.yaml \
  --calibration-config "${CALIBRATION_CFG}" \
  --output-dir "${DIR}" \
  --model-dir "${MODEL_DIR}" \
  --load-epoch "${LOADEP}" \
  --eval-only \
  --device "${DEVICE:-cuda}" \
  DATASET.NUM_SHOTS "${SHOTS}" \
  DATASET.SUBSAMPLE_CLASSES all
