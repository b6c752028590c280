#!/bin/bash
# Zero-shot CLIP on base classes (feeds the base-feature cache).
# usage: base2new_zeroshot_base.sh CFG DATASET DATA SHOTS SEED [CALIBRATION_CFG]
CFG=$1; DATASET=$2; DATA=$3; SHOTS=$4; SEED=$5; CALIBRATION_CFG=$6
TRAINER=ZeroshotCLIP
SPLIT_DIR=$([ "base" = "base" ] && echo train_base || echo test_new)
DIR=output/base2new/${SPLIT_DIR}/${DATASET}/shots_${SHOTS}/${TRAINER}/${CFG}/seed${SEED}
python -m clip_calibration_tpu_torch.train \
  --root "${DATA}" \
  --seed "${SEED}" \
  --trainer ${TRAINER} \
  --dataset-config-file configs/datasets/${DATASET}.yaml \
  --config-file configs/trainers/${TRAINER}/${CFG}.yaml \
  --calibration-config "${CALIBRATION_CFG}" \
  --output-dir "${DIR}" \
  --device "${DEVICE:-cuda}" \
  DATASET.NUM_SHOTS "${SHOTS}" \
  DATASET.SUBSAMPLE_CLASSES base
