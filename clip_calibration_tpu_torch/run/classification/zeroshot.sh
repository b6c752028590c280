#!/bin/bash
# Zero-shot CLIP over the base2new suite (also populates the
# ZeroshotCLIP base-feature caches every other run depends on).
# usage: zeroshot.sh [DATA_DIR] [BACKBONE]
DATA_DIR=${1:-./data}
BACKBONE=${2:-vit_b16}
new_class_datasets=("caltech101" "oxford_pets" "stanford_cars" "oxford_flowers" "food101" "fgvc_aircraft" "sun397" "dtd" "eurosat" "ucf101" "imagenet")
seeds=(1 2 3)
SHOTS=16
KEYWORDS=('accuracy' 'confidence' 'ece' 'mce' 'ace' 'piece')
CFG=${BACKBONE}

for dataset in "${new_class_datasets[@]}"; do
    for seed in "${seeds[@]}"; do
        bash clip_calibration_tpu_torch/scripts/classification/base2new_zeroshot_base.sh ${CFG} ${dataset} ${DATA_DIR} ${SHOTS} ${seed}
        bash clip_calibration_tpu_torch/scripts/classification/base2new_zeroshot_new.sh ${CFG} ${dataset} ${DATA_DIR} ${SHOTS} ${seed}
    done
    for keyword in "${KEYWORDS[@]}"; do
        python parse_test_res.py output/base2new/train_base/${dataset}/shots_${SHOTS}/ZeroshotCLIP/${CFG} --test-log --keyword ${keyword}
        python parse_test_res.py output/base2new/test_new/${dataset}/shots_${SHOTS}/ZeroshotCLIP/${CFG} --test-log --keyword ${keyword}
    done
done
