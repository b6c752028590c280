#!/bin/bash
# Bin-based calibration of zero-shot CLIP.
# usage: zeroshot_bin.sh [DATA_DIR] [BACKBONE] [BIN_NAME] [DAC] [PROCAL]
DATA_DIR=${1:-./data}
BACKBONE=${2:-vit_b16}
BIN_NAME=${3:-multi_isotonic_regression}
DAC=${4:-false}
PROCAL=${5:-false}
new_class_datasets=("caltech101" "oxford_pets" "stanford_cars" "oxford_flowers" "food101" "fgvc_aircraft" "sun397" "dtd" "eurosat" "ucf101" "imagenet")
seeds=(1 2 3)
SHOTS=16
KEYWORDS=('accuracy' 'confidence' 'ece' 'mce' 'ace' 'piece')
CFG=${BACKBONE}
cal_cfgs='{"BASE_CALIBRATION_MODE": "bin_based", "SCALING_CALIBRATOR_NAME": null, "SCALING_CONFIG": null, "BIN_CALIBRATOR_NAME": "'"${BIN_NAME}"'", "IF_DAC": '${DAC}', "IF_PROCAL": '${PROCAL}'}'
for dataset in "${new_class_datasets[@]}"; do
    for seed in "${seeds[@]}"; do
        bash clip_calibration_tpu_torch/scripts/classification/base2new_zeroshot_new.sh ${CFG} ${dataset} ${DATA_DIR} ${SHOTS} ${seed} "${cal_cfgs}"
    done
    for keyword in "${KEYWORDS[@]}"; do
        python parse_test_res.py output/base2new/test_new/${dataset}/shots_${SHOTS}/ZeroshotCLIP/${CFG} --test-log --keyword ${keyword} --calibration-config "${cal_cfgs}"
    done
done
