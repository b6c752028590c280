#!/bin/bash
# Scaling-based calibration of zero-shot CLIP.
# usage: zeroshot_scaling.sh [DATA_DIR] [BACKBONE] [DAC] [PROCAL]
DATA_DIR=${1:-./data}
BACKBONE=${2:-vit_b16}
DAC=${3:-true}
PROCAL=${4:-false}
new_class_datasets=("caltech101" "oxford_pets" "stanford_cars" "oxford_flowers" "food101" "fgvc_aircraft" "sun397" "dtd" "eurosat" "ucf101" "imagenet")
seeds=(1 2 3)
SHOTS=16
KEYWORDS=('accuracy' 'confidence' 'ece' 'mce' 'ace' 'piece')
CFG=${BACKBONE}
CALIBRATION_CFG=ep20_lr5e-2
LOADEP=20
cal_cfgs='{"BASE_CALIBRATION_MODE": "scaling_based", "SCALING_CALIBRATOR_NAME": "TempScaling", "SCALING_CONFIG": "configs/calibration/TempScaling/'"${CALIBRATION_CFG}"'.yaml", "BIN_CALIBRATOR_NAME": null, "IF_DAC": '${DAC}', "IF_PROCAL": '${PROCAL}'}'
for dataset in "${new_class_datasets[@]}"; do
    for seed in "${seeds[@]}"; do
        bash clip_calibration_tpu_torch/scripts/calibration/base2new_scaling_train.sh ZeroshotCLIP ${CFG} ${dataset} ${DATA_DIR} ${SHOTS} ${seed} "${cal_cfgs}"
        bash clip_calibration_tpu_torch/scripts/calibration/base2new_scaling_test.sh ZeroshotCLIP ${CFG} ${dataset} ${DATA_DIR} ${SHOTS} ${seed} ${LOADEP} "${cal_cfgs}"
    done
    for keyword in "${KEYWORDS[@]}"; do
        python parse_test_res.py output/base2new/test_new/${dataset}/shots_${SHOTS}/ZeroshotCLIP/${CFG} --test-log --keyword ${keyword} --calibration-config "${cal_cfgs}"
    done
done
