#!/bin/bash
# Bin-based calibration sweep (no scaling training; post-hoc only).
# usage: fewshot_bin.sh [DATA_DIR] [BACKBONE] [BIN_NAME] [DAC] [PROCAL]
DATA_DIR=${1:-./data}
BACKBONE=${2:-vit_b16}
BIN_NAME=${3:-multi_isotonic_regression}  # histogram_binning | isotonic_regression | multi_isotonic_regression
DAC=${4:-false}
PROCAL=${5:-false}

new_class_datasets=("caltech101" "oxford_pets" "stanford_cars" "oxford_flowers" "food101" "fgvc_aircraft" "sun397" "dtd" "eurosat" "ucf101" "imagenet")
seeds=(1 2 3)
SHOTS=16
TRAINERS=('CoOp' 'CoCoOp' 'KgCoOp' 'MaPLe' 'ProDA' 'ProGrad' 'PromptSRC')
KEYWORDS=('accuracy' 'confidence' 'ece' 'mce' 'ace' 'piece')

trainer_budget () {
    case $1 in
        CoOp)      EPOCH=200; BATCH_SIZE=32; N_CTX=16 ;;
        CoCoOp)    EPOCH=10;  BATCH_SIZE=1;  N_CTX=4  ;;
        KgCoOp)    EPOCH=200; BATCH_SIZE=32; N_CTX=16 ;;
        MaPLe)     EPOCH=5;   BATCH_SIZE=4;  N_CTX=2  ;;
        ProDA)     EPOCH=100; BATCH_SIZE=4;  N_CTX=16 ;;
        ProGrad)   EPOCH=100; BATCH_SIZE=32; N_CTX=16 ;;
        PromptSRC) EPOCH=50;  BATCH_SIZE=4;  N_CTX=4  ;;
        *) echo "Unknown trainer: $1"; exit 1 ;;
    esac
}

for TRAINER in "${TRAINERS[@]}"; do
    trainer_budget "${TRAINER}"
    TRAINER_CFG=${BACKBONE}_c${N_CTX}_ep${EPOCH}_batch${BATCH_SIZE}
    LOADEP=${EPOCH}
    cal_cfgs='{"BASE_CALIBRATION_MODE": "bin_based", "SCALING_CALIBRATOR_NAME": null, "SCALING_CONFIG": null, "BIN_CALIBRATOR_NAME": "'"${BIN_NAME}"'", "IF_DAC": '${DAC}', "IF_PROCAL": '${PROCAL}'}'
    for dataset in "${new_class_datasets[@]}"; do
        for seed in "${seeds[@]}"; do
            bash clip_calibration_tpu_torch/scripts/classification/base2new_fewshot_test.sh ${TRAINER} ${TRAINER_CFG} ${dataset} ${DATA_DIR} ${SHOTS} ${seed} ${LOADEP} "${cal_cfgs}"
        done
        for keyword in "${KEYWORDS[@]}"; do
            python parse_test_res.py output/base2new/test_new/${dataset}/shots_${SHOTS}/${TRAINER}/${TRAINER_CFG} --test-log --keyword ${keyword} --calibration-config "${cal_cfgs}"
        done
    done
done
