#!/bin/bash
# Scaling-based calibration sweep over few-shot trainers.
# usage: fewshot_scaling.sh [DATA_DIR] [BACKBONE] [CALIBRATION] [DAC] [PROCAL]
DATA_DIR=${1:-./data}
BACKBONE=${2:-vit_b16}
CALIBRATION=${3:-TempScaling}   # TempScaling | None
DAC=${4:-true}
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
    if [ "${CALIBRATION}" == "TempScaling" ]; then
        CALIBRATION_EPOCH=20; CALIBRATION_LR='5e-2'
    elif [ "${CALIBRATION}" == "None" ]; then
        CALIBRATION_EPOCH=0; CALIBRATION_LR=0
    else
        echo "Unknown calibration: ${CALIBRATION}"; exit 1
    fi
    TRAINER_CFG=${BACKBONE}_c${N_CTX}_ep${EPOCH}_batch${BATCH_SIZE}
    CALIBRATION_CFG=ep${CALIBRATION_EPOCH}_lr${CALIBRATION_LR}
    LOADEP=${CALIBRATION_EPOCH}

    if [ "${CALIBRATION}" == "None" ]; then
        cal_cfgs='{"BASE_CALIBRATION_MODE": "scaling_based", "SCALING_CALIBRATOR_NAME": null, "SCALING_CONFIG": null, "BIN_CALIBRATOR_NAME": null, "IF_DAC": '${DAC}', "IF_PROCAL": '${PROCAL}'}'
    else
        cal_cfgs='{"BASE_CALIBRATION_MODE": "scaling_based", "SCALING_CALIBRATOR_NAME": "'"${CALIBRATION}"'", "SCALING_CONFIG": "configs/calibration/'"${CALIBRATION}"'/'"${CALIBRATION_CFG}"'.yaml", "BIN_CALIBRATOR_NAME": null, "IF_DAC": '${DAC}', "IF_PROCAL": '${PROCAL}'}'
    fi

    for dataset in "${new_class_datasets[@]}"; do
        for seed in "${seeds[@]}"; do
            bash clip_calibration_tpu_torch/scripts/calibration/base2new_scaling_train.sh ${TRAINER} ${TRAINER_CFG} ${dataset} ${DATA_DIR} ${SHOTS} ${seed} "${cal_cfgs}"
            bash clip_calibration_tpu_torch/scripts/calibration/base2new_scaling_test.sh ${TRAINER} ${TRAINER_CFG} ${dataset} ${DATA_DIR} ${SHOTS} ${seed} ${LOADEP} "${cal_cfgs}"
        done
        for keyword in "${KEYWORDS[@]}"; do
            python parse_test_res.py output/base2new/test_new/${dataset}/shots_${SHOTS}/${TRAINER}/${TRAINER_CFG} --test-log --keyword ${keyword} --calibration-config "${cal_cfgs}"
        done
    done
done
