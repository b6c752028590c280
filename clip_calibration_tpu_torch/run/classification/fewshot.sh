#!/bin/bash
# Few-shot base2new sweep: 7 trainers x 11 datasets x 3 seeds.
# usage: fewshot.sh [DATA_DIR] [BACKBONE]
DATA_DIR=${1:-./data}
BACKBONE=${2:-vit_b16}   # rn50 | vit_b32 | vit_b16 | vit_l14

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
    LOADEP=${EPOCH}
    TRAINER_CFG=${BACKBONE}_c${N_CTX}_ep${EPOCH}_batch${BATCH_SIZE}
    for dataset in "${new_class_datasets[@]}"; do
        for seed in "${seeds[@]}"; do
            bash clip_calibration_tpu_torch/scripts/classification/base2new_fewshot_train.sh ${TRAINER} ${TRAINER_CFG} ${dataset} ${DATA_DIR} ${SHOTS} ${seed}
            bash clip_calibration_tpu_torch/scripts/classification/base2new_fewshot_test.sh ${TRAINER} ${TRAINER_CFG} ${dataset} ${DATA_DIR} ${SHOTS} ${seed} ${LOADEP}
        done
        for keyword in "${KEYWORDS[@]}"; do
            python parse_test_res.py output/base2new/train_base/${dataset}/shots_${SHOTS}/${TRAINER}/${TRAINER_CFG} --test-log --keyword ${keyword}
            python parse_test_res.py output/base2new/test_new/${dataset}/shots_${SHOTS}/${TRAINER}/${TRAINER_CFG} --test-log --keyword ${keyword}
        done
    done
done
