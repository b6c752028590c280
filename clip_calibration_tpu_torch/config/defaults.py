"""Default configuration tree.

Mirrors the config surface the reference stack consumes: the subset of
Dassl's ``get_cfg_default`` that the CLIP_Calibration code paths touch, plus
the full ``extend_cfg`` tree from reference ``train.py:134-269``
(per-trainer nodes and the CALIBRATION tree).  Key names and default values
match the reference so that its YAML configs and shell scripts work verbatim.
"""

from .node import CfgNode as CN


def get_cfg_default() -> CN:
    cfg = CN()

    cfg.VERSION = 1
    cfg.OUTPUT_DIR = "./output"
    cfg.RESUME = ""
    cfg.SEED = -1
    cfg.USE_CUDA = True  # kept for CLI compat; means "use accelerator (TPU)"
    cfg.VERBOSE = True

    # ------------------------------------------------------------------ input
    cfg.INPUT = CN()
    cfg.INPUT.SIZE = (224, 224)
    cfg.INPUT.INTERPOLATION = "bilinear"
    cfg.INPUT.TRANSFORMS = ()
    cfg.INPUT.NO_TRANSFORM = False
    cfg.INPUT.PIXEL_MEAN = [0.485, 0.456, 0.406]
    cfg.INPUT.PIXEL_STD = [0.229, 0.224, 0.225]
    cfg.INPUT.CROP_PADDING = 4
    cfg.INPUT.RRCROP_SCALE = (0.08, 1.0)
    cfg.INPUT.CUTOUT_N = 1
    cfg.INPUT.CUTOUT_LEN = 16
    cfg.INPUT.GN_MEAN = 0.0
    cfg.INPUT.GN_STD = 0.15
    cfg.INPUT.RANDAUGMENT_N = 2
    cfg.INPUT.RANDAUGMENT_M = 10
    cfg.INPUT.COLORJITTER_B = 0.4
    cfg.INPUT.COLORJITTER_C = 0.4
    cfg.INPUT.COLORJITTER_S = 0.4
    cfg.INPUT.COLORJITTER_H = 0.1
    cfg.INPUT.RGS_P = 0.2
    cfg.INPUT.GB_P = 0.5
    cfg.INPUT.GB_K = 21

    # ---------------------------------------------------------------- dataset
    cfg.DATASET = CN()
    cfg.DATASET.ROOT = ""
    cfg.DATASET.NAME = ""
    cfg.DATASET.SOURCE_DOMAINS = ()
    cfg.DATASET.TARGET_DOMAINS = ()
    cfg.DATASET.NUM_LABELED = -1
    cfg.DATASET.NUM_SHOTS = -1
    cfg.DATASET.VAL_PERCENT = 0.1
    cfg.DATASET.STL10_FOLD = -1
    cfg.DATASET.CIFAR_C_TYPE = ""
    cfg.DATASET.CIFAR_C_LEVEL = 1
    cfg.DATASET.ALL_AS_UNLABELED = False
    cfg.DATASET.SUBSAMPLE_CLASSES = "all"  # all, base or new

    # ------------------------------------------------------------- dataloader
    cfg.DATALOADER = CN()
    cfg.DATALOADER.NUM_WORKERS = 4
    cfg.DATALOADER.K_TRANSFORMS = 1
    cfg.DATALOADER.RETURN_IMG0 = False
    # repo-only: JPEG decode-time downscaling (libjpeg draft mode) in the
    # host loader's EVAL/VAL paths — 2-4x faster decode, pixel values
    # differ slightly from a full decode so it is OFF for parity-exact
    # runs; the train loader never drafts (RandomResizedCrop would
    # upsample low-detail crops — data/loader.py)
    cfg.DATALOADER.JPEG_DRAFT = False
    # decoded-image RAM cache for the train/val loaders (MB; 0 = off).
    # Batches are bit-identical either way — the cache holds post-decode
    # RGB arrays, the random crop/flip still runs per epoch — so it is
    # ON by default, sized for the few-shot protocol's ~1.6k images
    # (data/loader.py::DataLoader._decoded; inserts stop at the cap)
    cfg.DATALOADER.DECODE_CACHE_MB = 512
    cfg.DATALOADER.TRAIN_X = CN()
    cfg.DATALOADER.TRAIN_X.SAMPLER = "RandomSampler"
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 32
    cfg.DATALOADER.TRAIN_X.N_DOMAIN = 0
    cfg.DATALOADER.TRAIN_X.N_INS = 16
    cfg.DATALOADER.TRAIN_U = CN()
    cfg.DATALOADER.TRAIN_U.SAME_AS_X = True
    cfg.DATALOADER.TRAIN_U.SAMPLER = "RandomSampler"
    cfg.DATALOADER.TRAIN_U.BATCH_SIZE = 32
    cfg.DATALOADER.TRAIN_U.N_DOMAIN = 0
    cfg.DATALOADER.TRAIN_U.N_INS = 16
    cfg.DATALOADER.TEST = CN()
    cfg.DATALOADER.TEST.SAMPLER = "SequentialSampler"
    cfg.DATALOADER.TEST.BATCH_SIZE = 32

    # ------------------------------------------------------------------ model
    cfg.MODEL = CN()
    cfg.MODEL.INIT_WEIGHTS = ""
    # compute precision for trainers without their own PREC knob
    # (ZeroshotCLIP + the zero-shot text encoder): "bf16" on TPU, "fp32"
    # mirrors the reference's model.float() on CPU (clip/clip.py:130-135)
    cfg.MODEL.PRECISION = "bf16"
    cfg.MODEL.BACKBONE = CN()
    cfg.MODEL.BACKBONE.NAME = ""
    cfg.MODEL.BACKBONE.PRETRAINED = True
    cfg.MODEL.HEAD = CN()
    cfg.MODEL.HEAD.NAME = ""
    cfg.MODEL.HEAD.HIDDEN_LAYERS = ()
    cfg.MODEL.HEAD.ACTIVATION = "relu"
    cfg.MODEL.HEAD.BN = True
    cfg.MODEL.HEAD.DROPOUT = 0.0

    # -------------------------------------------------------------- optimizer
    cfg.OPTIM = CN()
    cfg.OPTIM.NAME = "adam"
    cfg.OPTIM.LR = 0.0003
    cfg.OPTIM.WEIGHT_DECAY = 5e-4
    cfg.OPTIM.MOMENTUM = 0.9
    cfg.OPTIM.SGD_DAMPNING = 0
    cfg.OPTIM.SGD_NESTEROV = False
    cfg.OPTIM.RMSPROP_ALPHA = 0.99
    cfg.OPTIM.ADAM_BETA1 = 0.9
    cfg.OPTIM.ADAM_BETA2 = 0.999
    cfg.OPTIM.STAGED_LR = False
    cfg.OPTIM.NEW_LAYERS = ()
    cfg.OPTIM.BASE_LR_MULT = 0.1
    cfg.OPTIM.LR_SCHEDULER = "single_step"
    cfg.OPTIM.STEPSIZE = (-1, )
    cfg.OPTIM.GAMMA = 0.1
    cfg.OPTIM.MAX_EPOCH = 10
    cfg.OPTIM.WARMUP_EPOCH = -1
    cfg.OPTIM.WARMUP_TYPE = "linear"
    cfg.OPTIM.WARMUP_CONS_LR = 1e-5
    cfg.OPTIM.WARMUP_MIN_LR = 1e-5
    cfg.OPTIM.WARMUP_RECOUNT = True

    # ------------------------------------------------------------------ train
    cfg.TRAIN = CN()
    cfg.TRAIN.CHECKPOINT_FREQ = 0
    cfg.TRAIN.PRINT_FREQ = 10
    cfg.TRAIN.COUNT_ITER = "train_x"

    # ------------------------------------------------------------------- test
    cfg.TEST = CN()
    cfg.TEST.EVALUATOR = "Classification"
    cfg.TEST.PER_CLASS_RESULT = False
    cfg.TEST.COMPUTE_CMAT = False
    cfg.TEST.NO_TEST = False
    cfg.TEST.SPLIT = "test"
    cfg.TEST.FINAL_MODEL = "last_step"

    # ---------------------------------------------------------------- trainer
    cfg.TRAINER = CN()
    cfg.TRAINER.NAME = ""
    # Beyond-reference (TPU): run the FROZEN vision tower quantized
    # during training/eval — "" (off, parity default), "int8"
    # (weight-only, halves tower HBM), or "w8a8" (static-calibrated
    # int8 matmuls on the MXU double-rate path; calibration batch is
    # drawn from the train loader at build). Only trainers whose image
    # tower takes no trainable inputs accept this (gradients never
    # traverse the tower there — CoOp/CoCoOp/KgCoOp/ProGrad/ProDA/
    # TaskRes/CLIP_Adapter/ZeroshotCLIP); MaPLe/VPT/PromptSRC raise.
    cfg.TRAINER.QUANT_FROZEN_VISION = ""

    # Beyond-reference: quantized text tower for the EVAL-time class
    # fan-outs — "" (off, parity-exact), "int8" (weight-only) or
    # "w8a8" (static scales calibrated on the trainer's own learned
    # prompt rows). Eval runs no gradients, so the per-request text
    # encodes can take the int8 MXU path the training step cannot
    # (prompt gradients flow through the text tower). Only trainers
    # that re-run the text tower per eval request accept this
    # (CoCoOp's per-image encodes, ProDA's set_classifier sweep);
    # one-shot class-feature trainers raise.
    cfg.TRAINER.QUANT_EVAL_TEXT = ""

    # ======================================================================
    # extend_cfg equivalents (reference train.py:134-269)
    # ======================================================================

    # CoOp
    cfg.TRAINER.COOP = CN()
    cfg.TRAINER.COOP.N_CTX = 16
    cfg.TRAINER.COOP.CSC = False
    cfg.TRAINER.COOP.CTX_INIT = ""
    cfg.TRAINER.COOP.PREC = "fp16"
    cfg.TRAINER.COOP.CLASS_TOKEN_POSITION = "end"

    # CoCoOp
    cfg.TRAINER.COCOOP = CN()
    cfg.TRAINER.COCOOP.N_CTX = 16
    cfg.TRAINER.COCOOP.CTX_INIT = ""
    cfg.TRAINER.COCOOP.PREC = "fp16"

    # MaPLe
    cfg.TRAINER.MAPLE = CN()
    cfg.TRAINER.MAPLE.N_CTX = 2
    cfg.TRAINER.MAPLE.CTX_INIT = "a photo of a"
    cfg.TRAINER.MAPLE.PREC = "fp16"
    cfg.TRAINER.MAPLE.PROMPT_DEPTH = 9

    # ProGrad
    cfg.TRAINER.PROGRAD = CN()
    cfg.TRAINER.PROGRAD.N_CTX = 16
    cfg.TRAINER.PROGRAD.CTX_INIT = True
    cfg.TRAINER.PROGRAD.PREC = "fp16"
    cfg.TRAINER.PROGRAD.CSC = False
    cfg.TRAINER.PROGRAD.CLASS_TOKEN_POSITION = "end"
    cfg.TRAINER.PROGRAD.LAMBDA = 1.0
    cfg.TRAINER.PROGRAD.T = 1.0
    cfg.TRAINER.PROGRAD.LOSS_NAME = "prograd"

    # KgCoOp
    cfg.TRAINER.KGCOOP = CN()
    cfg.TRAINER.KGCOOP.N_CTX = 16
    cfg.TRAINER.KGCOOP.CTX_INIT = True
    cfg.TRAINER.KGCOOP.W = 8.0
    cfg.TRAINER.KGCOOP.PREC = "fp16"
    cfg.TRAINER.KGCOOP.CSC = False
    cfg.TRAINER.KGCOOP.CLASS_TOKEN_POSITION = "end"

    # ProDA
    cfg.TRAINER.PRODA = CN()
    cfg.TRAINER.PRODA.N_CTX = 16
    cfg.TRAINER.PRODA.N_PROMPT = 32
    cfg.TRAINER.PRODA.PROMPT_BS = 4
    cfg.TRAINER.PRODA.PREC = "fp16"
    cfg.TRAINER.PRODA.ALPHA = 0.1

    # PromptSRC
    cfg.TRAINER.PROMPTSRC = CN()
    cfg.TRAINER.PROMPTSRC.N_CTX_VISION = 4
    cfg.TRAINER.PROMPTSRC.N_CTX_TEXT = 4
    cfg.TRAINER.PROMPTSRC.CTX_INIT = "a photo of a"
    cfg.TRAINER.PROMPTSRC.PREC = "fp16"
    cfg.TRAINER.PROMPTSRC.PROMPT_DEPTH_VISION = 9
    cfg.TRAINER.PROMPTSRC.PROMPT_DEPTH_TEXT = 9
    cfg.TRAINER.PROMPTSRC.TEXT_LOSS_WEIGHT = 25
    cfg.TRAINER.PROMPTSRC.IMAGE_LOSS_WEIGHT = 10
    cfg.TRAINER.PROMPTSRC.GPA_MEAN = 15
    cfg.TRAINER.PROMPTSRC.GPA_STD = 1

    # VPT (configured via YAML in the reference; node added here explicitly)
    cfg.TRAINER.VPT = CN()
    cfg.TRAINER.VPT.N_CTX_VISION = 2
    cfg.TRAINER.VPT.CTX_INIT = "a photo of a"
    cfg.TRAINER.VPT.PREC = "fp16"
    cfg.TRAINER.VPT.PROMPT_DEPTH_VISION = 1

    # TaskRes
    cfg.TRAINER.TaskRes = CN()
    cfg.TRAINER.TaskRes.N_CTX = 16
    cfg.TRAINER.TaskRes.CSC = False
    cfg.TRAINER.TaskRes.CTX_INIT = ""
    cfg.TRAINER.TaskRes.PREC = "fp16"
    cfg.TRAINER.TaskRes.CLASS_TOKEN_POSITION = "end"
    cfg.TRAINER.TaskRes.RESIDUAL_SCALE = 1.0
    cfg.TRAINER.TaskRes.ENHANCED_BASE = "none"

    # CLIP-Adapter
    cfg.TRAINER.CLIP_ADAPTER = CN()
    cfg.TRAINER.CLIP_ADAPTER.RATIO = 0.2
    cfg.TRAINER.CLIP_ADAPTER.CTX_INIT = "a photo of a"

    # ------------------------------------------------------------ calibration
    cfg.CALIBRATION = CN()
    cfg.CALIBRATION.BASE_CALIBRATION_MODE = None  # scaling_based, bin_based

    cfg.CALIBRATION.SCALING = CN()
    cfg.CALIBRATION.SCALING.IF_SCALING = False
    cfg.CALIBRATION.SCALING.BASE_DIR = ""
    cfg.CALIBRATION.SCALING.INIT_TEMP = 4.6052  # original CLIP temp
    cfg.CALIBRATION.SCALING.BASE_LEARNER = "CoOp"
    cfg.CALIBRATION.SCALING.MODE = "TempScaling"
    cfg.CALIBRATION.SCALING.BASE_EPOCH = 1
    cfg.CALIBRATION.SCALING.EPOCH = 20
    cfg.CALIBRATION.SCALING.LR = 5e-2

    cfg.CALIBRATION.P_TS = CN()
    cfg.CALIBRATION.P_TS.N_LAYERS = 2
    cfg.CALIBRATION.P_TS.N_NODES = 5
    cfg.CALIBRATION.P_TS.TOP_K_LOGITS = 10

    cfg.CALIBRATION.BIN = CN()
    cfg.CALIBRATION.BIN.BIN_CALIBRATOR_NAME = None

    cfg.CALIBRATION.DAC = CN()
    cfg.CALIBRATION.DAC.IF_DAC = False
    cfg.CALIBRATION.DAC.K = 5

    cfg.CALIBRATION.PROCAL = CN()
    cfg.CALIBRATION.PROCAL.IF_PROCAL = False
    cfg.CALIBRATION.PROCAL.IMAGE_K = 5

    cfg.CALIBRATION.METRICS = CN()
    cfg.CALIBRATION.METRICS.ECE_BINS = 10
    cfg.CALIBRATION.METRICS.PIECE_BINS = 10

    # ------------------------------------------------------ TPU-native extras
    # These have no reference counterpart; they control the TPU execution
    # plan and default to single-chip-friendly values.
    cfg.TPU = CN()
    cfg.TPU.MESH_SHAPE = ()          # () = all devices on one data axis
    cfg.TPU.MESH_AXES = ("data", "model")  # consumed by mesh_from_cfg
    cfg.TPU.DISTRIBUTED = False      # multi-host pod: jax.distributed init
    cfg.TPU.USE_PALLAS = "auto"      # auto | always | never (attention)
    cfg.TPU.PROFILE_DIR = ""         # torch.profiler Chrome trace dir
    cfg.TPU.PROFILE_STEPS = 20       # steps of epoch 0 to trace

    return cfg
