"""Command-line entry point — the JAX package's ``train.py`` argument surface plus
``--device`` (default ``cuda``), so the ``run/`` and ``scripts/`` flows
carry over:

    python -m clip_calibration_tpu_torch.train --root DATA \
        --trainer CoOp --dataset-config-file configs/datasets/X.yaml \
        --config-file configs/trainers/CoOp/Y.yaml --output-dir OUT \
        [--model-dir CKPT --eval-only] [--device cuda] [opts KEY VAL ...]

Flow (reference ``train.py:278-356``): defaults -> dataset yaml -> trainer
yaml -> CLI resets -> calibration JSON -> opts -> freeze; calibrator-combo
log-file naming; the TempScaling trainer swap when the calibration JSON
asks for ``scaling_based`` with a scaling config; build the trainer from
the registry; train (checkpoints, auto-resume, final test) or, with
``--eval-only``, evaluate. Ported: ZeroshotCLIP, CoOp (train and eval,
with DAC) and TempScaling on a CoOp base.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import platform

import torch

from clip_calibration_tpu_torch.config import get_cfg_default
from clip_calibration_tpu_torch.data.base import set_random_seed
from clip_calibration_tpu_torch.engine.registry import build_trainer
from clip_calibration_tpu_torch.tools.device import resolve_device
from clip_calibration_tpu_torch.tools.logger import setup_logger

# side-effect registration (reference train.py:14-49)
import clip_calibration_tpu_torch.data.datasets  # noqa: F401
import clip_calibration_tpu_torch.evaluators.vl_evaluator  # noqa: F401
import clip_calibration_tpu_torch.trainers  # noqa: F401


def print_args(args, cfg):
    print("***************")
    print("** Arguments **")
    print("***************")
    for key in sorted(vars(args)):
        print(f"{key}: {getattr(args, key)}")
    print("************")
    print("** Config **")
    print("************")
    print(cfg)


def reset_cfg(cfg, args):
    if args.root:
        cfg.DATASET.ROOT = args.root
    if args.output_dir:
        cfg.OUTPUT_DIR = args.output_dir
    if args.resume:
        cfg.RESUME = args.resume
    if args.seed:
        cfg.SEED = args.seed
    if args.source_domains:
        cfg.DATASET.SOURCE_DOMAINS = args.source_domains
    if args.target_domains:
        cfg.DATASET.TARGET_DOMAINS = args.target_domains
    if args.transforms:
        cfg.INPUT.TRANSFORMS = args.transforms
    if args.trainer:
        cfg.TRAINER.NAME = args.trainer
    if args.backbone:
        cfg.MODEL.BACKBONE.NAME = args.backbone
    if args.head:
        cfg.MODEL.HEAD.NAME = args.head

    # always use the V-L evaluator (reference train.py:98)
    cfg.TEST.EVALUATOR = "VLClassification"

    if args.calibration_config:
        cal = json.loads(args.calibration_config)
        print(cal, "calibration_cfgs")
        if cal.get("BASE_CALIBRATION_MODE"):
            cfg.CALIBRATION.BASE_CALIBRATION_MODE = \
                cal["BASE_CALIBRATION_MODE"]
            if cal.get("SCALING_CONFIG"):
                cfg.merge_from_file(cal["SCALING_CONFIG"])
                fix_cfg_from_calibration(cfg)
                cfg.CALIBRATION.SCALING.IF_SCALING = True
            if cal.get("BIN_CALIBRATOR_NAME"):
                cfg.CALIBRATION.BIN.BIN_CALIBRATOR_NAME = \
                    cal["BIN_CALIBRATOR_NAME"]
        if args.base_dir:
            cfg.CALIBRATION.SCALING.BASE_DIR = args.base_dir
        if args.base_learner:
            cfg.CALIBRATION.SCALING.BASE_LEARNER = args.base_learner
        if cal.get("IF_DAC"):
            cfg.CALIBRATION.DAC.IF_DAC = cal["IF_DAC"]
        if cal.get("IF_PROCAL"):
            cfg.CALIBRATION.PROCAL.IF_PROCAL = cal["IF_PROCAL"]


def fix_cfg_from_calibration(cfg):
    """Swap OPTIM lr/epochs for the scaling phase
    (reference ``fix_cfg_from_calibraion``, train.py:271-274)."""
    cfg.OPTIM.LR = cfg.CALIBRATION.SCALING.LR
    cfg.CALIBRATION.SCALING.BASE_EPOCH = cfg.OPTIM.MAX_EPOCH
    cfg.OPTIM.MAX_EPOCH = cfg.CALIBRATION.SCALING.EPOCH


def setup_cfg(args):
    cfg = get_cfg_default()
    if args.dataset_config_file:
        cfg.merge_from_file(args.dataset_config_file)
    if args.config_file:
        print(args.config_file, "args.config_file")
        cfg.merge_from_file(args.config_file)
    reset_cfg(cfg, args)
    cfg.merge_from_list(args.opts)
    cfg.freeze()
    return cfg


#: TPU.USE_PALLAS values the port takes: the JAX CLI maps the same three
#: (reference train.py:130-133) to its attention backends
USE_PALLAS_VALUES = ("auto", "always", "never")


def check_use_pallas(value, device_type: str) -> None:
    """``TPU.USE_PALLAS`` on the port: ``auto`` and ``always`` run the
    attention kernels K1 and K2 (``ops/mha_qkv.py``). ``never`` asks for a
    second attention path, which the port has only on the CPU (there the
    kernels' wrappers run their plain PyTorch versions); on the card it
    raises. Any other value raises, as the JAX CLI's lookup does."""
    if value not in USE_PALLAS_VALUES:
        raise ValueError(f"TPU.USE_PALLAS must be one of "
                         f"{', '.join(USE_PALLAS_VALUES)}; got {value!r}")
    if value == "never" and device_type != "cpu":
        raise ValueError(
            "TPU.USE_PALLAS never: the port has no attention path on the "
            "card other than its kernels K1 and K2; their plain PyTorch "
            "versions serve only CPU tensors (--device cpu). Use auto or "
            "always on the card")


def main(args):
    device = resolve_device(args.device)
    # fp32 runs must be full fp32 on the card: the golden parity with the
    # reference (tests/test_golden_e2e.py) holds at fp32 and breaks at the
    # ~3 decimal digits of TF32, which cuDNN would otherwise use by default
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = setup_cfg(args)
    check_use_pallas(cfg.TPU.USE_PALLAS, device.type)
    if cfg.TPU.DISTRIBUTED:
        raise NotImplementedError(
            "multi-process runs are not ported to the torch package yet")
    if cfg.SEED >= 0:
        print(f"Setting fixed seed: {cfg.SEED}")
        set_random_seed(cfg.SEED)

    # calibrator-combo log file naming (reference train.py:306-325)
    base_name = "log"
    if cfg.CALIBRATION.SCALING.IF_SCALING:
        base_name += "_" + str(cfg.CALIBRATION.SCALING.MODE)
    if cfg.CALIBRATION.BIN.BIN_CALIBRATOR_NAME:
        base_name += "_" + str(cfg.CALIBRATION.BIN.BIN_CALIBRATOR_NAME)
    if cfg.CALIBRATION.DAC.IF_DAC:
        base_name += "_dac"
    if cfg.CALIBRATION.PROCAL.IF_PROCAL:
        base_name += "_procal"
    setup_logger(os.path.join(cfg.OUTPUT_DIR, base_name + ".txt"))

    # system-info dump (reference train.py:344-345 collect_env_info)
    print("** System info **")
    print(f"python: {platform.python_version()}  "
          f"torch: {torch.__version__}  cuda: {torch.version.cuda}  "
          f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))

    # trainer swap for temperature scaling (reference train.py:331-339):
    # the scaling trainer wraps the named trainer as its base; the name is
    # put back afterwards (the trainer shares this cfg, so its feature
    # cache paths name the base trainer)
    if cfg.CALIBRATION.SCALING.IF_SCALING:
        cfg = cfg.clone()
        cfg.defrost()
        cfg.CALIBRATION.SCALING.BASE_LEARNER = cfg.TRAINER.NAME
        cfg.TRAINER.NAME = cfg.CALIBRATION.SCALING.MODE
        trainer = build_trainer(cfg, device=device)
        cfg.TRAINER.NAME = args.trainer or \
            cfg.CALIBRATION.SCALING.BASE_LEARNER
    else:
        trainer = build_trainer(cfg, device=device)

    print_args(args, cfg)

    if args.eval_only:
        # the reference hardcodes MAX_EPOCH here (reference train.py:350);
        # --load-epoch wins when given
        eval_epoch = (args.load_epoch if args.load_epoch is not None
                      else cfg.OPTIM.MAX_EPOCH)
        trainer.load_model(args.model_dir, epoch=eval_epoch)
        trainer.test()
        trainer.close_writer()
        if args.export_reference_checkpoints:
            src = args.model_dir or cfg.OUTPUT_DIR
            trainer.export_reference_checkpoint(
                src, osp.join(cfg.OUTPUT_DIR, "reference_export"),
                epoch=eval_epoch)
        return

    if not args.no_train:
        trainer.train()
    trainer.close_writer()

    if args.export_reference_checkpoints:
        trainer.export_reference_checkpoint(
            cfg.OUTPUT_DIR, osp.join(cfg.OUTPUT_DIR, "reference_export"),
            epoch=args.load_epoch)


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=str, default="",
                        help="path to dataset")
    parser.add_argument("--output-dir", type=str, default="",
                        help="output directory")
    parser.add_argument("--resume", type=str, default="",
                        help="checkpoint directory to resume from")
    parser.add_argument("--seed", type=int, default=-1,
                        help="positive value enables a fixed seed")
    parser.add_argument("--source-domains", type=str, nargs="+")
    parser.add_argument("--target-domains", type=str, nargs="+")
    parser.add_argument("--transforms", type=str, nargs="+")
    parser.add_argument("--config-file", type=str, default="")
    parser.add_argument("--dataset-config-file", type=str, default="")
    parser.add_argument("--calibration-config-file", type=str, default="")
    parser.add_argument("--trainer", type=str, default="")
    parser.add_argument("--backbone", type=str, default="")
    parser.add_argument("--head", type=str, default="")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--model-dir", type=str, default="")
    parser.add_argument("--base-dir", type=str, default="")
    parser.add_argument("--base-learner", type=str, default="")
    parser.add_argument("--load-epoch", type=int)
    parser.add_argument("--no-train", action="store_true")
    parser.add_argument("--export-reference-checkpoints",
                        action="store_true",
                        help="export the run's checkpoints as "
                             "reference-format torch .pth.tar files "
                             "under <output>/reference_export/")
    parser.add_argument("--calibration-config", type=str)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="where the towers and kernels run (default: "
                             "cuda; there is no fallback to the CPU)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
