"""Twin of tests/test_trainers_smoke.py for the port: each prompt trainer
trains 2 epochs on the synthetic dataset with the tiny backbone through
``clip_calibration_tpu_torch.train --device cpu``, evaluates through the
calibration pipeline and logs finite losses; then a VPT eval on the new
classes with DAC, ParameterizedTempScaling over a CoOp base, and CoOp on
the ModifiedResNet tower (RN-Test)."""

import json
import os
import os.path as osp
import re
import sys

import pytest

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))

BASE = ["--dataset-config-file",
        osp.join(REPO, "configs/datasets/synthetic.yaml"),
        "--backbone", "ViT-Test", "--seed", "1", "--device", "cpu"]
DATA = ["DATASET.NUM_SHOTS", "8", "INPUT.SIZE", "(32, 32)",
        "INPUT.INTERPOLATION", "bicubic", "DATALOADER.TRAIN_X.BATCH_SIZE",
        "8", "DATALOADER.TEST.BATCH_SIZE", "32", "DATALOADER.NUM_WORKERS",
        "2"]
# OPTIM.MAX_EPOCH would also replace a scaling config's epochs
OPTIM = ["OPTIM.NAME", "sgd", "OPTIM.LR", "0.02", "OPTIM.MAX_EPOCH", "2",
         "OPTIM.LR_SCHEDULER", "cosine"]
BASE_CLASSES = ["DATASET.SUBSAMPLE_CLASSES", "base"]
OPTS = DATA + BASE_CLASSES + OPTIM
EXTRA = {
    "KgCoOp": ["TRAINER.KGCOOP.N_CTX", "4"],
    "MaPLe": ["TRAINER.MAPLE.PROMPT_DEPTH", "2"],  # ViT-Test: 2 layers
    "PromptSRC": ["TRAINER.PROMPTSRC.PROMPT_DEPTH_VISION", "2",
                  "TRAINER.PROMPTSRC.PROMPT_DEPTH_TEXT", "2",
                  "TRAINER.PROMPTSRC.GPA_MEAN", "1",
                  "TRAINER.PROMPTSRC.GPA_STD", "1"],
    "CoCoOp": ["TRAINER.COCOOP.N_CTX", "4"],
    # tiny N_CTX takes the random init: the reference's CTX_INIT embeds the
    # dataset template (6 words for Synthetic) and asserts N_CTX >= 6
    "ProGrad": ["TRAINER.PROGRAD.N_CTX", "4", "TRAINER.PROGRAD.CTX_INIT",
                "False"],
    "ProDA": ["TRAINER.PRODA.N_PROMPT", "8", "TRAINER.PRODA.PROMPT_BS", "4",
              "TRAINER.PRODA.N_CTX", "4"],
}


def _run(args):
    from clip_calibration_tpu_torch.train import build_parser, main
    try:
        main(build_parser().parse_args(args))
    finally:
        sys.stdout = sys.__stdout__  # undo the logger tee


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    wd = tmp_path_factory.mktemp("torch_trainers")
    old = os.getcwd()
    os.chdir(wd)
    try:
        # zero-shot base features: the calibration pipeline's first stage
        _run(["--root", "data", "--trainer", "ZeroshotCLIP",
              "--output-dir", "output/zs/seed1"] + BASE + OPTS)
        yield str(wd)
    finally:
        os.chdir(old)


def _check_log(path):
    log = open(path).read()
    assert "=> result" in log
    acc = float(re.search(r"\* accuracy: (\d+\.\d+)%", log).group(1))
    assert 0.0 <= acc <= 100.0
    return log


@pytest.mark.parametrize("trainer", ["KgCoOp", "CLIP_Adapter", "VPT",
                                     "TaskRes", "PromptSRC", "MaPLe",
                                     "CoCoOp", "ProGrad", "ProDA"])
def test_trainer_smoke(workdir, trainer):
    _run(["--root", "data", "--trainer", trainer, "--output-dir",
          f"output/{trainer}/seed1"] + BASE + OPTS + EXTRA.get(trainer, []))
    log = _check_log(f"output/{trainer}/seed1/log.txt")
    losses = [float(m) for m in re.findall(r"loss (\d+\.\d+) \(", log)]
    assert len(losses) >= 2, "no loss lines logged"
    assert all(l == l and l != float("inf") for l in losses)  # finite


def test_vpt_new_classes_with_dac(workdir):
    """The base-trained VPT checkpoint evaluated on the new classes with
    DAC (the paper's headline stage, on a vision-prompt trainer)."""
    out = "output/VPT_base/seed1"
    _run(["--root", "data", "--trainer", "VPT", "--output-dir", out]
         + BASE + OPTS)
    _run(["--root", "data", "--trainer", "VPT", "--output-dir",
          "output/VPT_new/seed1", "--model-dir", out, "--eval-only",
          "--load-epoch", "2", "--calibration-config", json.dumps(
              {"BASE_CALIBRATION_MODE": None, "IF_DAC": True,
               "IF_PROCAL": False})]
         + BASE + DATA + ["DATASET.SUBSAMPLE_CLASSES", "new"])
    _check_log("output/VPT_new/seed1/log_dac.txt")


def test_parameterized_tempscaling_over_coop(workdir):
    from clip_calibration_tpu_torch.engine.checkpoint import load_checkpoint
    coop = ["--root", "data", "--trainer", "CoOp", "--output-dir",
            "output/CoOp_base/seed1"] + BASE
    _run(coop + OPTS + ["TRAINER.COOP.N_CTX", "4"])
    _run(coop + ["--base-dir", "output/CoOp_base/seed1",
                 "--calibration-config", json.dumps({
                     "BASE_CALIBRATION_MODE": "scaling_based",
                     "SCALING_CONFIG": osp.join(
                         REPO, "configs/calibration/ParameterizedTempScaling/"
                         "ep5_lr5e-2.yaml"),
                     "IF_DAC": False, "IF_PROCAL": False})]
         + DATA + BASE_CLASSES + ["TRAINER.COOP.N_CTX", "4",
                                  "CALIBRATION.SCALING.BASE_EPOCH", "2"])
    log = _check_log(
        "output/CoOp_base/seed1/log_ParameterizedTempScaling.txt")
    assert re.search(r"loss (\d+\.\d+) \(", log)
    state = load_checkpoint("output/CoOp_base/seed1/scale_learner/"
                            "model-calibrated.pth.tar-5")["state_dict"]
    assert sorted(state) == ["b_in", "b_out", "bs", "s0", "w_in", "w_out",
                             "ws"]


def test_trainer_smoke_resnet_backbone(workdir):
    """CoOp end to end on the ModifiedResNet tower (RN-Test): the
    attention-pooled image features through the CLI and the calibration
    pipeline. Its own zero-shot base run: the feature caches are keyed by
    backbone."""
    rn_base = [a if a != "ViT-Test" else "RN-Test" for a in BASE]
    _run(["--root", "data", "--trainer", "ZeroshotCLIP", "--output-dir",
          "output/zs_rn/seed1"] + rn_base + OPTS)
    _run(["--root", "data", "--trainer", "CoOp", "--output-dir",
          "output/CoOp_rn/seed1"] + rn_base + OPTS
         + ["TRAINER.COOP.N_CTX", "4"])
    log = _check_log("output/CoOp_rn/seed1/log.txt")
    losses = [float(m) for m in re.findall(r"loss (\d+\.\d+) \(", log)]
    assert losses and all(l == l and l != float("inf") for l in losses)
