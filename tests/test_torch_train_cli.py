"""The port's training CLI on the CPU: twins of the JAX package's CoOp
training and TempScaling pipeline tests (tests/test_coop.py::
test_coop_trains_on_synthetic, tests/test_tempscaling.py::
test_scaling_pipeline), through ``clip_calibration_tpu_torch.train`` with
``--device cpu`` on the Synthetic dataset and the ViT-Test backbone."""

import json
import os
import os.path as osp
import re
import sys

import pytest

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
DATASET = osp.join(REPO, "configs", "datasets", "synthetic.yaml")
SHARED = ["DATASET.NUM_SHOTS", "8", "INPUT.SIZE", "(32, 32)",
          "INPUT.INTERPOLATION", "bicubic", "DATALOADER.TEST.BATCH_SIZE",
          "32", "DATALOADER.NUM_WORKERS", "2"]


def _run(args):
    from clip_calibration_tpu_torch.train import build_parser, main
    try:
        main(build_parser().parse_args(["--device", "cpu", "--seed", "1"]
                                       + args))
    finally:
        sys.stdout = sys.__stdout__  # undo the logger tee


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A cwd (the ./temp caches are cwd-relative) with the ZeroshotCLIP
    base run done: the pipeline's first stage for every trainer."""
    wd = tmp_path_factory.mktemp("torch_train_cli")
    old = os.getcwd()
    os.chdir(wd)
    try:
        _run(["--root", "data", "--trainer", "ZeroshotCLIP",
              "--dataset-config-file", DATASET, "--backbone", "ViT-Test",
              "--output-dir", "output/zs/seed1", "DATASET.SUBSAMPLE_CLASSES",
              "base"] + SHARED)
        yield wd
    finally:
        os.chdir(old)


def test_coop_trains_on_synthetic(workdir):
    """Short CoOp run through the CLI: the loss decreases and the
    checkpoint is saved with the reference layout."""
    _run(["--root", "data", "--trainer", "CoOp", "--dataset-config-file",
          DATASET, "--backbone", "ViT-Test",
          "--output-dir", "output/coop/seed1", "DATASET.SUBSAMPLE_CLASSES",
          "base", "INPUT.TRANSFORMS",
          "('random_resized_crop','random_flip','normalize')",
          "DATALOADER.TRAIN_X.BATCH_SIZE", "8", "OPTIM.NAME", "sgd",
          "OPTIM.LR", "0.02", "OPTIM.MAX_EPOCH", "8",
          "OPTIM.LR_SCHEDULER", "cosine", "OPTIM.WARMUP_EPOCH", "1",
          "OPTIM.WARMUP_TYPE", "constant", "OPTIM.WARMUP_CONS_LR", "1e-5",
          "TRAINER.COOP.N_CTX", "4"] + SHARED)
    log = open("output/coop/seed1/log.txt").read()
    assert "=> result" in log
    assert osp.exists("output/coop/seed1/prompt_learner/model.pth.tar-8")
    losses = [float(m) for m in re.findall(r"loss (\d+\.\d+) \(", log)]
    assert len(losses) > 2
    assert losses[-1] < losses[0]


def test_scaling_pipeline(workdir):
    """CoOp base train -> TempScaling calibration train -> scaling eval
    on the new classes, alone and with DAC, with the reference's
    calibration-config JSON protocol."""
    from clip_calibration_tpu_torch.engine.checkpoint import load_checkpoint
    data = ["--root", "data", "--trainer", "CoOp", "--dataset-config-file",
            DATASET, "--config-file",
            osp.join(REPO, "configs/trainers/CoOp/vit_test_ep3.yaml")]
    scaling = {"BASE_CALIBRATION_MODE": "scaling_based",
               "SCALING_CONFIG": osp.join(
                   REPO, "configs/calibration/TempScaling/ep5_lr5e-2.yaml"),
               "BIN_CALIBRATOR_NAME": None, "IF_DAC": False,
               "IF_PROCAL": False}
    _run(data + ["--output-dir", "output/train_base/seed1"] + SHARED
         + ["DATASET.SUBSAMPLE_CLASSES", "base"])
    assert osp.exists("output/train_base/seed1/prompt_learner/"
                      "model.pth.tar-3")

    _run(data + ["--output-dir", "output/train_base/seed1",
                 "--base-dir", "output/train_base/seed1",
                 "--calibration-config", json.dumps(scaling)] + SHARED
         + ["DATASET.SUBSAMPLE_CLASSES", "base"])
    ckpt = "output/train_base/seed1/scale_learner/model-calibrated.pth.tar-5"
    log = open("output/train_base/seed1/log_TempScaling.txt").read()
    assert "temperature" in log and "=> result" in log
    scale = float(load_checkpoint(ckpt)["state_dict"]["scale"])
    assert scale != pytest.approx(4.6052)  # moved away from ln 100

    for dac, log_name in ((False, "log_TempScaling.txt"),
                          (True, "log_TempScaling_dac.txt")):
        _run(data + ["--output-dir", "output/test_new/seed1",
                     "--base-dir", "output/train_base/seed1",
                     "--model-dir", "output/train_base/seed1", "--eval-only",
                     "--calibration-config",
                     json.dumps(dict(scaling, IF_DAC=dac))] + SHARED
             + ["DATASET.SUBSAMPLE_CLASSES", "new"])
        log = open(osp.join("output/test_new/seed1", log_name)).read()
        assert "=> result" in log
        assert re.search(r"\* ece: (\d+\.\d+)%", log)


@pytest.mark.parametrize("value", ["auto", "always", "never"])
def test_use_pallas_values_run_on_cpu(workdir, value):
    """TPU.USE_PALLAS on --device cpu: auto and always run the kernels'
    wrappers (their plain versions on CPU tensors), and never is accepted
    there, since the plain versions are the second attention path."""
    out = f"output/use_pallas_{value}/seed1"
    _run(["--root", "data", "--trainer", "ZeroshotCLIP",
          "--dataset-config-file", DATASET, "--backbone", "ViT-Test",
          "--output-dir", out, "DATASET.SUBSAMPLE_CLASSES", "base",
          "TPU.USE_PALLAS", value] + SHARED)
    assert "=> result" in open(osp.join(out, "log.txt")).read()


def test_use_pallas_rule():
    """never raises on the card (no second attention path there), any
    value outside auto | always | never raises, naming the allowed ones."""
    from clip_calibration_tpu_torch.train import check_use_pallas
    for value in ("auto", "always"):
        check_use_pallas(value, "cuda")
        check_use_pallas(value, "cpu")
    check_use_pallas("never", "cpu")
    with pytest.raises(ValueError, match="CPU tensors"):
        check_use_pallas("never", "cuda")
    for device_type in ("cuda", "cpu"):
        with pytest.raises(ValueError, match="auto, always, never"):
            check_use_pallas("nevr", device_type)


def test_unknown_use_pallas_raises_before_any_trainer(workdir, monkeypatch):
    from clip_calibration_tpu_torch import train

    def no_trainer(*args, **kwargs):
        raise AssertionError("a trainer was built")

    monkeypatch.setattr(train, "build_trainer", no_trainer)
    with pytest.raises(ValueError, match="TPU.USE_PALLAS"):
        _run(["--root", "data", "--trainer", "ZeroshotCLIP",
              "--dataset-config-file", DATASET, "--backbone", "ViT-Test",
              "--output-dir", "output/use_pallas_bad/seed1",
              "TPU.USE_PALLAS", "sometimes"] + SHARED)
