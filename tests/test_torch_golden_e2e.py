"""Stages 1-4 of tests/test_golden_e2e.py through the port's CLI.

``python -m clip_calibration_tpu_torch.train --device cpu`` on the same
fixture (tiny real-image dataset, shared seeded ViT-Test checkpoint,
reference-format CoOp prompt checkpoint) must reproduce the reference's
GOLDEN metrics at the JAX test's tolerance. The workdir is this module's
own, so the ``./temp`` feature caches are never shared with the JAX test.
"""

import json
import os
import os.path as osp
import re
import shutil
import subprocess
import sys

import pytest

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIX = osp.join(REPO, "tests", "fixtures", "golden_e2e")
GOLDEN = json.load(open(osp.join(FIX, "golden.json")))

# 2-decimal log rounding + fp32 model-parity drift (tests/test_golden_e2e.py)
TOL = 0.06

COMMON = ["--device", "cpu", "--seed", "1", "--backbone", "ViT-Test",
          "--dataset-config-file",
          osp.join(REPO, "configs", "datasets", "caltech101.yaml"),
          "--config-file", osp.join(FIX, "coop_fp32.yaml"), "--root", "data"]
OPTS = ["DATASET.NUM_SHOTS", "4", "MODEL.PRECISION", "fp32",
        "DATALOADER.TEST.BATCH_SIZE", "32",
        "INPUT.SIZE", "(32, 32)", "INPUT.INTERPOLATION", "bicubic",
        "TRAIN.PRINT_FREQ", "1"]
COOP = ["--trainer", "CoOp", "--model-dir", osp.join(FIX, "coop_model"),
        "--eval-only"]

STAGES = [  # (golden key, output dir, log file, flags, subsample)
    ("zsclip_base", "out/zs_base", "log.txt", ["--trainer", "ZeroshotCLIP"],
     "base"),
    ("coop_base", "out/coop_base", "log.txt",
     COOP + ["--export-reference-checkpoints"], "base"),
    ("coop_new_dac", "out/coop_new", "log_dac.txt",
     COOP + ["--calibration-config", json.dumps(
         {"BASE_CALIBRATION_MODE": None, "IF_DAC": True,
          "IF_PROCAL": False})], "new"),
    # TempScaling fitted on the val split of the CoOp base model
    ("coop_base_tempscaled", "out/coop_scaling", "log_TempScaling.txt",
     ["--trainer", "CoOp", "--base-dir", osp.join(FIX, "coop_model"),
      "--calibration-config", json.dumps(
          {"BASE_CALIBRATION_MODE": "scaling_based",
           "SCALING_CONFIG": osp.join(REPO, "configs", "calibration",
                                      "TempScaling", "ep20_lr5e-2.yaml"),
           "IF_DAC": False, "IF_PROCAL": False})], "base"),
]


def _parse_result(log_path):
    text = open(log_path).read()
    block = text[text.rindex("=> result"):]
    return {key: float(re.search(rf"\* {key}: (\d+\.\d+)%", block).group(1))
            for key in ("accuracy", "macro_f1", "ece", "mce", "ace",
                        "piece")}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Runs the four stages in order (each feeds the next through the
    ./temp caches) and returns each stage's parsed metrics, and the last
    temperature the scaling stage logged."""
    wd = tmp_path_factory.mktemp("torch_golden_e2e")
    shutil.copytree(osp.join(FIX, "data", "caltech-101"),
                    wd / "data" / "caltech-101")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2",
               CLIP_CHECKPOINT_DIR=osp.join(FIX, "weights"))
    out = {}
    for key, out_dir, log, flags, subsample in STAGES:
        r = subprocess.run(
            [sys.executable, "-m", "clip_calibration_tpu_torch.train"]
            + COMMON + flags + ["--output-dir", out_dir] + OPTS
            + ["DATASET.SUBSAMPLE_CLASSES", subsample],
            cwd=str(wd), env=env, capture_output=True, text=True,
            timeout=600)
        assert r.returncode == 0, f"{key}:\n{r.stderr[-3000:]}"
        out[key] = _parse_result(osp.join(str(wd), out_dir, log))
    temps = re.findall(r"temperature (\d+\.\d+)",
                       open(osp.join(str(wd), "out", "coop_scaling",
                                     "log_TempScaling.txt")).read())
    out["temperature"] = float(temps[-1]) if temps else None
    out["workdir"] = str(wd)
    return out


@pytest.mark.parametrize("key", [s[0] for s in STAGES])
def test_stage_matches_reference(results, key):
    want = GOLDEN[key]
    for metric, val in results[key].items():
        assert abs(val - want[metric]) <= TOL, (
            f"{key}.{metric}: port {val} vs reference {want[metric]:.2f}")


def test_eval_only_exports_reference_checkpoint(results):
    """Stage 2 ran with --export-reference-checkpoints: the loaded CoOp
    checkpoint comes back out in the reference torch format."""
    import torch
    src = osp.join(FIX, "coop_model", "prompt_learner", "model.pth.tar-3")
    dst = osp.join(results["workdir"], "out", "coop_base",
                   "reference_export", "prompt_learner", "model.pth.tar-3")
    want = torch.load(src, map_location="cpu", weights_only=False)
    got = torch.load(dst, map_location="cpu", weights_only=False)
    assert got["epoch"] == want["epoch"]
    assert torch.equal(got["state_dict"]["ctx"],
                       want["state_dict"]["ctx"].float())


def test_tempscaling_temperature_matches_reference(results):
    """Stage 4's fitted temperature (tests/test_golden_e2e.py: 2e-3)."""
    want = GOLDEN["tempscaling_temperature"]
    assert results["temperature"] is not None, "no temperature lines logged"
    assert abs(results["temperature"] - want) < 2e-3, (
        results["temperature"], want)
