"""The port's experiment wrappers (``clip_calibration_tpu_torch/scripts``
and ``clip_calibration_tpu_torch/run``) at ``DEVICE=cpu``: twins of
tests/test_scripts_resume.py's wrapper tests and of
tests/test_parse_test_res.py on logs the port's wrappers wrote, and a pin
of each twin to its original at the repository root.
"""

import os
import os.path as osp
import re
import subprocess
import sys

import pytest

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
PORT = osp.join(REPO, "clip_calibration_tpu_torch")
TWINS = sorted(osp.join(top, kind, name)
               for top in ("scripts", "run")
               for kind in ("classification", "calibration")
               for name in os.listdir(osp.join(REPO, top, kind)))


@pytest.fixture()
def script_cwd(tmp_path):
    """A scratch cwd with configs visible, as the wrappers expect to run
    from the repo root (the port's CLI is found through PYTHONPATH)."""
    os.symlink(osp.join(REPO, "configs"), tmp_path / "configs")
    return tmp_path


def _env():
    env = dict(os.environ, DEVICE="cpu", JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run(script, args, cwd):
    proc = subprocess.run(
        ["bash", osp.join(PORT, "scripts", script)] + args,
        cwd=cwd, env=_env(), capture_output=True, text=True, timeout=45)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


@pytest.mark.parametrize("path", TWINS)
def test_twin_differs_from_its_original_only_in_the_port(path):
    """A scripts/ twin runs ``python -m clip_calibration_tpu_torch.train``
    with ``--device "${DEVICE:-cuda}"`` where the original runs
    ``python train.py``; a run/ twin calls the port's scripts."""
    with open(osp.join(REPO, path)) as f:
        want = f.read()
    if path.startswith("scripts"):
        want = want.replace("python train.py \\\n",
                            "python -m clip_calibration_tpu_torch.train \\\n"
                            '  --device "${DEVICE:-cuda}" \\\n')
    else:
        want = want.replace("bash scripts/",
                            "bash clip_calibration_tpu_torch/scripts/")
    with open(osp.join(PORT, path)) as f:
        got = f.read()
    # --device goes ahead of the config overrides (the CLI's remainder)
    got = re.sub(r'(python -m clip_calibration_tpu_torch\.train \\\n)'
                 r'((?:  --.*\\\n)*)  --device "\$\{DEVICE:-cuda\}" \\\n',
                 r'\1  --device "${DEVICE:-cuda}" \\\n\2', got)
    assert got == want
    assert subprocess.run(["bash", "-n", osp.join(PORT, path)],
                          timeout=30).returncode \
        == 0


def test_train_wrapper_resumes_finished_run(script_cwd):
    data = str(script_cwd / "data")
    # zero-shot base run fills the ./temp feature cache CoOp's test needs
    out = _run("classification/base2new_zeroshot_base.sh",
               ["vit_test", "synthetic", data, "8", "1", ""], script_cwd)
    assert "=> result" in out

    train_args = ["CoOp", "vit_test_ep3", "synthetic", data, "8", "1", ""]
    out1 = _run("classification/base2new_fewshot_train.sh", train_args,
                script_cwd)
    assert "Run this job and save the output to" in out1
    assert "epoch [3/3]" in out1  # trained to completion

    # second invocation: dir exists -> resume at the last checkpoint,
    # retrain nothing, re-run the final evaluation
    out2 = _run("classification/base2new_fewshot_train.sh", train_args,
                script_cwd)
    assert "Resuming..." in out2
    assert "Resumed from" in out2 and "(epoch 3)" in out2
    assert "epoch [" not in out2  # no training epochs re-run
    assert "=> result" in out2


def test_xd_test_wrapper_skips_existing_dir(script_cwd):
    d = script_cwd / ("output/xd/xd_test/ZeroshotCLIP/vit_test/"
                      "synthetic/seed1")
    d.mkdir(parents=True)
    out = _run("classification/xd_zeroshot_test.sh",
               ["vit_test", "synthetic", str(script_cwd / "data"), "1",
                ""], script_cwd)
    assert "Skip this job" in out
    assert not (d / "log.txt").exists()  # python never ran


def test_xd_zeroshot_wrapper_end_to_end(script_cwd):
    """A base run fills the 'base' feature cache, then the xd wrapper
    evaluates all classes against it."""
    data = str(script_cwd / "data")
    # the xd wrapper takes no SHOTS argument, so its cache lookup uses
    # NUM_SHOTS=-1: the base run must match
    _run("classification/base2new_zeroshot_base.sh",
         ["vit_test", "synthetic", data, "-1", "1", ""], script_cwd)
    out = _run("classification/xd_zeroshot_test.sh",
               ["vit_test", "synthetic", data, "1", ""], script_cwd)
    assert "Run this job and save the output to" in out
    log = (script_cwd / "output/xd/xd_test/ZeroshotCLIP/vit_test/"
           "synthetic/seed1/log.txt").read_text()
    assert "=> result" in log


def test_parse_test_res_aggregates_the_port_wrappers_logs(script_cwd):
    """parse_test_res.py (root, numpy only) over two seeds of the port's
    zero-shot base wrapper: the across-seed mean and the CSV row."""
    data = str(script_cwd / "data")
    run_dir = ("output/base2new/train_base/synthetic/shots_8/"
               "ZeroshotCLIP/vit_test")
    accs = {}
    for seed in (1, 2):
        _run("classification/base2new_zeroshot_base.sh",
             ["vit_test", "synthetic", data, "8", str(seed), ""],
             script_cwd)
        log = (script_cwd / run_dir / f"seed{seed}" / "log.txt").read_text()
        accs[seed] = float(
            re.search(r"\* accuracy: (\d+\.\d+)%", log).group(1))
    proc = subprocess.run(
        [sys.executable, osp.join(REPO, "parse_test_res.py"), run_dir,
         "--test-log", "--keyword", "accuracy"],
        cwd=script_cwd, env=_env(), capture_output=True, text=True,
        timeout=45)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    m = re.search(r"accuracy: (\d+\.\d+)% \+-", proc.stdout)
    assert m, proc.stdout
    assert float(m.group(1)) == pytest.approx(sum(accs.values()) / 2,
                                              abs=0.011)
    text = (script_cwd / "output/base2new/logs_base2new.csv").read_text()
    assert "synthetic" in text and "ZeroshotCLIP" in text
