"""Multi-process runs of the port on the CPU: the twin of
tests/test_multihost.py.

The JAX test spins a 2-process CPU cluster through ``jax.distributed``;
the port runs one process per device on ``torch.distributed`` (gloo on
the CPU), joined by the same ``CC_COORD_ADDR`` / ``CC_NUM_PROCS`` /
``CC_PROC_ID`` variables and ``TPU.DISTRIBUTED``. The gates:

- a 2-process ZeroshotCLIP eval through the port's CLI prints the
  single-process ``=> result`` block byte for byte on every rank (each
  rank infers its slice of every test batch; logits, features and labels
  are gathered in data order);
- the hybrid (data, model) = (2, 2) mesh over 4 processes runs the
  class-sharded CoCoOp and ProDA steps (and ProDA's ``set_classifier``),
  a TempScaling epoch over a CoOp base (gathered logits paired with
  gathered labels: the JAX package's round-5 pod bug), CoOp on a w8a8
  frozen tower (calibration statistics max-reduced over the ranks) and a
  tensor-parallel encode; its results are equal on every rank and match
  one process.
"""

import os.path as osp
import re
import sys

import numpy as np

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, osp.dirname(osp.abspath(__file__)))

from torch_parallel_driver import launch, run_ranks  # noqa: E402


def _zs_args(root, out_dir):
    return ["-m", "clip_calibration_tpu_torch.train",
            "--trainer", "ZeroshotCLIP", "--root", root, "--seed", "1",
            "--dataset-config-file",
            osp.join(REPO, "configs/datasets/synthetic.yaml"),
            "--backbone", "ViT-Test", "--output-dir", out_dir,
            "--device", "cpu",
            "DATASET.NUM_SHOTS", "8", "DATASET.SUBSAMPLE_CLASSES", "base",
            "INPUT.SIZE", "(32, 32)", "DATALOADER.TEST.BATCH_SIZE", "32"]


def _result_block(log_path):
    with open(log_path) as f:
        text = f.read()
    m = re.search(r"=> result\n(\*.*\n)+", text)
    assert m, f"no result block in {log_path}:\n{text[-2000:]}"
    return m.group(0)


def test_two_process_eval_matches_single(tmp_path):
    root = str(tmp_path / "data")
    # one process (also writes the dataset the ranks read)
    single = tmp_path / "single"
    launch(_zs_args(root, str(single / "out")), 0, str(single))
    want = _result_block(single / "out" / "log.txt")
    # the cluster: every rank runs the same command, its own output dir
    # and working directory (the ./temp feature caches are cwd-relative)
    cluster = tmp_path / "cluster"
    outs = launch(_zs_args(root, "out") + ["TPU.DISTRIBUTED", "True"], 2,
                  str(cluster))
    for rank, out in enumerate(outs):
        # the banner prints before the log tee starts: check stdout
        assert "Distributed: 2 processes" in out, out[:2000]
        got = _result_block(cluster / f"cwd{rank}" / "out" / "log.txt")
        assert got == want, f"rank {rank} diverged"


def test_two_process_serve_cli_matches_single(tmp_path):
    """``serve --mesh 2`` over 2 processes: each rank encodes its half of
    every batch, rank 0 writes the single-process predictions (rounded to
    6 digits, as the CLI writes them) and rank 1 writes nothing."""
    from PIL import Image
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(4)
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
                        ).save(imgs / f"img_{i}.png")

    def args(out):
        return ["-m", "clip_calibration_tpu_torch.serve", "--device", "cpu",
                "--backbone", "ViT-Test", "--precision", "fp32",
                "--classnames", "cat", "dog", "pelican", "--topk", "2",
                "--batch-size", "3", "--images", str(imgs), "--out", out]

    want = str(tmp_path / "single.jsonl")
    launch(args(want), 0, str(tmp_path / "single"))
    got = str(tmp_path / "mesh.jsonl")
    logs = launch(args(got) + ["--mesh", "2"], 2, str(tmp_path / "mesh"))
    assert open(got).read() == open(want).read()
    assert "wrote 5 predictions" in logs[0]
    assert "wrote" not in logs[1]


def test_distributed_needs_a_seed_and_a_card():
    """No fixed seed, no multi-process run (each rank draws its own
    few-shot split); ``--device cuda`` without a card raises, on no rank
    falling back to the CPU."""
    from clip_calibration_tpu_torch import train
    base = ["--trainer", "ZeroshotCLIP", "--backbone", "ViT-Test",
            "--dataset-config-file",
            osp.join(REPO, "configs/datasets/synthetic.yaml")]
    import pytest
    with pytest.raises(ValueError, match="fixed seed"):
        train.main(train.build_parser().parse_args(
            base + ["--device", "cpu", "TPU.DISTRIBUTED", "True"]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(train.build_parser().parse_args(
            base + ["--seed", "1", "--device", "cuda",
                    "TPU.DISTRIBUTED", "True"]))


def _flat(res, prefix=""):
    """The numbers of a result tree, by path."""
    out = {}
    if isinstance(res, dict):
        for k, v in res.items():
            out.update(_flat(v, f"{prefix}/{k}"))
    elif isinstance(res, (tuple, list)) and res and not isinstance(
            res[0], (int, float)):
        for i, v in enumerate(res):
            out.update(_flat(v, f"{prefix}[{i}]"))
    else:
        out[prefix] = np.asarray(res, np.float64)
    return out


def test_four_process_hybrid_mesh_model_axis(tmp_path):
    """The (2, 2) mesh over 4 processes: every rank the same numbers, and
    those of one process (fp32; sharded sums in another order: rel 2e-5,
    the JAX test's bound; the TP encode against the whole tower)."""
    import torch
    from clip_calibration_tpu_torch.models.clip import CLIP, init_clip
    from clip_calibration_tpu_torch.models.weights import flat_params
    from clip_calibration_tpu_torch.parallel.dryrun import TP_CFG
    from test_torch_prompt_trainers import _weights
    weights = _weights(tmp_path)
    rng = np.random.default_rng(3)
    inputs = {"batch": 8, "tp_images": rng.normal(
        0, 1, (8, 32, 32, 3)).astype(np.float32),
        "tp_params": {k: v.numpy() for k, v in flat_params(init_clip(
            CLIP(TP_CFG, torch.float32, "cpu"), 2)).items()}}
    one = run_ranks(str(tmp_path / "one"), 0, inputs, ["products"],
                    weights)[0]["products"]
    ranks = run_ranks(str(tmp_path / "four"), 4, inputs,
                      ["products@2,2", "tp@2,2"], weights)
    first = _flat(ranks[0])
    for r in ranks[1:]:
        got = _flat(r)
        assert sorted(got) == sorted(first)
        for k in first:
            np.testing.assert_array_equal(got[k], first[k], err_msg=k)
    mesh = _flat(ranks[0]["products@2,2"])
    want = _flat(one)
    assert sorted(mesh) == sorted(want)
    for k, v in want.items():
        if k == "/cocoop_w8a8/logits":
            # the w8a8 text tower: each model rank encodes half the
            # classes, so its float matmuls run at other row counts and
            # may round an activation 1 ulp apart; a value on an int8
            # rounding boundary then moves a whole step (the amplification
            # chip_smoke.py's SERVE_COS_TOL describes). Held to the same
            # top class and 5% of the largest logit
            assert (mesh[k].argmax(1) == v.argmax(1)).all()
            assert np.abs(mesh[k] - v).max() <= 0.05 * np.abs(v).max()
            continue
        np.testing.assert_allclose(mesh[k], v, rtol=2e-5, atol=1e-5,
                                   err_msg=k)
    # the w8a8 frozen tower's static scales: the ranks calibrated on
    # their slices, the max-reduce gives one process's scales
    assert ranks[0]["products@2,2"]["coop_w8a8"]["act_scales"]
    for name in ("image", "text"):
        tp, whole = ranks[0]["tp@2,2"][name]
        np.testing.assert_allclose(tp, whole, rtol=2e-5, atol=2e-5)
