"""Int8 weights on the port's tensor-parallel towers
(``clip_calibration_tpu_torch/parallel/tp.py``), against one rank and the
JAX package's one-device quantized encode.

Gloo groups of 2 ranks (mesh (1, 2)) and 4 ranks (mesh (2, 2)) of CPU
processes run ``tests/torch_parallel_driver.py``'s ``int8_tp`` and
``int8_predictor`` cases on one seeded weight file (the JAX init of the
TP test tower, 2 vision heads and 4 text heads). Each rank cuts the int8
weights, their scales and K-major copies by heads and hidden features;
the image and raw-token text towers run in four modes: weight-only int8
(``dequant``), static w8a8 (the JAX package's calibrated scales), dynamic
per-row w8a8 and ``w8a8_dynamic``. fp32 throughout.

Tolerances, max |diff| of the features against the JAX encode: the JAX
dry run's 1e-4 for weight-only int8 and 1e-3 for static w8a8 (each rank
rescales its partial int32 product before the sum); 1e-4 for the dynamic
scales, which a per-rank absmax of the row-cut products (``wo``,
``w_proj``) would miss by about one int8 step of each activation.
"""

import os.path as osp
import sys

import numpy as np
import pytest
import torch

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, osp.dirname(osp.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_parallel import (TP_PRESET, _close,  # noqa: E402
                                 _same_on_every_rank, _tp_params)
from torch_parallel_driver import INT8_MODES, run_ranks  # noqa: E402

JAX_TOL = {"dequant": 1e-4, "w8a8_static": 1e-3, "w8a8": 1e-4,
           "w8a8_dynamic": 1e-4}
#: a multi-process group must finish well inside a minute
TIMEOUT = 50
#: the TP w8a8 Predictor's probabilities against the meshless one. On
#: (1, 2) the chunks are the meshless ones and the probabilities agree to
#: 0 on the CPU. On (2, 2) the batch size 3 rounds up to 4: the 10 images
#: go in chunks of 4, 4, 2 (meshless: 3, 3, 3, 1) and a lone image pads to
#: 2 rows, so rows the meshless Predictor serves in its 1-row bucket on
#: dynamic scales run static ones on the mesh (1.3e-3 apart on the CPU)
W8A8_PROBS_ATOL = 5e-3


def _tokens():
    """Raw token rows as ``parallel/dryrun.py::tp_tower`` makes them."""
    rng = np.random.default_rng(4)
    toks = rng.integers(1, 400, (8, 12))
    toks[:, 0] = 49406
    toks[:, 9] = 49407
    toks[:, 10:] = 0
    return toks


class Fixture:
    """The inputs, the JAX encodes per mode and the ranks' results."""


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    from clip_calibration_tpu.models import clip as JM
    from clip_calibration_tpu.ops import quant as JQ
    from clip_calibration_tpu_torch.models.weights import (params_from_numpy,
                                                           save_params)
    from clip_calibration_tpu_torch.parallel.dryrun import TP_CFG
    root = tmp_path_factory.mktemp("int8_tp")
    f = Fixture()
    cfg, params, flat = _tp_params()
    f.weights = str(root / "weights")
    save_params(osp.join(f.weights, TP_PRESET + ".npz"),
                params_from_numpy(flat, TP_CFG, torch.float32, "cpu"))
    rng = np.random.default_rng(5)
    f.images = rng.normal(0, 1, (8, 32, 32, 3)).astype(np.float32)
    f.tokens = _tokens()
    jq = JQ.quantize_clip_params(params, towers=("visual", "text"))
    x = JM.embed_tokens(params, jnp.asarray(f.tokens), jnp.float32)
    eot = jnp.argmax(jnp.asarray(f.tokens), axis=-1)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    image_stats = to_np(JQ.calibrate_image_act_scales(
        jq, cfg, jnp.asarray(f.images)))
    text_stats = to_np(JQ.calibrate_text_act_scales(jq, cfg, x, eot))
    js = JQ.attach_text_act_scales(JQ.attach_act_scales(jq, image_stats),
                                   text_stats)
    f.jax = {}
    for name, (qmode, scaled) in INT8_MODES.items():
        p = js if scaled else jq
        f.jax["image/" + name] = np.asarray(JM.encode_image(
            p, cfg, jnp.asarray(f.images), dtype=jnp.float32, qmode=qmode))
        f.jax["text/" + name] = np.asarray(JM.encode_text_embedded(
            p, cfg, x, eot, qmode=qmode))
    f.classnames = ["cat", "dog", "pelican"]
    f.serve_images = rng.integers(0, 256, (10, 32, 32, 3), dtype=np.uint8)
    inputs = {"tp_params": flat, "tp_images": f.images,
              "classnames": f.classnames, "serve_images": f.serve_images,
              "int8_tp": {"image_stats": image_stats,
                          "text_stats": text_stats, "tokens": f.tokens}}
    f.two = run_ranks(str(root / "two"), 2, inputs,
                      ["int8_tp@1,2", "int8_predictor@1,2"], f.weights,
                      timeout=TIMEOUT)
    f.four = run_ranks(str(root / "four"), 4, inputs,
                       ["int8_tp@2,2", "int8_predictor@2,2"], f.weights,
                       timeout=TIMEOUT)
    return f


GROUPS = [("two", "int8_tp@1,2"), ("four", "int8_tp@2,2")]


@pytest.mark.parametrize("mode", list(INT8_MODES))
@pytest.mark.parametrize("tower", ["image", "text"])
@pytest.mark.parametrize("group,case", GROUPS, ids=["pure-tp", "dp-x-tp"])
def test_int8_tp_encode_matches_jax_and_one_rank(fx, group, case, tower,
                                                  mode):
    """Every rank gathers the same features. They hold to the port's
    one-rank encode, and to the JAX package's one-device quantized encode
    on every row where the one-rank encode does: the TP cut adds no
    disagreement with JAX. A row where an fp32 rounding difference
    between XLA and torch moves one activation across an int8 rounding
    boundary of a static scale differs from JAX by about one int8 step on
    one rank too (tests/test_torch_quant.py's TOWER_TOL); at most one such
    row of the 8 is allowed."""
    key = f"{tower}/{mode}"
    got, one = _same_on_every_rank(
        [{case: res[case][key]} for res in getattr(fx, group)], case)
    want = fx.jax[key]
    tol = JAX_TOL[mode]
    assert np.abs(got - one).max() <= tol, np.abs(got - one).max()
    rows = np.abs(one - want).max(1) <= tol
    assert rows.sum() >= len(rows) - (1 if mode == "w8a8_static" else 0)
    assert np.abs(got - want)[rows].max() <= tol


@pytest.mark.parametrize("group,case", GROUPS, ids=["pure-tp", "dp-x-tp"])
def test_int8_tp_stats_and_static_slices(fx, group, case):
    """``collect_act_stats`` under TP equals the one-rank statistics of
    the rank's rows (the row-cut sites reduced by MAX over the model
    ranks), and the slices of blocks that carry static scales carry
    them."""
    from clip_calibration_tpu_torch.ops.quant import BLOCK_WEIGHTS
    for res in getattr(fx, group):
        r = res[case]
        assert r["static_slices"]
        tp, one = r["stats_tp"], r["stats_one"]
        for key in ("patch_kernel", "proj"):
            _close(tp[key], one[key], rtol=1e-6, atol=0, what=key)
        for outer, key in BLOCK_WEIGHTS:
            _close(tp["blocks"][outer][key], one["blocks"][outer][key],
                   rtol=1e-6, atol=0, what=f"{outer}.{key}")


@pytest.mark.parametrize("group,case", [("two", "int8_predictor@1,2"),
                                        ("four", "int8_predictor@2,2")])
def test_int8_tp_predictor_matches_meshless(fx, group, case, monkeypatch):
    """The TP Predictor with ``quantize`` int8 and w8a8 (static scales
    calibrated on each rank) against the meshless quantized Predictor:
    the same top-1, probabilities within 2e-5 (int8: the full-precision
    TP Predictor's bound, tests/test_parallel.py) and W8A8_PROBS_ATOL
    (w8a8); the 1-row bucket too."""
    from clip_calibration_tpu_torch.models import clip as M
    from clip_calibration_tpu_torch.parallel.dryrun import TP_CFG
    from clip_calibration_tpu_torch.serving import Predictor
    r = _same_on_every_rank(getattr(fx, group), case)
    monkeypatch.setitem(M.PRESETS, TP_PRESET, TP_CFG)
    monkeypatch.setenv("CLIP_CHECKPOINT_DIR", fx.weights)
    for quantize, kw, atol in (
            ("int8", {}, 2e-5),
            ("w8a8", {"calibration_images": fx.serve_images[:4]},
             W8A8_PROBS_ATOL)):
        plain = Predictor(TP_PRESET, fx.classnames, precision="fp32",
                          batch_size=3, quantize=quantize, device="cpu",
                          **kw)
        for key, images in ((quantize, fx.serve_images),
                            (quantize + "_one", fx.serve_images[:1])):
            want = plain.predict(images)["probs"]
            np.testing.assert_array_equal(r[key].argmax(1), want.argmax(1))
            _close(r[key], want, rtol=0, atol=atol, what=key)
