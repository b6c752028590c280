"""The port's int8 quantization against the JAX package: K3's plain
version, ``qdot`` in every mode, the quantized towers, activation-scale
calibration and its npz, the quantized leaves in ``params_from_numpy``,
``device_preprocess``, and ``TRAINER.QUANT_FROZEN_VISION`` /
``TRAINER.QUANT_EVAL_TEXT`` in the trainers.

Both sides get the same numpy inputs at fp32 on the CPU. The JAX Pallas
int8 kernel runs in interpret mode, as its own tests run it; the port's
wrapper runs its plain version (CPU tensors). K3 itself is held to the
plain version on the card by chip_smoke.py.
"""

import copy
import os
import os.path as osp
import shutil
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clip_calibration_tpu.models import clip as JM
from clip_calibration_tpu.models import weights as JW
from clip_calibration_tpu.ops import quant as JQ
from clip_calibration_tpu_torch.models import clip as TM
from clip_calibration_tpu_torch.models import weights as TW
from clip_calibration_tpu_torch.ops import quant as TQ
from clip_calibration_tpu_torch.ops.int8_matmul import (
    int8_matmul, int8_matmul_reference, w8a8_matmul)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIX = osp.join(REPO, "tests", "fixtures", "golden_e2e")
NPZ = osp.join(FIX, "weights", "ViT-Test.npz")
sys.path.insert(0, osp.join(REPO, "tests"))

# towers at fp32: summation order differs between XLA and torch, and a
# difference at a rounding boundary of an activation quantization moves
# that activation by one int8 step (tests/test_torch_clip.py's TOL)
TOWER_TOL = dict(rtol=2e-4, atol=2e-4)
# calibrated absmax: the calibration tower runs in bf16 (the JAX
# function's default dtype), where the two packages round in other
# orders: one or two bf16 ulps (2^-8 relative each)
STATS_RTOL = 2e-2


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ K3

@pytest.mark.parametrize("shape", [(256, 768, 512), (100, 768, 2304),
                                   (33, 70, 129), (8, 8, 8)])
def test_int8_matmul_matches_jax_interpret_exactly(shape):
    from clip_calibration_tpu.ops.pallas_int8_matmul import (
        int8_matmul as jax_int8_matmul)
    M, K, N = shape
    rng = np.random.default_rng(0)
    x = rng.integers(-127, 128, (M, K), dtype=np.int8)
    w = rng.integers(-127, 128, (K, N), dtype=np.int8)
    want = np.asarray(jax_int8_matmul(jnp.asarray(x), jnp.asarray(w),
                                      interpret=True))
    got = int8_matmul_reference(_t(x), _t(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    launches = int8_matmul.launches
    np.testing.assert_array_equal(int8_matmul(_t(x), _t(w)).numpy(), want)
    assert int8_matmul.launches == launches  # CPU: plain version, no launch


@pytest.mark.parametrize("case", ["dtype", "contraction", "noncontiguous"])
def test_int8_matmul_rejects_what_the_kernel_does_not_take(case):
    x = torch.zeros((8, 16), dtype=torch.int8)
    w = torch.zeros((16, 8), dtype=torch.int8)
    if case == "dtype":
        with pytest.raises(TypeError, match="int8"):
            int8_matmul(x.float(), w)
    elif case == "contraction":
        with pytest.raises(ValueError, match="contraction"):
            int8_matmul(x, w[:8])
    else:
        with pytest.raises(ValueError, match="contiguous"):
            int8_matmul(x, torch.zeros((8, 16), dtype=torch.int8).T)


@pytest.mark.parametrize("lead", [(64,), (4, 16)])
def test_w8a8_matmul_bit_equal_to_jax(lead):
    from clip_calibration_tpu.ops.pallas_int8_matmul import (
        w8a8_matmul as jax_w8a8)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(*lead, 96)).astype(np.float32)
    w = rng.normal(size=(96, 80)).astype(np.float32)
    jq = JQ.quantize_int8(jnp.asarray(w))
    want = np.asarray(jax_w8a8(jnp.asarray(x), jq["int8"], jq["scale"],
                               interpret=True))
    tq = TQ.quantize_int8(_t(w))
    got = w8a8_matmul(_t(x), tq.int8, tq.scale)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", ["per_row", "static"])
def test_rescaled_int8_matmul_cpu_path_bit_equal_to_jax(scale, dtype):
    """``rescaled_int8_matmul`` on CPU tensors (the plain rescale the
    card's epilogue is held to): per-row scales against JAX
    ``w8a8_matmul`` (interpret-mode kernel), a 0-d static scale against
    JAX ``qdot``'s static w8a8 path; bit for bit, in x's dtype."""
    from clip_calibration_tpu.ops.pallas_int8_matmul import (
        w8a8_matmul as jax_w8a8)
    from clip_calibration_tpu_torch.ops.int8_matmul import (
        rescaled_int8_matmul)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 20, 64)).astype(np.float32)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, tx = jnp.asarray(x, jdt), _t(x).to(tdt)
    jw, tw = JQ.quantize_int8(jnp.asarray(w)), TQ.quantize_int8(_t(w))
    if scale == "per_row":
        want = jax_w8a8(jx, jw["int8"], jw["scale"], interpret=True)
        xq, xs = TQ.quantize_activations_int8(tx)
    else:
        act = np.float32(np.abs(x).max() * 0.6) / np.float32(127.0)
        want = JQ.qdot(jx, dict(jw, act_scale=jnp.float32(act)), "w8a8")
        xs = torch.tensor(act)
        xq = TQ._to_int8(tx.float(), xs)
    got = rescaled_int8_matmul(xq, xs, tw.int8, tw.scale, tdt, tw.kmajor)
    assert got.dtype == tdt and tuple(got.shape) == (3, 20, 48)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("case", ["state_dict", "flat_params", "npz", "to"])
def test_kmajor_copy_is_derived_and_in_no_file(towers, tmp_path, case):
    """Every ``QuantizedWeight`` of a quantized tower keeps ``int8``
    transposed and contiguous as ``kmajor`` (K3's weight layout, made
    once); it follows ``.to()`` but is in no state dict, flat-params dict
    or saved npz, whose layout stays [K, N]."""
    _, model, x = towers
    qm = TQ.quantize_clip_params(model, towers=("visual", "text"))
    qm = TQ.attach_act_scales(qm, TQ.calibrate_image_act_scales(
        qm, TM.PRESETS["ViT-Test"], _t(x)))
    holders = [m for m in qm.modules() if TQ.is_quantized(m)]
    cfg = TM.PRESETS["ViT-Test"]  # patch, proj, text proj, 4 a block
    assert len(holders) == 3 + 4 * (cfg.vision_layers
                                    + cfg.transformer_layers)
    for q in holders:
        assert q.kmajor.is_contiguous()
        assert torch.equal(q.kmajor, q.int8.t())
    if case == "state_dict":
        assert not [k for k in qm.state_dict() if "kmajor" in k]
        assert set(holders[0].state_dict()) == {"int8", "scale",
                                                "act_scale"}
    elif case == "flat_params":
        flat = TW.flat_params(qm)
        assert not [k for k in flat if "kmajor" in k]
        assert any(k.endswith("/int8") for k in flat)
    elif case == "npz":
        path = str(tmp_path / "q.npz")
        TW.save_params(path, qm)
        keys = list(np.load(path).files)
        assert not [k for k in keys if "kmajor" in k]
        assert any(k.endswith("/int8") for k in keys)
    else:
        moved = TQ.quantize_int8(_t(np.ones((8, 4), np.float32))).to("meta")
        assert moved.kmajor.device.type == "meta"
        assert tuple(moved.kmajor.shape) == (4, 8)


@pytest.mark.parametrize("assign", [False, True])
@pytest.mark.parametrize("towers_q", [("visual",), ("visual", "text")])
def test_kmajor_copy_follows_a_loaded_state_dict(towers, towers_q, assign):
    """Loading one quantized tower's state dict into another remakes
    every ``kmajor`` from the loaded ``int8`` (it is in no state dict,
    so nothing else would refresh it)."""
    _, model, _ = towers
    src = TQ.quantize_clip_params(model, towers=towers_q)
    flipped = copy.deepcopy(model)
    with torch.no_grad():
        for p in flipped.parameters():
            p.neg_()
    dst = TQ.quantize_clip_params(flipped, towers=towers_q)
    pairs = [(a, b) for a, b in zip(src.modules(), dst.modules())
             if TQ.is_quantized(a)]
    assert pairs and not any(torch.equal(a.kmajor, b.kmajor)
                             for a, b in pairs)
    dst.load_state_dict(src.state_dict(), assign=assign)
    for a, b in pairs:
        assert b.kmajor.is_contiguous()
        assert torch.equal(b.kmajor, b.int8.t())
        assert torch.equal(b.kmajor, a.kmajor)


@pytest.mark.parametrize("case", ["shape", "dtype", "noncontiguous"])
def test_k3_rejects_a_wrong_kmajor_copy(case):
    """A K-major copy that is not w's raises before any launch."""
    from clip_calibration_tpu_torch.ops.int8_matmul import kernel_product
    x = torch.zeros((4, 16), dtype=torch.int8)
    w = torch.zeros((16, 8), dtype=torch.int8)
    bad = {"shape": torch.zeros((16, 8), dtype=torch.int8),
           "dtype": torch.zeros((8, 16)),
           "noncontiguous": torch.zeros((16, 8), dtype=torch.int8).t()}
    with pytest.raises(ValueError, match="K-major"):
        kernel_product(x, w, bad[case])


# ---------------------------------------------------------- quantizers

def test_quantize_int8_bit_equal_to_jax():
    """Stacked [L, in, out] weights with an all-zero column."""
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(3, 16, 8))
         * rng.uniform(0.1, 10, size=(3, 1, 8))).astype(np.float32)
    w[:, :, 2] = 0.0
    want = JQ.quantize_int8(jnp.asarray(w))
    got = TQ.quantize_int8(_t(w))
    assert got.int8.dtype == torch.int8 and got.scale.shape == (3, 1, 8)
    np.testing.assert_array_equal(got.int8.numpy(), np.asarray(want["int8"]))
    np.testing.assert_array_equal(got.scale.numpy(),
                                  np.asarray(want["scale"]))
    np.testing.assert_array_equal(
        TQ.dequantize(got, torch.float32).numpy(),
        np.asarray(JQ.dequantize(want, jnp.float32)))


def test_quantize_activations_int8_bit_equal_to_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 7, 33)).astype(np.float32) * 3
    x[1, 2] = 0.0  # all-zero row: scale 1
    xq, xs = JQ.quantize_activations_int8(jnp.asarray(x))
    q, s = TQ.quantize_activations_int8(_t(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(xq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(xs))
    assert float(s[1, 2, 0]) == 1.0


@pytest.mark.parametrize("mode", ["w8a8", "w8a8_dynamic", "static",
                                  "w8a8_kernel", "dequant", "plain"])
def test_qdot_matches_jax(mode):
    """Every int8 mode bit-equal at fp32; dequant to 1e-6 relative (XLA
    and torch sum the float product in other orders)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 7, 16)).astype(np.float32)
    w = rng.normal(size=(16, 12)).astype(np.float32)
    jw, tw = JQ.quantize_int8(jnp.asarray(w)), TQ.quantize_int8(_t(w))
    qmode = mode
    if mode == "static":
        amax = np.float32(np.abs(x).max() * 0.7)  # some rows clip
        jw = dict(jw, act_scale=jnp.float32(amax / 127.0))
        tw = TQ.QuantizedWeight(tw.int8, tw.scale,
                                torch.tensor(amax / np.float32(127.0)))
        qmode = "w8a8"
    if mode == "w8a8_kernel":
        from clip_calibration_tpu.ops.pallas_int8_matmul import (
            w8a8_matmul as jax_w8a8)
        want = np.asarray(jax_w8a8(jnp.asarray(x), jw["int8"], jw["scale"],
                                   interpret=True))
    elif mode == "plain":
        jw, tw = jnp.asarray(w), _t(w)
        want = np.asarray(JQ.qdot(jnp.asarray(x), jw, "w8a8"))
        qmode = "w8a8"
    else:
        want = np.asarray(JQ.qdot(jnp.asarray(x), jw, qmode))
    got = TQ.qdot(_t(x), tw, qmode).numpy()
    if mode in ("dequant", "plain"):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_qdot_rejects_unknown_mode():
    w = TQ.quantize_int8(torch.ones((4, 4)))
    with pytest.raises(ValueError, match="qmode"):
        TQ.qdot(torch.ones((2, 4)), w, "w4a4")


# -------------------------------------------------------------- towers

@pytest.fixture(scope="module")
def towers():
    jparams = JW.load_params(NPZ)
    model = TW.params_from_numpy(JW.flatten_params(jparams),
                                 TM.PRESETS["ViT-Test"], torch.float32, "cpu")
    images = np.random.default_rng(1).uniform(
        -1, 1, (4, 32, 32, 3)).astype(np.float32)
    return jparams, model, images


def test_quantize_clip_params_structure(towers):
    """Vision matmul weights become int8 holders; every other tensor is
    the original's (not a copy), the text tower included; the input model
    is unchanged; per-layer scales are the JAX package's stacked ones."""
    jparams, model, _ = towers
    qm = TQ.quantize_clip_params(model)
    v = qm.visual
    for w in (v.patch_kernel, v.proj, *(getattr(getattr(b, o), k)
                                        for b in v.blocks
                                        for o, k in TQ.BLOCK_WEIGHTS)):
        assert TQ.is_quantized(w) and w.int8.dtype == torch.int8
    assert v.class_embedding is model.visual.class_embedding
    assert v.ln_pre is model.visual.ln_pre
    assert v.blocks[0].attn.bqkv is model.visual.blocks[0].attn.bqkv
    assert v.blocks[0].ln_1 is model.visual.blocks[0].ln_1
    assert qm.text is model.text and qm.logit_scale is model.logit_scale
    assert isinstance(model.visual.patch_kernel, torch.nn.Parameter)
    assert isinstance(model.visual.blocks[1].mlp.w_fc, torch.nn.Parameter)
    jq = JQ.quantize_clip_params(jparams)["visual"]["blocks"]["mlp"]["w_fc"]
    for i, b in enumerate(v.blocks):
        np.testing.assert_array_equal(b.mlp.w_fc.int8.numpy(),
                                      np.asarray(jq["int8"][i]))
        np.testing.assert_array_equal(b.mlp.w_fc.scale.numpy(),
                                      np.asarray(jq["scale"][i]))


@pytest.mark.parametrize("mode", ["dequant", "w8a8", "w8a8_dynamic",
                                  "static"])
def test_quantized_encode_image_matches_jax(towers, mode):
    """Static mode: the port's tower carries the JAX package's calibrated
    scales, loaded through ``params_from_numpy`` (quantized leaves)."""
    jparams, model, x = towers
    cfg = JM.PRESETS["ViT-Test"]
    jq = JQ.quantize_clip_params(jparams)
    qmode = mode
    if mode == "static":
        jq = JQ.attach_act_scales(jq, JQ.calibrate_image_act_scales(
            jq, cfg, jnp.asarray(x)))
        qm = TW.params_from_numpy(JW.flatten_params(jq),
                                  TM.PRESETS["ViT-Test"], torch.float32,
                                  "cpu")
        assert qm.visual.blocks[1].attn.wo.act_scale is not None
        qmode = "w8a8"
    else:
        qm = TQ.quantize_clip_params(model)
    want = np.asarray(JM.encode_image(jq, cfg, jnp.asarray(x),
                                      dtype=jnp.float32, qmode=qmode))
    with torch.inference_mode():
        got = TM.encode_image(qm, qm.cfg, _t(x), dtype=torch.float32,
                              qmode=qmode)
    np.testing.assert_allclose(got.numpy(), want, **TOWER_TOL)


def test_act_stats_match_jax(towers):
    jparams, model, x = towers
    want = JQ.calibrate_image_act_scales(
        JQ.quantize_clip_params(jparams), JM.PRESETS["ViT-Test"],
        jnp.asarray(x))
    got = TQ.stats_to_numpy(TQ.calibrate_image_act_scales(
        TQ.quantize_clip_params(model), model.cfg, _t(x)))
    assert got["blocks"]["attn"]["wqkv"].shape == (2,)
    for key in ("patch_kernel", "proj"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   rtol=STATS_RTOL)
    for outer, key in TQ.BLOCK_WEIGHTS:
        np.testing.assert_allclose(got["blocks"][outer][key],
                                   np.asarray(want["blocks"][outer][key]),
                                   rtol=STATS_RTOL)


def test_text_tower_stats_and_qmode(towers):
    """encode_text_embedded's stats and int8 path (a ``towers=("text",)``
    copy) against the JAX function."""
    jparams, model, _ = towers
    cfg = JM.PRESETS["ViT-Test"]
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 77, 64)) * 0.1).astype(np.float32)
    eot = np.array([5, 20, 11])
    jq = JQ.quantize_clip_params(jparams, towers=("text",))
    qm = TQ.quantize_clip_params(model, towers=("text",))
    assert qm.visual is model.visual
    want, wstats = JM.encode_text_embedded(
        jq, cfg, jnp.asarray(x), jnp.asarray(eot), seq_len=21,
        qmode="w8a8", collect_act_stats=True)
    with torch.inference_mode():
        got, gstats = TM.encode_text_embedded(
            qm, qm.cfg, _t(x), _t(eot), seq_len=21, qmode="w8a8",
            collect_act_stats=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOWER_TOL)
    np.testing.assert_allclose(float(gstats["text_projection"]),
                               float(wstats["text_projection"]), rtol=1e-5)
    np.testing.assert_allclose(gstats["blocks"]["mlp"]["w_proj"].numpy(),
                               np.asarray(wstats["blocks"]["mlp"]["w_proj"]),
                               rtol=1e-5)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_act_stats_npz_moves_between_packages(towers, tmp_path, writer):
    jparams, model, x = towers
    stats = JQ.calibrate_image_act_scales(
        JQ.quantize_clip_params(jparams), JM.PRESETS["ViT-Test"],
        jnp.asarray(x))
    stats = {"patch_kernel": np.asarray(stats["patch_kernel"]),
             "proj": np.asarray(stats["proj"]),
             "blocks": {o: {k: np.asarray(v) for k, v in d.items()}
                        for o, d in stats["blocks"].items()}}
    path = str(tmp_path / "scales.npz")
    src, dst = (JQ, TQ) if writer == "jax" else (TQ, JQ)
    src.save_act_stats(path, stats)
    back = dst.load_act_stats(path)
    assert set(back) == {"patch_kernel", "proj", "blocks"}
    np.testing.assert_array_equal(back["proj"], stats["proj"])
    for outer, key in TQ.BLOCK_WEIGHTS:
        np.testing.assert_array_equal(back["blocks"][outer][key],
                                      stats["blocks"][outer][key])
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, foo=np.zeros(3))
    with pytest.raises(ValueError, match="save_act_stats"):
        TQ.load_act_stats(bad)


def test_quantized_leaves_round_trip_through_flat_params(towers):
    """JAX quantized pytree -> params_from_numpy -> flat_params: the same
    flat dict, keys and values (act_scale stacked [L] again)."""
    jparams, _, x = towers
    cfg = JM.PRESETS["ViT-Test"]
    jq = JQ.quantize_clip_params(jparams)
    jq = JQ.attach_act_scales(jq, JQ.calibrate_image_act_scales(
        jq, cfg, jnp.asarray(x)))
    want = JW.flatten_params(jq)
    got = TW.flat_params(TW.params_from_numpy(
        want, TM.PRESETS["ViT-Test"], torch.float32, "cpu"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


# ------------------------------------------------------ preprocessing

@pytest.mark.parametrize("shape", [(2, 48, 40, 3), (2, 20, 24, 3),
                                   (1, 64, 64, 3), (2, 32, 64, 3),
                                   (1, 100, 180, 3)])
def test_device_preprocess_matches_jax(shape):
    """Down- and up-scaled sources (the antialiased Keys cubic of
    jax.image.resize): 1e-5 on normalised pixels, fp32 sums in other
    orders."""
    from clip_calibration_tpu.ops.preprocess import device_preprocess as JP
    from clip_calibration_tpu_torch.ops.preprocess import (
        device_preprocess as TP)
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(JP(jnp.asarray(img), 32, dtype=jnp.float32))
    got = TP(_t(img), 32, dtype=torch.float32).numpy()
    assert got.shape == want.shape == (shape[0], 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ----------------------------------------- TRAINER.QUANT_FROZEN_VISION

def _cfg(pkg, root, out, name, quant="", eval_text=""):
    if pkg == "jax":
        from clip_calibration_tpu.config import get_cfg_default
    else:
        from clip_calibration_tpu_torch.config import get_cfg_default
    cfg = get_cfg_default()
    cfg.merge_from_file(osp.join(REPO, "configs", "datasets",
                                 "caltech101.yaml"))
    cfg.merge_from_file(osp.join(FIX, "coop_fp32.yaml"))
    cfg.merge_from_list([
        "DATASET.ROOT", str(root), "DATASET.NUM_SHOTS", "4", "SEED", "1",
        "OUTPUT_DIR", str(out), "TRAINER.NAME", name,
        "DATASET.SUBSAMPLE_CLASSES", "base",
        "TEST.EVALUATOR", "VLClassification",
        "TRAINER.QUANT_FROZEN_VISION", quant,
        "TRAINER.QUANT_EVAL_TEXT", eval_text])
    return cfg


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """Both packages' registries and base learners, the golden fixture's
    data and weights, and its test images; the w8a8 calibration batch is
    the same 8 test images on both sides (the packages' train transforms
    draw different random crops)."""
    import clip_calibration_tpu.data.datasets  # noqa: F401
    import clip_calibration_tpu.evaluators.vl_evaluator  # noqa: F401
    import clip_calibration_tpu.trainers  # noqa: F401
    import clip_calibration_tpu_torch.data.datasets  # noqa: F401
    import clip_calibration_tpu_torch.evaluators.vl_evaluator  # noqa: F401
    import clip_calibration_tpu_torch.trainers  # noqa: F401
    from clip_calibration_tpu.engine.registry import TRAINER_REGISTRY as JR
    from clip_calibration_tpu.trainers.base_learner import (
        VLBaseLearner as JB)
    from clip_calibration_tpu_torch.engine.registry import (
        TRAINER_REGISTRY as TR)
    from clip_calibration_tpu_torch.trainers.base_learner import (
        VLBaseLearner as TB)
    from helpers import golden_test_images
    root = tmp_path_factory.mktemp("quant_golden")
    shutil.copytree(osp.join(FIX, "data"), root / "data")
    images, _ = golden_test_images({0, 1})
    old = os.environ.get("CLIP_CHECKPOINT_DIR")
    os.environ["CLIP_CHECKPOINT_DIR"] = osp.join(FIX, "weights")
    saved = JB._calibration_images, TB._calibration_images
    JB._calibration_images = TB._calibration_images = \
        lambda self: images[:8]
    try:
        yield {"jax": JR, "port": TR, "root": root, "images": images}
    finally:
        JB._calibration_images, TB._calibration_images = saved
        if old is None:
            os.environ.pop("CLIP_CHECKPOINT_DIR")
        else:
            os.environ["CLIP_CHECKPOINT_DIR"] = old


def _build(golden, pkg, name, **kw):
    cfg = _cfg(pkg, golden["root"] / "data", golden["root"] / f"out_{pkg}",
               name, **kw)
    if pkg == "jax":
        return golden["jax"].get(name)(cfg)
    return golden["port"].get(name)(cfg, device="cpu")


def _logits(trainer, images):
    with torch.inference_mode():
        out = trainer.model_inference(images)[0]
    return np.asarray(out.numpy() if isinstance(out, torch.Tensor) else out)


# int8 (weight-only): fp32 summation order only. w8a8 on each package's
# own calibration: a calibrated absmax one bf16 ulp apart (2^-8, see
# STATS_RTOL) moves that site's static scale, which re-rounds every
# activation quantized with it; the logits (|logit| <= 3 here) then move
# by up to ~3%.
QUANT_LOGIT_ATOL = {"int8": 1e-4, "w8a8": 0.15}


@pytest.mark.parametrize("name", ["CoOp", "ZeroshotCLIP"])
@pytest.mark.parametrize("mode", ["int8", "w8a8"])
def test_quant_frozen_vision_eval_matches_jax(golden, name, mode):
    jt = _build(golden, "jax", name, quant=mode)
    pt = _build(golden, "port", name, quant=mode)
    if name == "CoOp":
        for t in (jt, pt):
            t.load_model(osp.join(FIX, "coop_model"), epoch=3)
    assert TQ.is_quantized(pt.step_clip_params.visual.proj)
    assert pt.step_clip_params.text is pt.clip_model.text
    assert not TQ.is_quantized(pt.clip_model.visual.proj)
    assert pt.vision_qmode == ("w8a8" if mode == "w8a8" else "dequant")
    assert pt.vision_qmode_for(1) == ("w8a8_dynamic" if mode == "w8a8"
                                      else "dequant")
    images = golden["images"]
    want, got = _logits(jt, images), _logits(pt, images)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=QUANT_LOGIT_ATOL[mode])
    # the 1-row bucket runs per-row scales in both: fp32 order only
    np.testing.assert_allclose(_logits(pt, images[:1]),
                               _logits(jt, images[:1]), rtol=0, atol=1e-4)


def test_quant_frozen_vision_w8a8_on_jax_scales_matches_jax(golden):
    """The port's static w8a8 tower given the JAX trainer's calibrated
    scales: the JAX logits to fp32 summation order."""
    jt = _build(golden, "jax", "CoOp", quant="w8a8")
    pt = _build(golden, "port", "CoOp", quant="w8a8")
    for t in (jt, pt):
        t.load_model(osp.join(FIX, "coop_model"), epoch=3)
    pt._step_clip_params = TW.params_from_numpy(
        JW.flatten_params(jt.step_clip_params), TM.PRESETS["ViT-Test"],
        torch.float32, "cpu")
    np.testing.assert_allclose(_logits(pt, golden["images"]),
                               _logits(jt, golden["images"]), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_quant_eval_text_rejected_for_coop(golden, pkg):
    with pytest.raises(ValueError, match="CoCoOp, ProDA"):
        _build(golden, pkg, "CoOp", eval_text="int8")


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("key", ["quant", "eval_text"])
def test_unknown_quant_modes_rejected(golden, pkg, key):
    with pytest.raises(ValueError, match="expected"):
        _build(golden, pkg, "ZeroshotCLIP", **{key: "fp4"})


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_trainer_that_never_installs_the_tower_is_rejected(golden, pkg):
    """The engine's guard: a trainer whose build_model never calls
    setup_frozen_vision cannot take the flag silently."""
    base = golden[pkg].get("ZeroshotCLIP")

    class NoQuant(base):
        def setup_frozen_vision(self):
            pass

    cfg = _cfg(pkg, golden["root"] / "data", golden["root"] / "nq", "x",
               quant="int8")
    with pytest.raises(ValueError, match="does not support"):
        NoQuant(cfg) if pkg == "jax" else NoQuant(cfg, device="cpu")
