"""The port's serving slice against the JAX package: ``Predictor``
(zero-shot, prompt checkpoint, DAC, temperature, int8 and w8a8 towers,
static activation scales, the 1-row bucket, device-side preprocessing),
``TrainerPredictor`` and the dataset-free trainer builds, and the serve
CLI with its flag guards.

Both packages serve the golden fixture (ViT-Test weights, CoOp prompt
checkpoint, test images) at fp32 on the CPU; the port's int8 products run
K3's plain version there (chip_smoke.py holds K3 to it on the card).
"""

import json
import os.path as osp
import sys

import numpy as np
import pytest
import torch

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIX = osp.join(REPO, "tests", "fixtures", "golden_e2e")
sys.path.insert(0, osp.join(REPO, "tests"))

from helpers import golden_test_images  # noqa: E402

GOLDEN = json.load(open(osp.join(FIX, "golden.json")))
CLASSNAMES = ["amber", "basalt", "cobalt", "dune"]
BASE = CLASSNAMES[:2]
CKPT = osp.join(FIX, "coop_model")
KW = dict(precision="fp32", batch_size=8)

# probabilities, port vs JAX, fp32: the towers' summation orders
# (tests/test_torch_clip.py holds features to 2e-4)
PROB_ATOL = 1e-4
# w8a8 calibrated by each package on its own: the calibration tower runs
# in bf16, one absmax may land a bf16 ulp (2^-8) apart and re-round every
# activation quantized with it (tests/test_torch_quant.py)
PROB_ATOL_OWN_CALIBRATION = 2e-2


@pytest.fixture(autouse=True)
def _fixture_weights(monkeypatch):
    monkeypatch.setenv("CLIP_CHECKPOINT_DIR", osp.join(FIX, "weights"))


def _jax_predictor(*args, prompt=False, **kw):
    from clip_calibration_tpu.serving import Predictor
    if prompt:
        return Predictor.from_prompt_checkpoint(*args, **kw)
    return Predictor(*args, **kw)


def _port_predictor(*args, prompt=False, **kw):
    from clip_calibration_tpu_torch.serving import Predictor
    kw.setdefault("device", "cpu")
    if prompt:
        return Predictor.from_prompt_checkpoint(*args, **kw)
    return Predictor(*args, **kw)


def _both(*args, **kw):
    return _jax_predictor(*args, **kw), _port_predictor(*args, **kw)


# ------------------------------------------------------------ Predictor

def test_zero_shot_predictor_matches_jax_and_golden_accuracy():
    images, labels = golden_test_images({0, 1})
    jp, pp = _both("ViT-Test", BASE, **KW)
    want, got = jp.predict(images), pp.predict(images)
    assert 100.0 * (got["preds"] == labels).mean() == pytest.approx(
        GOLDEN["zsclip_base"]["accuracy"], abs=0.01)
    np.testing.assert_allclose(got["probs"], want["probs"], atol=PROB_ATOL)
    np.testing.assert_array_equal(got["preds"], want["preds"])
    np.testing.assert_allclose(got["probs"].sum(1), 1.0, atol=1e-5)


def test_prompt_checkpoint_predictor_matches_jax_and_golden_accuracy():
    images, labels = golden_test_images({0, 1})
    jp, pp = _both("ViT-Test", BASE, CKPT, prompt=True, n_ctx=4, **KW)
    np.testing.assert_allclose(pp.text_features.numpy(),
                               np.asarray(jp.text_features), atol=1e-5)
    want, got = jp.predict(images), pp.predict(images)
    assert 100.0 * (got["preds"] == labels).mean() == pytest.approx(
        GOLDEN["coop_base"]["accuracy"], abs=0.01)
    np.testing.assert_allclose(got["probs"], want["probs"], atol=PROB_ATOL)


@pytest.mark.parametrize("knob", ["dac", "temperature"])
def test_dac_and_temperature_match_jax(knob):
    images, _ = golden_test_images({2, 3})
    kw = ({"class_confidence": np.asarray(GOLDEN["dac_class_confidence"])}
          if knob == "dac"
          else {"temperature": GOLDEN["tempscaling_temperature"]})
    jp, pp = _both("ViT-Test", CLASSNAMES[2:], CKPT, prompt=True, n_ctx=4,
                   **kw, **KW)
    plain = _port_predictor("ViT-Test", CLASSNAMES[2:], CKPT, prompt=True,
                            n_ctx=4, **KW).predict(images)["probs"]
    got = pp.predict(images)["probs"]
    assert not np.allclose(got, plain)
    np.testing.assert_array_equal(got.argmax(1), plain.argmax(1))
    np.testing.assert_allclose(got, jp.predict(images)["probs"],
                               atol=PROB_ATOL)


@pytest.mark.parametrize("mode", ["int8", "w8a8"])
def test_quantized_predictor_matches_jax(mode):
    images, _ = golden_test_images({0, 1, 2, 3})
    jp, pp = _both("ViT-Test", CLASSNAMES, quantize=mode, **KW)
    assert pp.quantize == mode
    want, got = jp.predict(images), pp.predict(images)
    np.testing.assert_array_equal(got["preds"], want["preds"])
    np.testing.assert_allclose(got["probs"], want["probs"], atol=PROB_ATOL)
    full = _port_predictor("ViT-Test", CLASSNAMES, **KW).predict(images)
    np.testing.assert_array_equal(got["preds"], full["preds"])


def test_quantized_prompt_checkpoint_keeps_text_exact():
    images, _ = golden_test_images({0, 1})
    full = _port_predictor("ViT-Test", BASE, CKPT, prompt=True, n_ctx=4,
                           **KW)
    quant = _port_predictor("ViT-Test", BASE, CKPT, prompt=True, n_ctx=4,
                            quantize="w8a8", **KW)
    np.testing.assert_array_equal(full.text_features.numpy(),
                                  quant.text_features.numpy())
    want = _jax_predictor("ViT-Test", BASE, CKPT, prompt=True, n_ctx=4,
                          quantize="w8a8", **KW).predict(images)
    np.testing.assert_allclose(quant.predict(images)["probs"],
                               want["probs"], atol=PROB_ATOL)


def test_static_scales_from_jax_npz_match_jax(tmp_path):
    """A JAX-calibrated predictor's stats saved as npz and loaded by the
    port: the same static scales on both sides, the JAX probabilities to
    fp32 summation order; the port's own calibration lands within bf16
    calibration noise."""
    from clip_calibration_tpu.ops.quant import save_act_stats
    images, _ = golden_test_images({0, 1})
    live = _jax_predictor("ViT-Test", BASE, quantize="w8a8",
                          calibration_images=images, **KW)
    path = str(tmp_path / "scales.npz")
    save_act_stats(path, live.act_stats)
    replay = _port_predictor("ViT-Test", BASE, quantize="w8a8",
                             act_scales=path, **KW)
    assert replay.model.visual.patch_kernel.act_scale is not None
    want = live.predict(images)["probs"]
    np.testing.assert_allclose(replay.predict(images)["probs"], want,
                               atol=PROB_ATOL)
    own = _port_predictor("ViT-Test", BASE, quantize="w8a8",
                          calibration_images=images, **KW)
    got = own.predict(images)
    np.testing.assert_array_equal(got["preds"], want.argmax(1))
    np.testing.assert_allclose(got["probs"], want,
                               atol=PROB_ATOL_OWN_CALIBRATION)


def test_act_scales_roundtrip_and_guards(tmp_path):
    """save/load + act_scales=path rebuilds a predictor bit for bit equal
    to the one that calibrated live; the flag guards of the JAX
    Predictor."""
    from clip_calibration_tpu_torch.ops.quant import save_act_stats
    images, _ = golden_test_images({0, 1})
    live = _port_predictor("ViT-Test", BASE, quantize="w8a8",
                           calibration_images=images, **KW)
    path = str(tmp_path / "scales.npz")
    save_act_stats(path, live.act_stats)
    replay = _port_predictor("ViT-Test", BASE, quantize="w8a8",
                             act_scales=path, **KW)
    np.testing.assert_array_equal(replay.predict(images)["probs"],
                                  live.predict(images)["probs"])
    for kw, match in (({"quantize": "int8", "act_scales": path},
                       "act_scales"),
                      ({"quantize": "int8", "calibration_images": images},
                       "calibration_images"),
                      ({"quantize": "w8a8", "act_scales": path,
                        "calibration_images": images}, "not both"),
                      ({"quantize": "int4"}, "quantize"),
                      ({"quantize": "w8a8_kernel"}, "no longer")):
        with pytest.raises(ValueError, match=match):
            _port_predictor("ViT-Test", BASE, **kw)


def test_one_row_bucket_runs_dynamic_scales():
    """With static scales a single image runs per-row scales: equal to
    an uncalibrated w8a8 predictor there, and to the JAX 1-row bucket;
    two images keep the static scales."""
    images, _ = golden_test_images({0, 1})
    dyn = _port_predictor("ViT-Test", BASE, quantize="w8a8", **KW)
    static = _port_predictor("ViT-Test", BASE, quantize="w8a8",
                             calibration_images=images, **KW)
    np.testing.assert_array_equal(static.predict(images[:1])["probs"],
                                  dyn.predict(images[:1])["probs"])
    assert not np.array_equal(static.predict(images[:2])["probs"],
                              dyn.predict(images[:2])["probs"])
    want = _jax_predictor("ViT-Test", BASE, quantize="w8a8",
                          calibration_images=images,
                          **KW).predict(images[:1])["probs"]
    np.testing.assert_allclose(static.predict(images[:1])["probs"], want,
                               atol=PROB_ATOL)


def test_bucketed_short_batches_match_full_padding():
    images, _ = golden_test_images({0, 1, 2, 3})
    pred = _port_predictor("ViT-Test", CLASSNAMES, **KW)
    full = pred.predict(images)
    for n in (1, 3, 5, 8, 11):
        out = pred.predict(images[:n])
        np.testing.assert_array_equal(out["preds"], full["preds"][:n])
        np.testing.assert_allclose(out["probs"], full["probs"][:n], rtol=0,
                                   atol=1e-6)


def test_drain_batched_pads_to_power_of_two_buckets():
    from clip_calibration_tpu_torch.serving import _drain_batched
    seen = []
    rows = np.arange(11)[:, None].astype(np.float32)
    out = _drain_batched(rows, 4, lambda b: seen.append(len(b)) or b,
                         lambda p: p, bucket=True)
    assert seen == [4, 4, 4] and out.shape == (11, 1)
    seen.clear()
    _drain_batched(rows[:5], 8, lambda b: seen.append(len(b)) or b,
                   lambda p: p, bucket=True)
    assert seen == [8]
    seen.clear()
    _drain_batched(rows[:3], 8, lambda b: seen.append(len(b)) or b,
                   lambda p: p, bucket=True)
    assert seen == [4]


def test_predict_rejects_bad_inputs_and_returns_empty():
    from clip_calibration_tpu_torch.serving import (TrainerPredictor,
                                                    build_serving_trainer)
    pred = _port_predictor("ViT-Test", BASE, **KW)
    with pytest.raises(ValueError):
        pred.predict(np.zeros((2, 32, 32, 3), np.float32))
    with pytest.raises(ValueError):
        pred.predict(np.zeros((2, 3, 32, 32), np.uint8))
    with pytest.raises(ValueError):
        _port_predictor("ViT-Test", BASE, class_confidence=np.ones(3))
    for empty in (np.zeros((0, 32, 32, 3), np.uint8), []):
        out = pred.predict(empty)
        assert out["probs"].shape == (0, 2) and out["preds"].shape == (0,)
    tp = TrainerPredictor(build_serving_trainer(
        BASE, trainer_name="CoOp", backbone="ViT-Test",
        opts=["INPUT.SIZE", "(32, 32)"], device="cpu"), batch_size=4)
    with pytest.raises(ValueError):
        tp.predict(np.zeros((2, 32, 32, 3), np.float32))
    assert tp.predict([])["probs"].shape == (0, 2)


def test_pixel_stats_and_device_preprocess_match_jax():
    rng = np.random.default_rng(11)
    wide = (rng.random((4, 32, 64, 3)) * 255).astype(np.uint8)
    big = (rng.random((3, 48, 40, 3)) * 255).astype(np.uint8)
    names = ["a", "b", "c"]
    jp, pp = _both("ViT-Test", names, preprocess_on_device=True, **KW)
    for imgs in (wide, big):
        np.testing.assert_allclose(pp.predict(imgs)["probs"],
                                   jp.predict(imgs)["probs"],
                                   atol=PROB_ATOL)
    # a shorter side at the model resolution: the crop alone
    host = _port_predictor("ViT-Test", names, **KW)
    np.testing.assert_allclose(pp.predict(wide)["probs"],
                               host.predict(wide[:, :, 16:48])["probs"],
                               rtol=1e-5, atol=1e-6)
    raw = _port_predictor("ViT-Test", names, pixel_stats=(None, None), **KW)
    assert not np.allclose(raw.predict(wide[:, :, 16:48])["probs"],
                           host.predict(wide[:, :, 16:48])["probs"])


def test_mesh_is_not_ported():
    """Mesh serving's int8 and HTTP parts are ported: an int8 and a
    static-w8a8 Predictor build on a tensor-parallel mesh (the weights quantized, the scales
    calibrated unsharded; the TP cuts are held to one rank in
    test_torch_int8_tp.py), and ``--http`` with ``--mesh`` goes on to make
    the mesh as batch mode does (one process cannot hold 2 ranks; HTTP
    over 2 processes is test_torch_http_mesh.py)."""
    from clip_calibration_tpu_torch.ops.quant import is_quantized
    from clip_calibration_tpu_torch.parallel.mesh import Mesh
    from helpers import golden_test_images
    tp_mesh = Mesh((1, 2), 0, None, None, (0,))
    cal, _ = golden_test_images({0, 1})
    for quantize, kw in (("int8", {}), ("w8a8", {"calibration_images": cal})):
        pred = _port_predictor("ViT-Test", BASE, mesh=tp_mesh,
                               quantize=quantize, **kw)
        assert pred.tp is not None and pred.quantize == quantize
        assert is_quantized(pred.model.visual.blocks[0].attn.wo)
        assert (pred.act_stats is not None) == (quantize == "w8a8")
    with pytest.raises(ValueError, match="!= 1 ranks"):
        _serve("--classnames", *BASE, "--http", ":0", "--mesh", "1,2")


def test_predictor_defaults_to_cuda_and_raises():
    from clip_calibration_tpu_torch.serving import Predictor
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor("ViT-Test", BASE)


# ---------------------------------------------------- TrainerPredictor

COOP_OPTS = ["TRAINER.COOP.N_CTX", "4", "INPUT.SIZE", "(32, 32)",
             "MODEL.PRECISION", "fp32", "TRAINER.COOP.PREC", "fp32"]


def test_trainer_predictor_coop_dataset_free_matches_jax():
    from clip_calibration_tpu.serving import TrainerPredictor as JTP
    from clip_calibration_tpu_torch.serving import TrainerPredictor as TTP
    images, _ = golden_test_images({0, 1})
    conf = np.asarray([1.3, 0.7], np.float32)
    want = JTP.from_checkpoint(CKPT, BASE, trainer_name="CoOp",
                               backbone="ViT-Test", opts=COOP_OPTS, epoch=3,
                               class_confidence=conf,
                               batch_size=8).predict(images)
    tp = TTP.from_checkpoint(CKPT, BASE, trainer_name="CoOp",
                             backbone="ViT-Test", opts=COOP_OPTS, epoch=3,
                             class_confidence=conf, batch_size=8,
                             device="cpu")
    assert tp.trainer.test_loader is None  # no dataset behind it
    got = tp.predict(images)
    np.testing.assert_allclose(got["probs"], want["probs"], atol=PROB_ATOL)
    # DAC: the eval pipeline's order, logits scaled, softmax after
    with torch.inference_mode():
        lg = tp.trainer.model_inference(images)[0].numpy()
    scaled = lg * conf[lg.argmax(1)][:, None]
    e = np.exp(scaled - scaled.max(1, keepdims=True))
    np.testing.assert_allclose(got["probs"], e / e.sum(1, keepdims=True),
                               rtol=1e-5, atol=1e-6)


def _tempscaling_checkpoint(tmp_path):
    from clip_calibration_tpu_torch.serving import build_serving_trainer
    opts = ["CALIBRATION.SCALING.BASE_LEARNER", "CoOp",
            "CALIBRATION.SCALING.BASE_DIR", CKPT,
            "CALIBRATION.SCALING.BASE_EPOCH", "3"] + COOP_OPTS
    fitted = build_serving_trainer(BASE, trainer_name="TempScaling",
                                   backbone="ViT-Test", opts=opts,
                                   device="cpu")
    assert fitted.test_loader is None and fitted.base.test_loader is None
    with torch.no_grad():
        fitted.model_params("scale_learner")["scale"].fill_(np.log(2.5))
    ck = str(tmp_path / "calibrated")
    fitted.save_model(0, ck)
    return ck, opts


def test_trainer_predictor_tempscaling_dataset_free(tmp_path):
    from clip_calibration_tpu_torch.serving import TrainerPredictor
    ck, opts = _tempscaling_checkpoint(tmp_path)
    srv = TrainerPredictor.from_checkpoint(
        ck, BASE, trainer_name="TempScaling", backbone="ViT-Test",
        opts=opts, epoch=1, batch_size=8, device="cpu")
    images, _ = golden_test_images({0, 1})
    out = srv.predict(images)
    with torch.inference_mode():
        cos = srv.trainer._unit_logits(images[:8])[0].numpy()
    lg = 2.5 * cos.astype(np.float64)
    e = np.exp(lg - lg.max(1, keepdims=True))
    np.testing.assert_allclose(out["probs"][:8], e / e.sum(1, keepdims=True),
                               rtol=1e-5, atol=1e-6)


def test_quant_frozen_vision_in_dataset_free_builds():
    """A w8a8-flagged checkpoint has no loader to calibrate on: the build
    fails with the override recipe; int8 (calibration-free) serves."""
    from clip_calibration_tpu_torch.ops.quant import is_quantized
    from clip_calibration_tpu_torch.serving import (TrainerPredictor,
                                                    build_serving_trainer)
    with pytest.raises(ValueError, match="dataset-free serving builds"):
        build_serving_trainer(BASE, trainer_name="CoOp", backbone="ViT-Test",
                              opts=COOP_OPTS + [
                                  "TRAINER.QUANT_FROZEN_VISION", "w8a8"],
                              device="cpu")
    served = build_serving_trainer(
        BASE, trainer_name="CoOp", backbone="ViT-Test",
        opts=COOP_OPTS + ["TRAINER.QUANT_FROZEN_VISION", "int8"],
        device="cpu")
    assert is_quantized(served.step_clip_params.visual.proj)
    out = TrainerPredictor(served, batch_size=4).predict(
        np.zeros((2, 32, 32, 3), np.uint8))
    assert np.isfinite(out["probs"]).all()


def test_build_serving_trainer_cfg_rules(tmp_path):
    import threading
    from clip_calibration_tpu_torch.config import get_cfg_default
    from clip_calibration_tpu_torch.engine.registry import TRAINER_REGISTRY
    from clip_calibration_tpu_torch.serving import build_serving_trainer
    with pytest.raises(ValueError, match="trainer_name"):
        build_serving_trainer(BASE, trainer_name="CoOp",
                              cfg=get_cfg_default())
    bare = tmp_path / "bare.yaml"
    bare.write_text("TRAINER:\n  COOP:\n    N_CTX: 2\n")
    t = build_serving_trainer(["a", "b"], trainer_name="CoOp",
                              backbone="ViT-Test", config_file=str(bare),
                              opts=["INPUT.SIZE", "(32, 32)"], device="cpu")
    assert t.pixel_stats == (None, None)
    # the serving subclass is thread-local to the build
    real, seen = TRAINER_REGISTRY.get("CoOp"), {}
    with TRAINER_REGISTRY.wrapped(lambda cls: ("wrapped", cls)):
        th = threading.Thread(
            target=lambda: seen.update(cls=TRAINER_REGISTRY.get("CoOp")))
        th.start()
        th.join()
    assert seen["cls"] is real and TRAINER_REGISTRY.get("CoOp") is real


# ------------------------------------------------------------ serve CLI

def _png_dir(tmp_path, n, shape=(48, 40, 3), seed=7, name="imgs"):
    from PIL import Image
    rng = np.random.default_rng(seed)
    d = tmp_path / name
    d.mkdir()
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(
            str(d / f"im{i}.png"))
    return str(d)


def _rows(path):
    return [json.loads(ln) for ln in open(path)]


def _serve(*argv):
    from clip_calibration_tpu_torch.serve import main
    return main(["--device", "cpu", "--backbone", "ViT-Test",
                 "--precision", "fp32", *argv])


def test_serve_cli_zeroshot_matches_jax_cli(tmp_path):
    from clip_calibration_tpu.serve import main as jax_main
    imgs = _png_dir(tmp_path, 3)
    out, jout = str(tmp_path / "p.jsonl"), str(tmp_path / "j.jsonl")
    args = ["--classnames", *BASE, "--images", imgs, "--topk", "2"]
    assert _serve(*args, "--out", out) == 0
    assert jax_main(["--backbone", "ViT-Test", "--precision", "fp32", *args,
                     "--out", jout]) == 0
    got, want = _rows(out), _rows(jout)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g["image"] == w["image"] and g["pred"] == w["pred"]
        assert len(g["topk"]) == 2
        assert g["confidence"] == pytest.approx(w["confidence"], abs=1e-4)


def test_serve_cli_quantized_paths(tmp_path):
    """--coop-prompt with w8a8: calibrate and save the scales, then reuse
    them (the same bytes out); --quantize int8 zero-shot serves."""
    imgs = _png_dir(tmp_path, 3, shape=(32, 32, 3))
    cal = _png_dir(tmp_path, 4, seed=9, name="cal")
    scales = str(tmp_path / "s.npz")
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    base = ["--classnames", *BASE, "--images", imgs, "--checkpoint-dir",
            CKPT, "--coop-prompt", "--quantize", "w8a8", "--topk", "2"]
    assert _serve(*base, "--calibration-images", cal, "--save-act-scales",
                  scales, "--out", a) == 0
    assert osp.exists(scales)
    assert _serve(*base, "--act-scales", scales, "--out", b) == 0
    assert open(a).read() == open(b).read()
    c = str(tmp_path / "c.jsonl")
    assert _serve("--classnames", *CLASSNAMES, "--images", imgs,
                  "--quantize", "int8", "--out", c) == 0
    assert all(r["pred"] in CLASSNAMES for r in _rows(c))


def test_serve_cli_tempscaling_checkpoint(tmp_path):
    ck, opts = _tempscaling_checkpoint(tmp_path)
    imgs = _png_dir(tmp_path, 2, shape=(32, 32, 3))
    out = str(tmp_path / "p.jsonl")
    assert _serve("--classnames", *BASE, "--images", imgs, "--out", out,
                  "--checkpoint-dir", ck, "--trainer", "TempScaling",
                  "--epoch", "1", *opts) == 0
    assert [r["pred"] in BASE for r in _rows(out)] == [True, True]


@pytest.mark.parametrize("flags,match", [
    (["--temperature", "2.0"], "temperature"),
    (["--preprocess-on-device"], "preprocess-on-device"),
    (["--quantize", "int8"], "quantize"),
    (["--coop-prompt", "--act-scales", "x.npz"], "requires --quantize w8a8"),
    (["--coop-prompt", "--calibration-images", "x"],
     "requires --quantize w8a8"),
    (["--coop-prompt", "--quantize", "w8a8", "--save-act-scales", "x.npz"],
     "persists stats"),
])
def test_serve_cli_flag_guards(tmp_path, flags, match):
    from clip_calibration_tpu_torch import serve
    args = serve.build_parser().parse_args(
        ["--images", str(tmp_path), "--classnames", *BASE, "--device", "cpu",
         "--backbone", "ViT-Test", "--checkpoint-dir", CKPT, "--trainer",
         "CoOp", *flags])
    with pytest.raises(SystemExit, match=match):
        serve.build_predictor(args, BASE)


def test_serve_cli_rejects_mesh_and_needs_a_mode(tmp_path):
    from clip_calibration_tpu_torch import serve
    imgs = _png_dir(tmp_path, 1, shape=(32, 32, 3))
    # one process, no cluster: a mesh of 8 ranks cannot be made
    with pytest.raises(ValueError, match="!= 1 ranks"):
        _serve("--classnames", *BASE, "--images", imgs, "--mesh", "2,4")
    with pytest.raises(SystemExit, match="--images .*--http"):
        _serve("--classnames", "a", "b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--classnames", "a", "--images", str(tmp_path)])


def test_serve_host_geometry_is_bicubic_without_config():
    from PIL import Image
    from clip_calibration_tpu_torch.serve import _host_transform, build_parser
    src = Image.fromarray(
        (np.mgrid[0:64, 0:48][0] * 3 % 256).astype(np.uint8)).convert("RGB")
    args = build_parser().parse_args(["--images", "x", "--classnames", "a"])
    got = _host_transform(args, 32)(src)
    want = np.asarray(src.resize((32, 42), Image.BICUBIC))[5:37, :, :]
    np.testing.assert_array_equal(got, want)
