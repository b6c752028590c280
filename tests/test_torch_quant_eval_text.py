"""The port's quantized eval-time text fan-out (``TRAINER.QUANT_EVAL_TEXT``):
the twin of all five tests of tests/test_quant_eval_text.py, and the text
tower's calibrated activation stats against the JAX package's.

Each pair of port trainers (plain and quantized) is built alike on the
ViT-Test seeded init (bf16, the configs' precision), so their train steps
see the same batch: the port's loader seeds every item (the JAX loader
draws from the global ``random`` on a thread pool, which makes its twin
of the first test nondeterministic). The train step never runs the
quantized tower, so its loss is bit-identical with the flag on; eval
gives the same argmax, and text features within cosine 0.99 of the
full-precision ones (the JAX test's bounds).
"""

import os.path as osp
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, osp.dirname(osp.abspath(__file__)))
from test_torch_training import _port_trainer  # noqa: E402

from clip_calibration_tpu_torch.ops import quant as Q  # noqa: E402


def _build(name, root, mode="", tcfg=None):
    ov = {"DATASET.NUM_SHOTS": 4, "DATALOADER.NUM_WORKERS": 2,
          "TRAINER.QUANT_EVAL_TEXT": mode}
    ov.update({f"TRAINER.{name.upper()}.{k}": v
               for k, v in (tcfg or {}).items()})
    return _port_trainer(name, root / "data", root / ("out_" + (mode or
                                                                 "plain")),
                         ov)


def _pair(name, tmp_path, mode="w8a8", tcfg=None):
    return (_build(name, tmp_path, "", tcfg),
            _build(name, tmp_path, mode, tcfg))


def _cos(a, b):
    a, b = a.float().numpy(), b.float().numpy()
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1)
                                * np.linalg.norm(b, axis=-1))


def test_cocoop_w8a8_eval_text(tmp_path):
    plain, quant = _pair("CoCoOp", tmp_path, tcfg={"N_CTX": 4})

    # the TRAIN step never sees the quantized text tower: the losses on
    # the same batch are bit-identical (gradients flow through text)
    batch = next(iter(plain.train_loader_x))
    assert np.array_equal(batch["img"],
                          next(iter(quant.train_loader_x))["img"])
    lp = float(plain.forward_backward(batch)["loss"])
    lq = float(quant.forward_backward(batch)["loss"])
    assert lp == lq

    imgs = next(iter(plain.test_loader))["img"]
    with torch.inference_mode():
        l0, _, t0 = plain.model_inference(imgs)
        l1, _, t1 = quant.model_inference(imgs)
    np.testing.assert_array_equal(l0.argmax(-1).numpy(),
                                  l1.argmax(-1).numpy())
    # the last image's per-class text features within quantization noise
    cos = _cos(t0, t1)
    assert float(cos.min()) > 0.99, float(cos.min())

    # the quantized model: text matmul weights int8 with static act
    # scales; the vision tower's weights stay plain parameters
    qm = quant.eval_text_clip_params()
    assert Q.is_quantized(qm.text.text_projection)
    assert qm.text.text_projection.act_scale is not None
    assert Q.is_quantized(qm.text.blocks[0].mlp.w_fc)
    assert not Q.is_quantized(qm.visual.proj)

    # any train step invalidates the calibrated scales (ctx moved)
    quant.forward_backward(batch)
    assert quant._eval_text_params is None
    with torch.inference_mode():
        quant.model_inference(imgs)
    assert quant._eval_text_params is not None


def test_proda_w8a8_classifier(tmp_path):
    tcfg = {"N_PROMPT": 4, "PROMPT_BS": 2, "N_CTX": 4}
    plain, quant = _pair("ProDA", tmp_path, tcfg=tcfg)
    batch = next(iter(plain.train_loader_x))
    lp = float(plain.forward_backward(batch)["loss"])
    lq = float(quant.forward_backward(batch)["loss"])
    assert lp == lq  # train path untouched

    plain.set_classifier()
    quant.set_classifier()
    cos = _cos(plain.text_features, quant.text_features)
    assert float(cos.min()) > 0.99, float(cos.min())

    imgs = next(iter(plain.test_loader))["img"]
    with torch.inference_mode():
        l0, *_ = plain.model_inference(imgs)
        l1, *_ = quant.model_inference(imgs)
    np.testing.assert_array_equal(l0.argmax(-1).numpy(),
                                  l1.argmax(-1).numpy())

    # training invalidates BOTH the classifier and the text scales
    quant.forward_backward(batch)
    assert quant.text_features is None
    assert quant._eval_text_params is None


def test_cocoop_int8_weight_only(tmp_path):
    quant = _build("CoCoOp", tmp_path, "int8", {"N_CTX": 4})
    qm = quant.eval_text_clip_params()
    assert Q.is_quantized(qm.text.text_projection)
    assert qm.text.text_projection.act_scale is None
    assert quant.text_eval_qmode() == "dequant"
    imgs = next(iter(quant.test_loader))["img"]
    with torch.inference_mode():
        logits, *_ = quant.model_inference(imgs)
    assert torch.isfinite(logits).all()


def test_one_shot_trainers_refuse(tmp_path):
    # CoOp-family class features are encoded once per eval: quantizing
    # that single pass buys nothing and would silently change the
    # parity-exact features, so the flag raises rather than no-ops
    with pytest.raises(ValueError, match="once per eval"):
        _build("CoOp", tmp_path, "w8a8", {"N_CTX": 4})


def test_unknown_mode_rejected(tmp_path):
    with pytest.raises(ValueError, match="expected"):
        _build("CoCoOp", tmp_path, "fp4", {"N_CTX": 4})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_text_act_stats_match_jax(dtype):
    """``calibrate_text_act_scales`` on the same int8 text tower and
    embedded prompts gives the JAX function's absmax per site (fp32:
    within summation order; bf16: one or two bf16 ulps, as the image
    stats in tests/test_torch_quant.py), and ``attach_text_act_scales``
    its scales' layout."""
    from clip_calibration_tpu.models import clip as JM
    from clip_calibration_tpu.ops import quant as JQ
    from clip_calibration_tpu_torch.models import clip as TM
    from clip_calibration_tpu_torch.models.weights import params_from_numpy
    from test_torch_resnet import jax_flat
    cfg = JM.PRESETS["ViT-Test"]
    params = JM.init_clip(jax.random.PRNGKey(2), cfg, dtype=jnp.float32)
    model = params_from_numpy(jax_flat(params), TM.PRESETS["ViT-Test"],
                              torch.float32, "cpu")
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((6, 77, 64)) * 0.1).astype(np.float32)
    eot = np.array([5, 9, 3, 12, 7, 4])
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    jq = JQ.quantize_clip_params(params, towers=("text",))
    want = JQ.calibrate_text_act_scales(jq, cfg, jnp.asarray(x, jdt),
                                        jnp.asarray(eot), seq_len=13)
    qm = Q.quantize_clip_params(model, towers=("text",))
    got = Q.stats_to_numpy(Q.calibrate_text_act_scales(
        qm, qm.cfg, torch.from_numpy(x).to(tdt), torch.from_numpy(eot),
        seq_len=13))
    rtol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got["text_projection"],
                               np.asarray(want["text_projection"],
                                          np.float32), rtol=rtol)
    for outer, key in Q.BLOCK_WEIGHTS:
        assert got["blocks"][outer][key].shape == (2,)
        np.testing.assert_allclose(
            got["blocks"][outer][key],
            np.asarray(want["blocks"][outer][key], np.float32), rtol=rtol)
    jq = JQ.attach_text_act_scales(jq, want)
    qm = Q.attach_text_act_scales(qm, got)
    np.testing.assert_allclose(
        float(qm.text.text_projection.act_scale),
        float(jq["text"]["text_projection"]["act_scale"]), rtol=rtol)
    for i, block in enumerate(qm.text.blocks):
        np.testing.assert_allclose(
            float(block.attn.wqkv.act_scale),
            float(jq["text"]["blocks"]["attn"]["wqkv"]["act_scale"][i]),
            rtol=rtol)
