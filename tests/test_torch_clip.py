"""The port's CLIP towers and weight formats against the JAX package.

Parameters come from the JAX package's ``ViT-Test.npz`` and reach the
port through ``params_from_numpy``; the OpenAI-format golden fixture
reaches both through their converters. fp32 throughout, at the
``rtol=atol=2e-4`` of tests/test_clip_model.py.
"""

import dataclasses
import os.path as osp

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clip_calibration_tpu.models import clip as JM
from clip_calibration_tpu.models import weights as JW
from clip_calibration_tpu_torch.models import clip as TM
from clip_calibration_tpu_torch.models import weights as TW
from clip_calibration_tpu_torch.models.tokenizer import tokenize

FIX = osp.join(osp.dirname(__file__), "fixtures")
NPZ = osp.join(FIX, "golden_e2e", "weights", "ViT-Test.npz")
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def both():
    cfg = JM.PRESETS["ViT-Test"]
    jparams = JW.load_params(NPZ)
    model = TW.params_from_numpy(JW.flatten_params(jparams),
                                 TM.PRESETS["ViT-Test"], torch.float32,
                                 "cpu")
    return jparams, model, cfg


def _images(seed, n=3, size=32):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def test_encode_image_matches_jax(both):
    jparams, model, cfg = both
    x = _images(0)
    want = JM.encode_image(jparams, cfg, jnp.asarray(x), dtype=jnp.float32)
    with torch.inference_mode():
        got = TM.encode_image(model, model.cfg, torch.from_numpy(x),
                              dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encode_text_matches_jax(both):
    jparams, model, cfg = both
    toks = tokenize(["a photo of a amber.", "a photo of a basalt rock.",
                     "x"])
    seq = JM.eot_seq_len(toks)
    want = JM.encode_text(jparams, cfg, jnp.asarray(toks),
                          dtype=jnp.float32, seq_len=seq)
    with torch.inference_mode():
        got = TM.encode_text(model, model.cfg,
                             torch.as_tensor(toks, dtype=torch.long),
                             dtype=torch.float32, seq_len=seq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("seq_len", [None, 24])
def test_encode_text_embedded_matches_jax(both, seq_len):
    jparams, model, cfg = both
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 77, 64)) * 0.1).astype(np.float32)
    eot = np.array([5, 23, 11, 17])
    want = JM.encode_text_embedded(jparams, cfg, jnp.asarray(x),
                                   jnp.asarray(eot), seq_len=seq_len)
    with torch.inference_mode():
        got = TM.encode_text_embedded(model, model.cfg, torch.from_numpy(x),
                                      torch.from_numpy(eot),
                                      seq_len=seq_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_seq_len_guard_raises(both):
    _, model, _ = both
    x = torch.zeros((2, 77, 64))
    with pytest.raises(ValueError, match="drops an EOT"):
        TM.encode_text_embedded(model, model.cfg, x,
                                torch.tensor([3, 12]), seq_len=12)


def test_cosine_logits_and_normalize_match_jax():
    rng = np.random.default_rng(2)
    img = rng.standard_normal((5, 32)).astype(np.float32)
    txt = rng.standard_normal((7, 32)).astype(np.float32)
    want = JM.cosine_logits(jnp.asarray(img), jnp.asarray(txt),
                            jnp.asarray(np.float32(2.5)))
    got = TM.cosine_logits(torch.from_numpy(img), torch.from_numpy(txt),
                           torch.tensor(2.5))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_transformer_pad_once_matches_jax(both):
    """L=13 pads to 16 inside the tower; real tokens are unaffected."""
    jparams, model, _ = both
    x = (np.random.default_rng(3).standard_normal((3, 13, 64))
         * 0.1).astype(np.float32)
    want = JM.transformer(jparams["text"]["blocks"], jnp.asarray(x), 4,
                          JM.causal_mask(13))
    with torch.inference_mode():
        got = TM.transformer(model.text.blocks, torch.from_numpy(x), 4,
                             TM.causal_mask(13))
    assert got.shape == (3, 13, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_splices_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 10, 8)).astype(np.float32)
    prompt = rng.standard_normal((3, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        TM._splice_text(torch.from_numpy(x), torch.from_numpy(prompt)),
        np.asarray(JM._splice_text(jnp.asarray(x), jnp.asarray(prompt), 10)))
    np.testing.assert_array_equal(
        TM._splice_vision(torch.from_numpy(x), torch.from_numpy(prompt), 8),
        np.asarray(JM._splice_vision(jnp.asarray(x), jnp.asarray(prompt),
                                     8)))


# ---------------------------------------------------------------- golden

@pytest.fixture(scope="module")
def golden():
    data = np.load(osp.join(FIX, "clip_golden.npz"))
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}
    cfg = TW.config_from_torch_state_dict(sd)
    # heads aren't recoverable from shapes for the 48-wide fixture; the
    # fixture model used 4 (tests/test_clip_model.py::_fixture_cfg)
    cfg = dataclasses.replace(cfg, transformer_heads=4)
    model, cfg = TW.convert_torch_clip(sd, "float32", cfg=cfg,
                                       device="cpu")
    return data, model, cfg


@pytest.mark.parametrize("what", ["image", "text", "logits"])
def test_converted_openai_dict_matches_golden(golden, what):
    data, model, cfg = golden
    with torch.inference_mode():
        img_f = TM.encode_image(model, cfg, torch.from_numpy(data["imgs"]),
                                dtype=torch.float32)
        txt_f = TM.encode_text(model, cfg,
                               torch.as_tensor(data["toks"],
                                               dtype=torch.long),
                               dtype=torch.float32)
    if what == "image":
        np.testing.assert_allclose(img_f.numpy(), data["img_f"], **TOL)
    elif what == "text":
        np.testing.assert_allclose(txt_f.numpy(), data["txt_f"], **TOL)
    else:
        logits = TM.cosine_logits(img_f, txt_f, model.logit_scale)
        np.testing.assert_allclose(logits.numpy(),
                                   data["logits_per_image"], rtol=2e-4,
                                   atol=2e-3)


def test_converter_matches_jax_converter(golden):
    data, model, cfg = golden
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}
    jparams, _ = JW.convert_torch_clip(sd, "float32", cfg=JM.CLIPConfig(
        **dataclasses.asdict(cfg)))
    want = JW.flatten_params(jparams)
    got = TW.flat_params(model)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


# ---------------------------------------------------------- npz formats

def test_npz_written_by_jax_loads_in_port_bf16(tmp_path):
    jparams = JM.init_clip(__import__("jax").random.PRNGKey(0),
                           JM.PRESETS["ViT-Test"], dtype=jnp.bfloat16)
    path = str(tmp_path / "jax.npz")
    JW.save_params(path, jparams)
    model = TW.params_from_numpy(TW.load_params(path),
                                 TM.PRESETS["ViT-Test"], torch.bfloat16,
                                 "cpu")
    want = JW.flatten_params(jparams)
    got = TW.flat_params(model)
    for k in want:
        np.testing.assert_array_equal(
            got[k].float().numpy(), np.asarray(want[k], np.float32),
            err_msg=k)
    assert model.visual.blocks[0].attn.wqkv.dtype == torch.bfloat16


def test_npz_written_by_port_loads_in_jax(tmp_path):
    model = TM.init_clip(TM.CLIP(TM.PRESETS["ViT-Test"], torch.bfloat16,
                                 "cpu"), seed=3)
    path = str(tmp_path / "port.npz")
    TW.save_params(path, model)
    jflat = JW.flatten_params(JW.load_params(path))
    for k, v in TW.flat_params(model).items():
        assert str(jflat[k].dtype) == str(v.dtype).split(".")[-1], k
        np.testing.assert_array_equal(np.asarray(jflat[k], np.float32),
                                      v.float().numpy(), err_msg=k)


def test_params_from_numpy_rejects_incomplete_dicts(both):
    jparams = JW.flatten_params(JW.load_params(NPZ))
    jparams.pop("visual/proj")
    with pytest.raises(KeyError, match="visual.proj"):
        TW.params_from_numpy(jparams, TM.PRESETS["ViT-Test"],
                             torch.float32, "cpu")
