"""The port's prompt-injected towers against the JAX package: shallow and
deep vision prompts, deep text prompts, at several depths, and the
reference's IVLP and MaPLe golden fixtures.

Both sides run the same random 4-layer tiny CLIP (the JAX init, carried
to the port through ``params_from_numpy``) at fp32 on the CPU, where the
port's attention runs its plain version and the JAX one its Pallas
kernel in interpret mode or the XLA path, as the JAX suite runs them.
"""

import dataclasses
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_calibration_tpu.models import clip as JM
from clip_calibration_tpu.models import weights as JW
from clip_calibration_tpu_torch.models import clip as TM
from clip_calibration_tpu_torch.models import weights as TW
from clip_calibration_tpu_torch.models.tokenizer import tokenize

FIX = osp.join(osp.dirname(__file__), "fixtures")
TOL = dict(rtol=1e-5, atol=1e-5)
N_LAYERS = 4


@pytest.fixture(scope="module")
def deep_pair():
    """A 4-layer ViT-Test (so depth 1, 2 and the full depth differ) in
    both packages, same fp32 weights."""
    cfg = dataclasses.replace(JM.PRESETS["ViT-Test"],
                              vision_layers=N_LAYERS,
                              transformer_layers=N_LAYERS)
    jparams = JM.init_clip(jax.random.PRNGKey(3), cfg, jnp.float32)
    tcfg = TM.CLIPConfig(**{f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(cfg)})
    model = TW.params_from_numpy(JW.flatten_params(jparams), tcfg,
                                 torch.float32, "cpu")
    return jparams, cfg, model, tcfg


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# (shallow n_ctx, deep rows, depth): depth 1 (shallow only), 2, the full
# depth; a stack longer than the tower (trimmed) and one shorter than the
# depth (the missing layers splice zeros); 17 + 8 = 25 real tokens pad to
# 32, 17 + 15 = 32 need no padding
VISION_CASES = [(8, 0, 1), (8, 1, 2), (8, 3, 4), (15, 3, 4), (4, 6, 4),
                (4, 1, 4), (0, 3, 4)]


@pytest.mark.parametrize("n_ctx,rows,depth", VISION_CASES,
                         ids=[f"ctx{n}-rows{r}-depth{d}"
                              for n, r, d in VISION_CASES])
def test_encode_image_with_prompts_matches_jax(deep_pair, n_ctx, rows,
                                               depth):
    jparams, cfg, model, tcfg = deep_pair
    images = _rand(0, 3, 32, 32, 3)
    n = n_ctx or 4
    shallow = _rand(1, n, 64, scale=0.5) if n_ctx else None
    deep = _rand(2, rows, n, 64, scale=0.5) if rows else None
    want = JM.encode_image(
        jparams, cfg, jnp.asarray(images),
        shallow_prompts=None if shallow is None else jnp.asarray(shallow),
        deep_prompts=None if deep is None else jnp.asarray(deep),
        deep_prompt_depth=depth, dtype=jnp.float32)
    with torch.no_grad():
        got = TM.encode_image(
            model, tcfg, torch.from_numpy(images), dtype=torch.float32,
            shallow_prompts=None if shallow is None
            else torch.from_numpy(shallow),
            deep_prompts=None if deep is None else torch.from_numpy(deep),
            deep_prompt_depth=depth)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


TEXT_CASES = [(1, 0), (2, 1), (4, 3), (4, 7), (4, 1)]


@pytest.mark.parametrize("depth,rows", TEXT_CASES,
                         ids=[f"depth{d}-rows{r}" for d, r in TEXT_CASES])
def test_encode_text_embedded_with_deep_prompts_matches_jax(deep_pair,
                                                            depth, rows):
    jparams, cfg, model, tcfg = deep_pair
    toks = tokenize(["X X X a photo of a amber.", "X X X basalt rock."])
    seq = JM.eot_seq_len(toks)
    eot = toks.argmax(-1)
    x = np.asarray(JM.embed_tokens(jparams, jnp.asarray(toks), jnp.float32))
    deep = _rand(3, rows, 3, 64, scale=0.5) if rows else None
    want = JM.encode_text_embedded(
        jparams, cfg, jnp.asarray(x), jnp.asarray(eot), seq_len=seq,
        deep_prompts=None if deep is None else jnp.asarray(deep),
        deep_prompt_depth=depth)
    with torch.no_grad():
        got = TM.encode_text_embedded(
            model, tcfg, torch.from_numpy(x), torch.from_numpy(eot),
            seq_len=seq,
            deep_prompts=None if deep is None else torch.from_numpy(deep),
            deep_prompt_depth=depth)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_vision_prompt_gradient_matches_jax_on_padded_length(deep_pair):
    """d loss / d prompts through the vision tower at 25 real tokens
    padded to 32: a splice at the padded length would move the prompts
    into masked rows and change this gradient (the loss would still
    fall)."""
    jparams, cfg, model, tcfg = deep_pair
    images = _rand(4, 2, 32, 32, 3)
    shallow, deep = _rand(5, 8, 64, scale=0.5), _rand(6, 3, 8, 64,
                                                      scale=0.5)
    w = _rand(7, 32)

    def jloss(s, d):
        f = JM.encode_image(jparams, cfg, jnp.asarray(images),
                            shallow_prompts=s, deep_prompts=d,
                            deep_prompt_depth=N_LAYERS, dtype=jnp.float32)
        return jnp.sum(jnp.tanh(f) * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(shallow),
                                           jnp.asarray(deep))
    s = torch.from_numpy(shallow).requires_grad_()
    d = torch.from_numpy(deep).requires_grad_()
    f = TM.encode_image(model, tcfg, torch.from_numpy(images),
                        dtype=torch.float32, shallow_prompts=s,
                        deep_prompts=d, deep_prompt_depth=N_LAYERS)
    (torch.tanh(f) * torch.from_numpy(w)).sum().backward()
    for got, ref in ((s.grad, want[0]), (d.grad, want[1])):
        assert np.abs(np.asarray(ref)).max() > 1e-4  # not degenerate
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4,
                                   atol=1e-6)
    # every deep row reaches the output (layers 1..3 splice them)
    assert (d.grad.abs().amax(dim=(1, 2)) > 0).all()


def test_resnet_backbone_with_prompts_raises(deep_pair):
    _, _, model, tcfg = deep_pair
    rn = dataclasses.replace(tcfg, vision_layers=(1, 1, 1, 1))
    with pytest.raises(ValueError, match="ResNet"):
        TM.encode_image(model, rn, torch.zeros(1, 32, 32, 3),
                        dtype=torch.float32,
                        shallow_prompts=torch.zeros(2, 64))


# ---------------------------------------------------------------- golden

def _golden(name):
    data = np.load(osp.join(FIX, name))
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}
    cfg = dataclasses.replace(TW.config_from_torch_state_dict(sd),
                              transformer_heads=4)
    # the reference's prompt parameters are inputs here
    backbone = {k: v for k, v in sd.items() if "VPT" not in k}
    model, cfg = TW.convert_torch_clip(backbone, "float32", cfg=cfg,
                                       device="cpu")
    return data, sd, model, cfg


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _text(model, cfg, data, deep):
    toks = torch.as_tensor(data["toks"], dtype=torch.long)
    x = model.text.token_embedding[toks]
    return TM.encode_text_embedded(model, cfg, x, toks.argmax(-1),
                                   deep_prompts=deep, deep_prompt_depth=2)


@pytest.mark.parametrize("tower", ["image", "text"])
def test_ivlp_golden(tower):
    data, sd, model, cfg = _golden("ivlp_golden.npz")
    with torch.no_grad():
        if tower == "image":
            got = TM.encode_image(
                model, cfg, _t(data["imgs"]), dtype=torch.float32,
                shallow_prompts=_t(sd["visual.VPT"]),
                deep_prompts=_t(sd["visual.transformer.resblocks.1."
                                   "VPT_shallow"])[None],
                deep_prompt_depth=2)
            want = data["img_f"]
        else:
            got = _text(model, cfg, data, _t(
                sd["transformer.resblocks.1.VPT_shallow"])[None])
            want = data["txt_f"]
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("tower", ["image", "text"])
def test_maple_golden(tower):
    data, _, model, cfg = _golden("maple_golden.npz")
    with torch.no_grad():
        if tower == "image":
            got = TM.encode_image(
                model, cfg, _t(data["imgs"]), dtype=torch.float32,
                shallow_prompts=_t(data["shared_ctx"]),
                deep_prompts=_t(data["deep_vis"])[None],
                deep_prompt_depth=2)
            want = data["img_f"]
        else:
            got = _text(model, cfg, data, _t(data["deep_text"])[None])
            want = data["txt_f"]
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-4)
