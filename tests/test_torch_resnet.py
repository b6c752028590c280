"""The port's ModifiedResNet tower against the JAX package and the
reference's activations.

The golden fixture (a tiny reference ModifiedResNet's state dict, input
and output) reaches the port through its OpenAI-format converter; the JAX
package's RN-Test init reaches it through ``params_from_numpy`` (the JAX
tree flattened with the blocks' list index as a path part, conv kernels
HWIO there, OIHW in the port). fp32 throughout, at the rtol=atol=2e-4 of
tests/test_clip_model.py.
"""

import dataclasses
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_calibration_tpu.models import clip as JM
from clip_calibration_tpu.models import resnet as JR
from clip_calibration_tpu_torch.models import clip as TM
from clip_calibration_tpu_torch.models import resnet as TR
from clip_calibration_tpu_torch.models import weights as TW

FIX = osp.join(osp.dirname(__file__), "fixtures")
TOL = dict(rtol=2e-4, atol=2e-4)
# the golden fixture's tower (tests/test_clip_model.py)
GOLDEN_CFG = dict(embed_dim=32, image_resolution=64,
                  vision_layers=(1, 1, 1, 1), vision_width=16,
                  vision_patch_size=None, transformer_width=64,
                  transformer_heads=2, transformer_layers=2)


def jax_flat(tree, prefix=""):
    """The JAX package's param tree as flat numpy leaves, lists indexed."""
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, list) else None)
    if items is None:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(jax_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _golden():
    data = np.load(osp.join(FIX, "resnet_golden.npz"))
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}
    return sd, data["x"], data["out"]


def _port_model(cfg, visual_flat):
    """A port CLIP on the CPU whose vision tower is ``visual_flat`` (the
    text tower a seeded init), built through ``params_from_numpy``."""
    flat = TW.flat_params(TM.init_clip(TM.CLIP(cfg, torch.float32, "cpu"),
                                       0))
    flat.update(visual_flat)
    return TW.params_from_numpy(flat, cfg, torch.float32, "cpu")


def test_golden_fixture_forward():
    """The reference tower's output, through the port's converter."""
    sd, x, want = _golden()
    cfg = TM.CLIPConfig(**GOLDEN_CFG)
    model = _port_model(cfg, TR.convert_torch_resnet(sd, cfg))
    with torch.inference_mode():
        got = TM.encode_image(model, cfg, torch.from_numpy(x),
                              dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_converter_matches_jax():
    """Every leaf of the port's flat conversion equals the JAX
    package's tree (HWIO kernels, [in, out] projections)."""
    sd, _, _ = _golden()
    cfg = TM.CLIPConfig(**GOLDEN_CFG)
    got = TR.convert_torch_resnet(sd, cfg)
    want = jax_flat(JR.convert_torch_resnet(
        sd, JM.CLIPConfig(**GOLDEN_CFG), np.float32), "visual")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("layers,width,res,embed", [
    ((1, 1, 1, 1), 8, 32, 32),     # RN-Test
    ((2, 1, 2, 1), 16, 64, 48),
    ((3, 4, 23, 3), 8, 32, 16),    # RN101's depths at a tiny width
], ids=["rn-test", "rn-mixed", "rn101-depths"])
def test_forward_matches_jax(layers, width, res, embed):
    """The JAX package's init carried into the port: the same features."""
    kw = dict(embed_dim=embed, image_resolution=res, vision_layers=layers,
              vision_width=width, vision_patch_size=None,
              transformer_width=64, transformer_heads=4,
              transformer_layers=2)
    jcfg, cfg = JM.CLIPConfig(**kw), TM.CLIPConfig(**kw)
    params = JM.init_clip(jax.random.PRNGKey(width), jcfg,
                          dtype=jnp.float32)
    model = TW.params_from_numpy(jax_flat(params), cfg, torch.float32,
                                 "cpu")
    x = np.random.default_rng(width).standard_normal(
        (2, res, res, 3)).astype(np.float32)
    want = JM.encode_image(params, jcfg, jnp.asarray(x), dtype=jnp.float32)
    with torch.inference_mode():
        got = TM.encode_image(model, cfg, torch.from_numpy(x),
                              dtype=torch.float32)
    assert got.shape == (2, embed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_weight_carry_round_trip(tmp_path):
    """HWIO in, OIHW in the module, HWIO out again: flat_params gives back
    the JAX tree's leaves, and the npz format carries them."""
    cfg = TM.PRESETS["RN-Test"]
    params = JM.init_clip(jax.random.PRNGKey(3), JM.PRESETS["RN-Test"],
                          dtype=jnp.float32)
    flat = jax_flat(params)
    model = TW.params_from_numpy(flat, cfg, torch.float32, "cpu")
    assert tuple(model.visual.stem.conv1.shape) == (4, 3, 3, 3)  # OIHW
    np.testing.assert_array_equal(
        model.visual.stem.conv1.permute(2, 3, 1, 0).numpy(),
        flat["visual/stem/conv1"])
    back = TW.flat_params(model)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k].numpy(), flat[k], err_msg=k)
    TW.save_params(str(tmp_path / "RN-Test.npz"), model)
    again = TW.params_from_numpy(TW.load_params(str(tmp_path /
                                                    "RN-Test.npz")),
                                 cfg, torch.float32, "cpu")
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              again.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_state_dict_config_inferred():
    """An OpenAI-layout RN state dict gives back its config."""
    sd, _, _ = _golden()
    sd = dict(sd)
    cfg = TM.CLIPConfig(**GOLDEN_CFG)
    sd.update({"text_projection": np.zeros((64, 32), np.float32),
               "positional_embedding": np.zeros((77, 64), np.float32),
               "token_embedding.weight": np.zeros((49408, 64), np.float32),
               "ln_final.weight": np.zeros((64,), np.float32)})
    for i in range(2):
        sd[f"transformer.resblocks.{i}.ln_1.weight"] = np.zeros(64)
    got = TW.config_from_torch_state_dict(sd)
    assert got == dataclasses.replace(cfg, transformer_heads=1)


def test_bf16_tower_runs_and_follows_fp32():
    cfg = TM.PRESETS["RN-Test"]
    m32 = TM.init_clip(TM.CLIP(cfg, torch.float32, "cpu"), 1)
    m16 = TW.params_from_numpy(TW.flat_params(m32), cfg, torch.bfloat16,
                               "cpu")
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        a = TM.encode_image(m32, cfg, x, dtype=torch.float32)
        b = TM.encode_image(m16, cfg, x, dtype=torch.bfloat16)
    assert b.dtype == torch.bfloat16
    cos = torch.nn.functional.cosine_similarity(a, b.float())
    assert float(cos.min()) > 0.99


def test_quantization_and_prompts_refused():
    """No int8 ResNet tower and no vision prompts on it, as in JAX
    (``ops/quant.py:188-192``, ``models/clip.py:516``)."""
    from clip_calibration_tpu_torch.ops import quant as Q
    cfg = TM.PRESETS["RN-Test"]
    model = TM.init_clip(TM.CLIP(cfg, torch.float32, "cpu"), 0)
    with pytest.raises(ValueError, match="ViT"):
        Q.quantize_clip_params(model)
    Q.quantize_clip_params(model, towers=("text",))  # the text tower may
    x = torch.zeros((1, 32, 32, 3))
    with pytest.raises(ValueError, match="ViT"):
        TM.encode_image(model, cfg, x, collect_act_stats=True)
    with pytest.raises(ValueError, match="ResNet"):
        TM.encode_image(model, cfg, x, shallow_prompts=torch.zeros(2, 8))
