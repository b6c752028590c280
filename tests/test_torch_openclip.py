"""OpenCLIP's tower layout in the port (stated vision heads, MLP widths
and the exact GELU), held at a tiny size to the benchmark's plain fp32
references (``portbench/reference/``) on its seeded weights
(``portbench/weights.py``), on the CPU: the towers' features, CoOp's
first context gradient, one block against ``torch.nn``'s, and the
checkpoint loader. No JAX twin exists: the JAX package runs OpenAI's
layout alone.

Each comparison is also made against a reference that runs what a port
ignoring the configuration would (QuickGELU for the exact GELU; the MLP's
hidden features past 4x the width dropped) and has to fail there, so the
tolerances are shown tight enough to catch either.

The kernels' side: K1's dispatch allows head dim 104 in bf16 alone and
names the dim, kernel and dtype it refuses; the plain versions (what the
CPU runs) match SDPA and its autograd at head dim 104.
"""

import dataclasses
import os.path as osp
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from clip_calibration_tpu_torch.models import clip as M
from clip_calibration_tpu_torch.models import weights as TW
from clip_calibration_tpu_torch.ops import mha_qkv as mq
from clip_calibration_tpu_torch.ops.attention import (multi_head_attention,
                                                      quick_gelu)
from clip_calibration_tpu_torch.ops.quant import qdot
from portbench import harness
from portbench import weights as W
from portbench.drivers import common
from portbench.drivers import train as train_driver
from portbench.reference import coop_ref
from portbench.reference.clip_ref import MEAN, STD, ReferenceCLIP
from portbench.test_portbench_schema import SEED, TINY, _open_clip_block

#: fp32 on the CPU, port and reference differ only in summation order (the
#: port pads the token axis to 16 and masks; splits heads in its own way):
#: measured 6.0e-7 (image) and 7.5e-7 (text) of the largest value, where
#: QuickGELU for GELU moves them by 7.4e-3 and 1.9e-2 and a 4x vision MLP
#: by 0.39 (each asserted below at over 10x the tolerance)
FEATURE_RTOL = 1e-5
#: the context gradient passes back through two text blocks and the
#: cross-entropy over 12 classes: measured 2.8e-6, against 5.7e-2
#: (QuickGELU) and 0.34 (4x vision MLP)
GRAD_RTOL = 1e-5


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _cut_mlp(weights: dict, cfg: dict) -> dict:
    """``weights`` with each block's MLP features past 4x its tower's width
    zeroed: what a port running OpenAI's 4x MLP computes."""
    out = dict(weights)
    for tower, key in (("visual", "vision"), ("text", "transformer")):
        keep = 4 * cfg[f"{key}_width"]
        for i in range(cfg[f"{key}_layers"]):
            p = f"{tower}.blocks.{i}.mlp."
            w, b = out[p + "w_fc"].clone(), out[p + "b_fc"].clone()
            w[:, keep:], b[keep:] = 0.0, 0.0
            out[p + "w_fc"], out[p + "b_fc"] = w, b
    return out


#: the references a wrong port would match: (config, weights) from the
#: benchmark's
WRONG = {
    "quick_gelu": lambda cfg, ws: ({**cfg, "activation": "quick_gelu"}, ws),
    "4x_mlp": lambda cfg, ws: (cfg, _cut_mlp(ws, cfg)),
}


@pytest.fixture(scope="module")
def tiny():
    ws = W.make(TINY, SEED, "cpu")
    ccfg = common.port_config(TINY)
    model = W.load_into(M.CLIP(ccfg, torch.float32, "cpu"), ws)
    return ccfg, model, ws


def test_port_config_states_openclip_layout(tiny):
    ccfg, model, _ = tiny
    assert (ccfg.vision_heads, ccfg.vision_mlp_width,
            ccfg.transformer_mlp_width, ccfg.activation) == (2, 1024, 512,
                                                             "gelu")
    assert model.visual.blocks[0].mlp.w_fc.shape == (208, 1024)
    assert model.text.blocks[1].mlp.w_proj.shape == (512, 128)
    big = M.PRESETS["ViT-bigG/14"]
    assert (big.vision_width // big.vision_heads, big.vision_mlp_width,
            big.transformer_width // big.transformer_heads,
            big.transformer_mlp_width, big.activation) == (104, 8192, 64,
                                                           5120, "gelu")
    # OpenAI's presets keep their layout
    b16 = M.PRESETS["ViT-B/16"]
    assert (b16.vision_heads, b16.vision_mlp_width, b16.transformer_mlp_width,
            b16.activation) == (12, 3072, 2048, "quick_gelu")
    with pytest.raises(ValueError, match="activation"):
        dataclasses.replace(b16, activation="relu")


def _image_gap(model, ccfg, ref_cfg, ws) -> float:
    gen = torch.Generator().manual_seed(SEED)
    images = torch.randint(0, 256, (3, 32, 32, 3), generator=gen,
                           dtype=torch.uint8)
    x = (images.float() / 255.0 - torch.tensor(MEAN)) / torch.tensor(STD)
    with torch.no_grad():
        got = M.encode_image(model, ccfg, x, dtype=torch.float32)
    return _rel(got, ReferenceCLIP(ref_cfg, ws).image_features(images))


def _text_gap(model, ccfg, ref_cfg, ws) -> float:
    tokens = torch.zeros((3, 77), dtype=torch.long)
    tokens[:, 0] = 49406
    for row, n in enumerate((2, 5, 9)):
        tokens[row, 1:1 + n] = torch.arange(320, 320 + n)
        tokens[row, 1 + n] = 49407
    with torch.no_grad():
        got = M.encode_text(model, ccfg, tokens, dtype=torch.float32,
                            seq_len=M.eot_seq_len(tokens.numpy()))
    return _rel(got, ReferenceCLIP(ref_cfg, ws).text_features(tokens))


@pytest.mark.parametrize("tower", ["image", "text"])
def test_tower_features_match_the_reference(tiny, tower):
    ccfg, model, ws = tiny
    gap = {"image": _image_gap, "text": _text_gap}[tower]
    assert gap(model, ccfg, TINY, ws) <= FEATURE_RTOL
    # the text MLP is 4x its width here (as bigG's): only the vision tower
    # has features past 4x to drop
    for wrong in ("quick_gelu", "4x_mlp") if tower == "image" \
            else ("quick_gelu",):
        assert gap(model, ccfg, *WRONG[wrong](TINY, ws)) \
            > 10 * FEATURE_RTOL, wrong


@pytest.fixture(scope="module")
def coop_step():
    """The benchmark's CoOp driver at the tiny OpenCLIP shape, fp32 on the
    CPU: the port's trainer, its first context gradient."""
    tr = harness._json(osp.join(harness.HERE, "traffic", "coop-in500.json"))
    tr = {**tr, **tr["rehearsal"], "checked_steps": 1}
    tr["cfg"] = {**tr["cfg"], "TRAINER.COOP.PREC": "fp32"}
    run = SimpleNamespace(config=TINY, traffic=tr, seed=SEED,
                          device=torch.device("cpu"))
    drv = train_driver.Driver(run)
    drv.setup()
    return drv


def _grad_gap(drv, ref_cfg, ws) -> float:
    ref = coop_ref.train_steps(
        ref_cfg, ws, drv.names, drv.ctx0, [torch.as_tensor(drv.images[0])],
        [torch.as_tensor(drv.labels[0])], drv.tr)
    return _rel(drv.grad1.float(), ref["grad1"])


def test_coop_context_gradient_matches_the_reference(coop_step):
    ws = coop_step.weights
    assert _grad_gap(coop_step, TINY, ws) <= GRAD_RTOL
    for wrong, make in WRONG.items():
        assert _grad_gap(coop_step, *make(TINY, ws)) > 10 * GRAD_RTOL, wrong


@pytest.mark.parametrize("activation", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("tower", ["visual", "text"])
def test_block_is_open_clips(tower, activation):
    cfg = {**TINY, "activation": activation}
    ws = W.make(cfg, SEED, "cpu")
    ccfg = common.port_config(cfg)
    model = W.load_into(M.CLIP(ccfg, torch.float32, "cpu"), ws)
    key = "vision" if tower == "visual" else "transformer"
    width, heads = cfg[f"{key}_width"], cfg[f"{key}_heads"]
    L = 17 if tower == "visual" else 12
    x = torch.randn((3, L, width),
                    generator=torch.Generator().manual_seed(SEED))
    blocks = model.visual.blocks if tower == "visual" else model.text.blocks
    with torch.no_grad():
        got = blocks[1](x, heads, M.causal_mask(L) if tower == "text"
                        else torch.zeros((L, L)))
        want = _open_clip_block(
            ws, f"{tower}.blocks.1.", width, heads, cfg[f"{key}_mlp_width"],
            activation)(x, None if tower == "visual" else torch.triu(
                torch.full((L, L), float("-inf")), diagonal=1))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_default_block_is_quick_gelu_bit_for_bit(dtype):
    """OpenAI's layout runs the block exactly as it was written before the
    activation and MLP width became the config's."""
    cfg = M.PRESETS["ViT-Test"]
    model = M.init_clip(M.CLIP(cfg, dtype, "cpu"), 3)
    b = model.visual.blocks[1]
    gen = torch.Generator().manual_seed(1)
    h = torch.randn((2, 17, 64), generator=gen).to(dtype)
    mask = torch.zeros((17, 17))
    got = b(h, cfg.vision_heads, mask)
    a, m = b.attn, b.mlp
    h = h + multi_head_attention(b.ln_1(h), a.wqkv, a.bqkv, a.wo, a.bo,
                                 cfg.vision_heads, mask)
    fc_in = b.ln_2(h)
    y = quick_gelu(qdot(fc_in, m.w_fc, "dequant") + m.b_fc.to(fc_in.dtype))
    want = h + (qdot(y, m.w_proj, "dequant") + m.b_proj.to(y.dtype))
    assert torch.equal(got, want)


# -- the checkpoint loader ----------------------------------------------------

def _openclip_state_dict(cfg: dict, ws: dict) -> dict:
    """The benchmark's weights under OpenCLIP's (= OpenAI's) key names and
    layouts ([out, in] products, the patch kernel as a conv)."""
    n = {k: v.numpy() for k, v in ws.items()}
    p, vw = cfg["vision_patch_size"], cfg["vision_width"]
    sd = {
        "visual.conv1.weight": n["visual.patch_kernel"].reshape(
            p, p, 3, vw).transpose(3, 2, 0, 1),
        "visual.class_embedding": n["visual.class_embedding"],
        "visual.positional_embedding": n["visual.positional_embedding"],
        "visual.proj": n["visual.proj"],
        "token_embedding.weight": n["text.token_embedding"],
        "positional_embedding": n["text.positional_embedding"],
        "text_projection": n["text.text_projection"],
        "logit_scale": n["logit_scale"],
    }
    for ours, theirs in (("visual.ln_pre", "visual.ln_pre"),
                         ("visual.ln_post", "visual.ln_post"),
                         ("text.ln_final", "ln_final")):
        sd[theirs + ".weight"] = n[ours + ".scale"]
        sd[theirs + ".bias"] = n[ours + ".bias"]
    leaves = {"ln_1.scale": "ln_1.weight", "ln_1.bias": "ln_1.bias",
              "ln_2.scale": "ln_2.weight", "ln_2.bias": "ln_2.bias",
              "attn.wqkv": "attn.in_proj_weight",
              "attn.bqkv": "attn.in_proj_bias",
              "attn.wo": "attn.out_proj.weight",
              "attn.bo": "attn.out_proj.bias",
              "mlp.w_fc": "mlp.c_fc.weight", "mlp.b_fc": "mlp.c_fc.bias",
              "mlp.w_proj": "mlp.c_proj.weight",
              "mlp.b_proj": "mlp.c_proj.bias"}
    for ours, theirs, layers in (
            ("visual.blocks", "visual.transformer.resblocks",
             cfg["vision_layers"]),
            ("text.blocks", "transformer.resblocks",
             cfg["transformer_layers"])):
        for i in range(layers):
            for leaf, name in leaves.items():
                v = n[f"{ours}.{i}.{leaf}"]
                sd[f"{theirs}.{i}.{name}"] = v.T if v.ndim == 2 else v
    return sd


def test_loader_reads_openclip_mlp_widths_and_stated_heads(tiny):
    ccfg, model, ws = tiny
    sd = _openclip_state_dict(TINY, ws)
    cfg = TW.config_from_torch_state_dict(sd, vision_heads=2,
                                          activation="gelu")
    assert cfg == ccfg
    # without them: OpenAI's head width (208 / 64 = 3) and QuickGELU, the
    # MLP widths still the checkpoint's
    plain = TW.config_from_torch_state_dict(sd)
    assert (plain.vision_heads, plain.activation, plain.vision_mlp_width,
            plain.transformer_mlp_width) == (3, "quick_gelu", 1024, 512)
    loaded, _ = TW.convert_torch_clip(sd, "float32", cfg=cfg, device="cpu")
    got = dict(loaded.named_parameters())
    for name, p in model.named_parameters():
        assert torch.equal(got[name], p), name


# -- the kernels' dispatch at head dim 104 -----------------------------------

def test_head_dim_104_is_k1_bf16_alone():
    dims = mq.KERNEL_HEAD_DIMS
    assert 104 in dims[("K1", torch.bfloat16)]
    for key in (("K1", torch.float32), ("K2", torch.bfloat16),
                ("K2", torch.float32)):
        assert 104 not in dims[key], key
    # every other kernel and dtype keeps OpenAI's and ViT-Test's dims
    for key, allowed in dims.items():
        assert {16, 32, 64} <= set(allowed), key


@pytest.mark.parametrize("kernel,dtype,head_dim", [
    ("K1", torch.float32, 104), ("K2", torch.bfloat16, 104),
    ("K2", torch.float32, 104), ("K1", torch.bfloat16, 80)])
def test_refused_head_dim_is_named(kernel, dtype, head_dim):
    with pytest.raises(ValueError) as err:
        mq._check_head_dim(kernel, dtype, head_dim)
    said = str(err.value)
    for word in (str(head_dim), kernel, str(dtype)[6:]):
        assert word in said, (word, said)


def test_plain_versions_match_sdpa_at_head_dim_104():
    B, L, H, d = 2, 20, 2, 104
    gen = torch.Generator().manual_seed(SEED)
    qkv = torch.randn((B, L, 3 * H * d), generator=gen)
    mask = torch.zeros((L, L), dtype=torch.float32)
    mask[:, 17:] = torch.finfo(torch.float32).min
    q, k, v = (t.detach().requires_grad_() for t in
               qkv.view(B, L, 3, H, d).permute(2, 0, 3, 1, 4))
    want = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    got = mq.mha_qkv_reference(qkv, mask, H)
    # fp32 sums on both sides, in other orders
    torch.testing.assert_close(got, want.transpose(1, 2).reshape(B, L, -1),
                               rtol=1e-5, atol=1e-5)
    g = torch.randn((B, L, H * d), generator=gen)
    grads = torch.autograd.grad(
        want, (q, k, v), g.view(B, L, H, d).transpose(1, 2))
    dqkv = mq.mha_qkv_bwd_reference(qkv, mask, g, H)
    torch.testing.assert_close(
        dqkv, torch.cat([t.transpose(1, 2).reshape(B, L, -1)
                         for t in grads], dim=-1), rtol=1e-5, atol=1e-5)
    assert np.isfinite(dqkv.numpy()).all()
