"""The configuration schema (``harness.py``'s docstring, ``schema.py``).

The two OpenAI configurations read the same weights as before the MLP
width and the activation became keys: ``weights.layout`` and
``weights.make`` are pinned to digests taken before the change. A tiny
OpenCLIP-shaped configuration (heads of 104, MLPs narrower than 4x, the
exact GELU) reaches the weights, the reference and the refusal of a port
that runs OpenAI's layout alone.
"""

from __future__ import annotations

import hashlib
import json
import math
import os.path as osp
from types import SimpleNamespace

import pytest
import torch

from portbench import harness, schema, weights
from portbench.drivers import common
from portbench.reference.clip_ref import ReferenceCLIP

HERE = osp.dirname(osp.abspath(__file__))
SEED = 2147483747

#: OpenCLIP's layout at a tiny size: vision 2 heads of 104 with an MLP of
#: 1024 (not 4 x 208), text 2 heads of 64 with 512, the exact GELU
TINY = {"name": "tiny-openclip", "model": "ViT-Test", "embed_dim": 32,
        "image_resolution": 32, "vision_layers": 2, "vision_width": 208,
        "vision_patch_size": 8, "vision_heads": 2, "vision_mlp_width": 1024,
        "transformer_width": 128, "transformer_heads": 2,
        "transformer_layers": 2, "transformer_mlp_width": 512,
        "context_length": 77, "vocab_size": 49408, "precision": "fp32",
        "activation": "gelu"}

#: the layouts and weights of the parent of the schema change: (tensors,
#: elements, sha256 of the layout's JSON, sha256 of ``make``'s bytes at
#: seed 2147483747 on the CPU)
PINNED = {
    "vit-b16": (302, 149620737,
                "26d70a203af2f14c9967d34f04b6c508a6e6c20efb4ae990d67f7f5908f70886",
                "5c9c5cba194e0a1490a56a6f908dec3c3010a388b0ded99d0ac6e61009788c05"),
    "vit-l14": (446, 427616513,
                "cda8df8bf8d62b9b34818975f10118e976aa0633ab486d116c0df612243da3f8",
                "b444d5ecef897b0dba8c810807815e0f296ef9de4e9025f1495326c1b9fb1333"),
}
#: the same at the rehearsal sizes, which both configurations share
PINNED_REHEARSAL = (
    "83e3b084df06187287eab6de71b7c64e03f527cd0391412356ad14661fb65e91",
    "e8892f4f36ebb1977188d75f216fd31162cd6e8a0513a3e7e8918f0fe7a6b1b9")


def _config(name):
    with open(osp.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


def _layout_digest(cfg) -> str:
    spec = [[name, list(shape), std] for name, shape, std
            in weights.layout(cfg)]
    return hashlib.sha256(json.dumps(spec).encode()).hexdigest()


def _weights_digest(ws) -> str:
    h = hashlib.sha256()
    for name, t in ws.items():
        t = t.contiguous()
        h.update(name.encode())
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.numpy().tobytes())
    return h.hexdigest()


# -- OpenAI's configurations read as before ----------------------------------

@pytest.mark.parametrize("name", sorted(PINNED))
def test_layout_pinned_at_full_size(name):
    cfg = _config(name)
    n, elements, layout_sha, _ = PINNED[name]
    spec = weights.layout(cfg)
    assert len(spec) == n
    assert sum(math.prod(shape) for _, shape, _ in spec) == elements
    assert _layout_digest(cfg) == layout_sha
    w = cfg["vision_width"]
    got = {name: (shape, std) for name, shape, std in spec}
    assert got["visual.blocks.0.mlp.w_fc"] == ((w, 4 * w), (2 * w) ** -0.5)
    assert got["visual.blocks.0.mlp.w_proj"][0] == (4 * w, w)


@pytest.mark.parametrize("name", sorted(PINNED))
def test_weights_pinned_at_full_size(name):
    ws = weights.make(_config(name), SEED, "cpu")
    assert _weights_digest(ws) == PINNED[name][3]


@pytest.mark.parametrize("name", sorted(PINNED))
def test_weights_pinned_at_rehearsal_size(name):
    cfg = harness.rehearsal_config(_config(name))
    assert cfg == {**_config(name), **harness.REHEARSAL_SIZES}
    assert _layout_digest(cfg) == PINNED_REHEARSAL[0]
    assert _weights_digest(weights.make(cfg, SEED, "cpu")) \
        == PINNED_REHEARSAL[1]


@pytest.mark.parametrize("name", sorted(PINNED))
def test_port_config_builds_what_the_fixed_keys_built(name):
    from clip_calibration_tpu_torch.models.clip import CLIPConfig
    cfg = _config(name)
    keys = ("embed_dim", "image_resolution", "vision_layers",
            "vision_width", "vision_patch_size", "transformer_width",
            "transformer_heads", "transformer_layers", "context_length",
            "vocab_size")
    want = CLIPConfig(**{k: cfg[k] for k in keys})
    assert common.port_config(cfg) == want
    # OpenAI's values stated outright read the same
    stated = {**cfg, "vision_mlp_width": 4 * cfg["vision_width"],
              "transformer_mlp_width": 4 * cfg["transformer_width"],
              "activation": "quick_gelu"}
    assert common.port_config(stated) == want


# -- the schema's keys -------------------------------------------------------

def test_schema_defaults():
    cfg = _config("vit-l14")
    assert schema.mlp_width(cfg, "vision") == 4096
    assert schema.mlp_width(cfg, "transformer") == 3072
    assert schema.head_width(cfg, "vision") == 64
    assert schema.activation(cfg) == "quick_gelu"
    assert schema.mlp_width(TINY, "vision") == 1024
    assert schema.mlp_width(TINY, "transformer") == 512
    assert schema.head_width(TINY, "vision") == 104
    assert schema.activation(TINY) == "gelu"


def test_schema_refuses_what_it_cannot_state():
    with pytest.raises(ValueError, match="activation"):
        schema.activation({**TINY, "activation": "relu"})
    with pytest.raises(ValueError, match="vision_heads"):
        schema.head_width({**TINY, "vision_heads": 3}, "vision")


def test_tiny_openclip_layout():
    got = {name: (shape, std) for name, shape, std in weights.layout(TINY)}
    for tower, w, mlp, layers in (("visual", 208, 1024, 2),
                                  ("text", 128, 512, 2)):
        for i in range(layers):
            p = f"{tower}.blocks.{i}."
            assert got[p + "attn.wqkv"][0] == (w, 3 * w)
            assert got[p + "mlp.w_fc"] == ((w, mlp), (2 * w) ** -0.5)
            assert got[p + "mlp.b_fc"][0] == (mlp,)
            assert got[p + "mlp.w_proj"] == ((mlp, w),
                                             w ** -0.5 * (2 * layers) ** -0.5)
    ws = weights.make(TINY, SEED, "cpu")
    assert ws["visual.blocks.1.mlp.w_proj"].shape == (1024, 208)
    assert ws["text.blocks.0.mlp.w_fc"].dtype == torch.float32


def test_rehearsal_keeps_the_stated_ratio_and_activation():
    # OpenCLIP ViT-bigG/14's towers: vision 1664 wide with an 8192 MLP,
    # text 1280 with 5120
    big = {**_config("vit-l14"), "vision_width": 1664, "vision_heads": 16,
           "vision_mlp_width": 8192, "transformer_width": 1280,
           "transformer_heads": 20, "transformer_mlp_width": 5120,
           "activation": "gelu"}
    r = harness.rehearsal_config(big)
    assert r["vision_width"] == 64 and r["transformer_width"] == 64
    assert r["vision_mlp_width"] == 312      # 64 x 8192 / 1664 = 315.1
    assert r["transformer_mlp_width"] == 256
    assert r["activation"] == "gelu"
    tiny = harness.rehearsal_config(TINY)
    assert tiny["vision_mlp_width"] == 8 * round(64 * 1024 / 208 / 8)
    assert tiny["transformer_mlp_width"] == 256


# -- the reference's block is OpenCLIP's ---------------------------------------

class _QuickGELU(torch.nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(1.702 * x)


def _open_clip_block(ws, p: str, width: int, heads: int, mlp: int,
                     activation: str) -> torch.nn.Module:
    """OpenCLIP's ``ResidualAttentionBlock`` from torch.nn's modules,
    holding the benchmark's weights of block ``p`` ([in, out] there,
    [out, in] here)."""
    ln_1, ln_2 = torch.nn.LayerNorm(width), torch.nn.LayerNorm(width)
    attn = torch.nn.MultiheadAttention(width, heads, batch_first=True)
    c_fc, c_proj = torch.nn.Linear(width, mlp), torch.nn.Linear(mlp, width)
    act = torch.nn.GELU() if activation == "gelu" else _QuickGELU()
    with torch.no_grad():
        for ln, name in ((ln_1, "ln_1"), (ln_2, "ln_2")):
            ln.weight.copy_(ws[p + name + ".scale"])
            ln.bias.copy_(ws[p + name + ".bias"])
        attn.in_proj_weight.copy_(ws[p + "attn.wqkv"].T)
        attn.in_proj_bias.copy_(ws[p + "attn.bqkv"])
        attn.out_proj.weight.copy_(ws[p + "attn.wo"].T)
        attn.out_proj.bias.copy_(ws[p + "attn.bo"])
        c_fc.weight.copy_(ws[p + "mlp.w_fc"].T)
        c_fc.bias.copy_(ws[p + "mlp.b_fc"])
        c_proj.weight.copy_(ws[p + "mlp.w_proj"].T)
        c_proj.bias.copy_(ws[p + "mlp.b_proj"])
    mlp_seq = torch.nn.Sequential(c_fc, act, c_proj)

    class Block(torch.nn.Module):
        def forward(self, x, mask=None):
            h = ln_1(x)
            x = x + attn(h, h, h, need_weights=False, attn_mask=mask)[0]
            return x + mlp_seq(ln_2(x))
    return Block()


@pytest.mark.parametrize("activation", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("tower", ["visual", "text"])
def test_reference_block_is_open_clips(tower, activation):
    cfg = {**TINY, "activation": activation}
    ws = weights.make(cfg, SEED, "cpu")
    ref = ReferenceCLIP(cfg, ws)
    key = "vision" if tower == "visual" else "transformer"
    width, heads = cfg[f"{key}_width"], cfg[f"{key}_heads"]
    L = 17 if tower == "visual" else 12
    mask = None if tower == "visual" else torch.triu(
        torch.full((L, L), float("-inf")), diagonal=1)
    x = torch.randn((3, L, width),
                    generator=torch.Generator().manual_seed(SEED))
    p = f"{tower}.blocks.1."
    with torch.no_grad():
        got = ref._block(x, p, heads, mask)
        want = _open_clip_block(ws, p, width, heads,
                                cfg[f"{key}_mlp_width"], activation)(x, mask)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_reference_towers_run_the_tiny_openclip():
    ws = weights.make(TINY, SEED, "cpu")
    ref = ReferenceCLIP(TINY, ws)
    gen = torch.Generator().manual_seed(SEED)
    images = torch.randint(0, 256, (2, 32, 32, 3), generator=gen,
                           dtype=torch.uint8)
    assert ref.image_features(images).shape == (2, 32)
    tokens = torch.zeros((2, 77), dtype=torch.long)
    tokens[:, 0], tokens[:, 1:4] = 49406, 320
    tokens[:, 4] = 49407
    txt = ref.text_features(tokens)
    assert txt.shape == (2, 32) and torch.isfinite(txt).all()
    # the activation is read: QuickGELU gives other features
    quick = ReferenceCLIP({**TINY, "activation": "quick_gelu"}, ws)
    assert not torch.allclose(quick.text_features(tokens), txt)


# -- a port that cannot run the configuration refuses it by name ---------------

def _no_weights(*args, **kwargs):
    raise AssertionError("weights were made before the refusal")


@pytest.mark.parametrize("change,keys", [
    ({}, ("vision_heads", "vision_mlp_width", "activation")),
    ({"vision_width": 64, "vision_heads": 1, "activation": "quick_gelu"},
     ("vision_mlp_width",)),
    ({"vision_width": 64, "vision_heads": 1, "vision_mlp_width": 256,
      "activation": "quick_gelu", "transformer_mlp_width": 320},
     ("transformer_mlp_width",)),
    ({"vision_width": 64, "vision_heads": 1, "vision_mlp_width": 256},
     ("activation",)),
])
def test_port_model_refuses_by_name_before_weights(change, keys,
                                                   monkeypatch):
    monkeypatch.setattr(weights, "make", _no_weights)
    run = SimpleNamespace(config={**TINY, **change}, seed=SEED,
                          device=torch.device("cpu"))
    with pytest.raises(ValueError) as err:
        common.port_model(run)
    said = str(err.value)
    for key in ("vision_heads", "vision_mlp_width", "transformer_mlp_width",
                "activation"):
        assert (key + ":" in said) == (key in keys), (key, said)
