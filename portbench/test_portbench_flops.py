"""``flops.py`` and ``bounds.py`` against hand counts.

The kernel cases are the main shapes of ``PERF.md``'s kernel table, whose
bound column (``chip_smoke.py``'s arithmetic) they reproduce: K1 bf16 at
the ViT-B/16 vision shape, K2 bf16 at CoOp's 50-class text shape, K3 at
the vision w_fc product of the 32-row bucket.
"""

from __future__ import annotations

import json
import os.path as osp

import pytest

from portbench import bounds, flops

HERE = osp.dirname(osp.abspath(__file__))


def test_k1_vision_bf16():
    # qkv [32, 208, 2304] bf16, 12 heads of 64, fp32 mask [208, 208]
    c = flops.k1(32, 208, 2304, 12, "bfloat16")
    assert c["bytes"] == 32 * 208 * 2304 * 2 + 208 * 208 * 4 \
        + 32 * 208 * 768 * 2 == 41_067_520
    assert c["ops"] == 4 * 32 * 12 * 208 * 208 * 64 == 4_253_024_256
    ms = 1e3 * bounds.bound_seconds(c["ops"], c["bytes"], "bfloat16")
    assert ms == pytest.approx(0.0123, abs=5e-5)  # PERF.md: 0.0123 (bytes)


def test_k2_text_bf16():
    # qkv [50, 16, 1536] bf16, 8 heads of 64: read qkv and g, write dqkv
    c = flops.k2(50, 16, 1536, 8, "bfloat16")
    assert c["bytes"] == 2 * 50 * 16 * 1536 * 2 + 50 * 16 * 512 * 2 \
        + 16 * 16 * 4 == 5_735_424
    assert c["ops"] == 10 * 50 * 8 * 16 * 16 * 64 == 65_536_000
    ms = 1e3 * bounds.bound_seconds(c["ops"], c["bytes"], "bfloat16")
    assert ms == pytest.approx(0.00171, abs=5e-6)  # PERF.md: 0.00171


def test_k3_vision_w_fc():
    # [6656, 768] @ [768, 3072] int8 -> int32
    c = flops.k3(6656, 768, 3072, rescaled=False)
    assert c["bytes"] == 6656 * 768 + 768 * 3072 + 4 * 6656 * 3072 \
        == 89_260_032
    assert c["ops"] == 2 * 6656 * 3072 * 768
    ms = 1e3 * bounds.bound_seconds(c["ops"], c["bytes"], "int8")
    assert ms == pytest.approx(0.0266, abs=5e-5)  # PERF.md: 0.0266 (bytes)
    r = flops.k3(6656, 768, 3072, rescaled=True)
    assert r["bytes"] == 6656 * 768 + 768 * 3072 + 2 * 6656 * 3072 \
        + 4 * (6656 + 3072)


def _config(name):
    return json.load(open(osp.join(HERE, "configs", name + ".json")))


def test_vision_forward_counts():
    # ViT-B/16: 196 patches + class token; per block 2 L w (12 w)
    b = flops.vision_forward(_config("vit-b16"))
    L, w = 197, 768
    assert b["products"] == 2 * 196 * 768 * 768 + 12 * 24 * L * w * w \
        + 2 * 768 * 512
    assert b["attention"] == 12 * 4 * L * L * w
    assert sum(b.values()) == pytest.approx(35.1e9, rel=0.01)
    l14 = flops.vision_forward(_config("vit-l14"))
    assert sum(l14.values()) == pytest.approx(162e9, rel=0.01)


def test_text_counts():
    cfg = _config("vit-b16")
    f = flops.text_forward(cfg, 23)
    assert f["products"] == 12 * 24 * 23 * 512 * 512 + 2 * 512 * 512
    g = flops.text_input_grad(cfg, 23)
    assert g["products"] == f["products"]
    assert g["attention"] == pytest.approx(2.5 * f["attention"])


def test_peaks():
    assert bounds.PEAK_BYTES_PER_S == 3.35e12
    assert bounds.PEAK_OPS_PER_S == {"bfloat16": 989e12,
                                     "float32": 67e12, "int8": 1979e12}


def _padded(mask, Lp):
    """``mask`` [L, L] padded to [Lp, Lp] as the port pads the token axis:
    padded keys masked out, padded queries attending to token 0."""
    import torch
    L = mask.shape[0]
    neg = torch.finfo(torch.float32).min
    full = torch.zeros((Lp, Lp), dtype=torch.float32)
    full[:L, :L] = mask
    full[:, L:] = neg
    full[L:, :] = neg
    full[L:, 0] = 0.0
    return full


@pytest.mark.parametrize("kind,L,Lp", [("vision", 257, 272),
                                       ("text", 23, 32),
                                       ("unpadded", 32, 32)])
def test_attention_launches_counted_at_the_real_length(kind, L, Lp):
    import torch

    from clip_calibration_tpu_torch.ops.attention import causal_mask
    from portbench import readers
    from portbench.tracing import Slice
    mask = torch.zeros((L, L)) if kind == "vision" else causal_mask(L)
    s = Slice()
    m = _padded(mask, Lp)
    s._masks[id(m)] = m
    s.calls["k1"].append((100, Lp, 3072, 16, "bfloat16", id(m)))
    calls = s.real_calls()
    assert calls["k1"] == [(100, L, 3072, 16, "bfloat16")]
    want = readers._launch_bound("k1", (100, L, 3072, 16, "bfloat16"))
    c = flops.k1(100, L, 3072, 16, "bfloat16")
    assert want == bounds.bound_seconds(c["ops"], c["bytes"], "bfloat16")


#: ``flops.py``'s counts before the MLP width became a key of the
#: configuration: (products, attention) operations
PINNED = {
    ("vit-b16", "vision"): (33696251904.0, 1430654976.0),
    ("vit-b16", "text", 19): (1434976256.0, 8871936.0),
    ("vit-b16", "text", 23): (1736966144.0, 13000704.0),
    ("vit-b16", "text", 77): (5813829632.0, 145711104.0),
    ("vit-b16", "grad", 19): (1434976256.0, 22179840.0),
    ("vit-b16", "grad", 23): (1736966144.0, 32501760.0),
    ("vit-b16", "grad", 77): (5813829632.0, 364277760.0),
    ("vit-l14", "vision"): (155532656640.0, 6492880896.0),
    ("vit-l14", "text", 19): (3228696576.0, 13307904.0),
    ("vit-l14", "text", 23): (3908173824.0, 19501056.0),
    ("vit-l14", "text", 77): (13081116672.0, 218566656.0),
    ("vit-l14", "grad", 19): (3228696576.0, 33269760.0),
    ("vit-l14", "grad", 23): (3908173824.0, 48752640.0),
    ("vit-l14", "grad", 77): (13081116672.0, 546416640.0),
}


@pytest.mark.parametrize("case", sorted(PINNED), ids=str)
def test_model_work_pinned(case):
    cfg, kind = _config(case[0]), case[1]
    got = (flops.vision_forward(cfg) if kind == "vision" else
           flops.text_forward(cfg, case[2]) if kind == "text" else
           flops.text_input_grad(cfg, case[2]))
    assert (got["products"], got["attention"]) == PINNED[case]


def test_model_work_at_an_openclip_layout():
    # vision 208 wide as 2 heads of 104, MLP 1024; text 128 as 2 heads of
    # 64, MLP 512; 2 layers each; patch 8 at 32 px: 16 patches + class
    cfg = {"embed_dim": 32, "image_resolution": 32, "vision_layers": 2,
           "vision_width": 208, "vision_patch_size": 8, "vision_heads": 2,
           "vision_mlp_width": 1024, "transformer_width": 128,
           "transformer_heads": 2, "transformer_layers": 2,
           "transformer_mlp_width": 512, "activation": "gelu"}
    L = 17
    v = flops.vision_forward(cfg)
    block = 2 * L * (208 * 3 * 208 + 208 * 208 + 208 * 1024 + 1024 * 208)
    assert v["products"] == 2 * 16 * (8 * 8 * 3) * 208 + 2 * block \
        + 2 * 208 * 32
    assert v["attention"] == 2 * 4 * 2 * L * L * 104
    t = flops.text_forward(cfg, 10)
    block = 2 * 10 * (128 * 3 * 128 + 128 * 128 + 128 * 512 + 512 * 128)
    assert t["products"] == 2 * block + 2 * 128 * 32
    assert t["attention"] == 2 * 4 * 2 * 10 * 10 * 64
    g = flops.text_input_grad(cfg, 10)
    assert g == {"products": t["products"],
                 "attention": 2 * 10 * 2 * 10 * 10 * 64}
    # the vision MLP at its own width, not 4 x 208
    openai = flops.vision_forward({**cfg, "vision_mlp_width": 4 * 208})
    assert v["products"] - openai["products"] == \
        2 * 2 * L * 208 * 2 * (1024 - 832)
