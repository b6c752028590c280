"""K4 (int8 attention, three variants): the port's plain version against
the TPU kernel ``benchmarks/probe_int8_attention.py::_kernel`` run by
``_attn(..., interpret=True)`` on the CPU, on the same numpy inputs; and
the probe's CLI on the CPU.

Tolerances, output against output (both bf16):
- ``fp32_scores`` and ``int8_qk``: 2 bf16 ulps of the output's largest
  magnitude. The two sum the scores, the softmax and P v in other orders
  and with other ``exp``s, so a P value may round to the neighbouring bf16
  and the output's own bf16 rounding may land on the other side.
- ``int8_qk_pv``: 2 ``sv`` of the output's column (``sv`` = the column's
  max |v| / 127): a p that lands on the other side of a rounding boundary
  of ``round(p * 127)`` moves its ``pi`` by 1, and with it the output by
  at most ``vi * sv / 127 <= sv``.

The port follows the kernel's source: q scaled and rounded in bf16, every
``/`` a division. XLA's CPU compiler, which runs the interpret mode, keeps
``q * scale`` unrounded inside its fusion (excess precision) and divides by
the constant 127 as a multiply by its reciprocal, so a row scale may differ
in its last bit; both effects stay inside the tolerances above (eagerly,
``_quant_rows`` and ``quantize_rows`` agree bit for bit).
"""

import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clip_calibration_tpu_torch.ops import int8_attention as K4

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, osp.join(REPO, "benchmarks"))
import probe_int8_attention as probe  # noqa: E402

NEG = np.finfo(np.float32).min


def _mask(L, real, causal):
    m = np.zeros((L, L), np.float32)
    if causal:
        m[np.triu_indices(L, 1)] = NEG
    m[:, real:] = NEG
    return m


def _inputs(B, L, D, seed):
    qkv = np.random.default_rng(seed).standard_normal((B, L, 3 * D)) * 0.5
    return torch.from_numpy(qkv.astype(np.float32)).bfloat16()


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(x)) - 7)


# (B, L, D, H, real length, causal)
SHAPES = {
    "pad_mask": (2, 40, 256, 4, 33, False),
    "causal_77": (2, 77, 256, 4, 77, True),
    "head_dim_32": (2, 48, 128, 4, 41, False),
    "full_width": (2, 208, 768, 12, 197, False),
}


def _both(shape, variant, seed=0):
    B, L, D, H, real, causal = shape
    qkv = _inputs(B, L, D, seed)
    mask = _mask(L, real, causal)
    want = probe._attn(jnp.asarray(qkv.float().numpy(), jnp.bfloat16),
                       jnp.asarray(mask), H, variant, interpret=True)
    got = K4.int8_attention(qkv, torch.from_numpy(mask), H, variant)
    return qkv, np.asarray(want, np.float32), got.float().numpy()


@pytest.mark.parametrize("variant", K4.VARIANTS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_int8_attention_matches_jax_kernel(shape, variant):
    qkv, want, got = _both(SHAPES[shape], variant)
    assert got.shape == want.shape and np.isfinite(got).all()
    diff = np.abs(got - want)
    if variant == "int8_qk_pv":
        B, L, D, H, _, _ = SHAPES[shape]
        v = qkv.float().numpy()[..., 2 * D:]
        sv = np.abs(v).max(axis=1, keepdims=True) / 127.0  # [B, 1, D]
        assert (diff <= 2 * sv).all(), float((diff / sv).max())
    else:
        assert diff.max() <= 2 * _bf16_ulp(np.abs(want).max()), diff.max()


def test_variants_differ_as_the_probe_measures():
    """The int8 variants move the output away from fp32_scores, and
    int8_qk_pv moves it further (the probe's max/mean diff columns)."""
    shape = SHAPES["full_width"]
    outs = {v: _both(shape, v)[2] for v in K4.VARIANTS}
    d_qk = np.abs(outs["int8_qk"] - outs["fp32_scores"]).mean()
    d_pv = np.abs(outs["int8_qk_pv"] - outs["fp32_scores"]).mean()
    assert 0 < d_qk < d_pv


@pytest.mark.parametrize("d", [32, 64])
def test_quantize_rows_bit_equal_to_jax(d):
    x = np.random.default_rng(d).standard_normal((3, 50, d)).astype(
        np.float32) * 0.7
    x[0, 0] = 0.0  # an all-zero row: the eps keeps the scale finite
    x[1, 1, :4] = [0.5, -0.5, 1.5, 2.5]  # halves round to even
    got_q, got_s = K4.quantize_rows(torch.from_numpy(x))
    for b in range(3):
        want_q, want_s = probe._quant_rows(jnp.asarray(x[b]))
        np.testing.assert_array_equal(got_q[b].numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(got_s[b].numpy(), np.asarray(want_s))


def test_int8_attention_rejects_bad_input():
    qkv = _inputs(1, 8, 64, 0)
    mask = torch.zeros((8, 8))
    with pytest.raises(ValueError, match="variant"):
        K4.int8_attention(qkv, mask, 4, "int4")
    with pytest.raises(ValueError, match="mask"):
        K4.int8_attention(qkv, torch.zeros((8, 7)), 4, "int8_qk")
    with pytest.raises(ValueError, match="n_heads"):
        K4.int8_attention(qkv, mask, 5, "int8_qk")
    with pytest.raises(ValueError, match="cuda or cpu"):
        K4.int8_attention(qkv.to("meta"), mask.to("meta"), 4, "int8_qk")
    assert K4.int8_attention.launches == 0  # the CPU runs the plain version


def test_probe_cli_on_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "clip_calibration_tpu_torch.probe_int8_attention",
         "2", "40", "128", "2", "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rows = [json.loads(ln) for ln in r.stdout.splitlines()
            if ln.startswith("{")]
    assert [row["variant"] for row in rows] == list(K4.VARIANTS)
    for row in rows:
        assert row["shape"] == [2, 40, 128, 2] and row["device"] == "cpu"
        assert row["ms_per_call"] > 0 and row["tera_ops_per_s"] > 0
    assert "max_abs_diff_vs_fp32" not in rows[0]
    for row in rows[1:]:
        assert 0 < row["mean_abs_diff_vs_fp32"] <= row["max_abs_diff_vs_fp32"]
