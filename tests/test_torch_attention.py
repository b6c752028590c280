"""The port's fused attention (K1) against the JAX package's Pallas kernel.

Both sides get the same numpy inputs; the JAX kernel runs in interpret
mode as its own tests run it, the port's wrapper runs its plain version
(CPU tensors). The CUDA kernel itself is held to the plain version on the
card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_calibration_tpu.ops import attention as A
from clip_calibration_tpu.ops import pallas_attention as PA
from clip_calibration_tpu_torch.ops import attention as TA
from clip_calibration_tpu_torch.ops.mha_qkv import (mha_qkv,
                                                    mha_qkv_reference)

NEG = float(np.finfo(np.float32).min)


def _mask(L, kind):
    if kind == "causal":
        return np.triu(np.full((L, L), NEG, np.float32), k=1)
    m = np.zeros((L, L), np.float32)
    if kind == "pad":
        # padded keys masked, padded rows pinned to key 0 (the towers'
        # pad-once contract)
        m[:, 50:] = NEG
        m[50:, :] = NEG
        m[50:, 0] = 0.0
    return m


def _qkv(seed, B, L, D):
    return (np.random.default_rng(seed).standard_normal((B, L, 3 * D))
            * 0.3).astype(np.float32)


def _jax_kernel(qkv, mask, H, dtype=jnp.float32):
    return np.asarray(PA.pallas_mha_qkv(jnp.asarray(qkv, dtype),
                                        jnp.asarray(mask), H, True)
                      .astype(jnp.float32))


@pytest.mark.parametrize("L,kind", [(80, "causal"), (208, "none"),
                                    (64, "pad")])
def test_plain_k1_matches_jax_kernel(L, kind):
    B, H, D = 2, 4, 64
    qkv, mask = _qkv(0, B, L, D), _mask(L, kind)
    got = mha_qkv(torch.from_numpy(qkv), torch.from_numpy(mask), H)
    np.testing.assert_allclose(got.numpy(), _jax_kernel(qkv, mask, H),
                               rtol=2e-5, atol=2e-5)


def test_plain_k1_bf16_matches_jax_kernel():
    """bf16 in and out. Both sides scale q in bf16, keep scores and
    softmax in fp32 and round P to bf16; they sum P.V in different orders
    before the final bf16 rounding, so they may differ by one bf16 ulp
    (2^-8 relative): rtol=atol=1e-2."""
    B, H, D, L = 2, 4, 64, 80
    qkv, mask = _qkv(1, B, L, D), _mask(L, "causal")
    got = mha_qkv(torch.from_numpy(qkv).to(torch.bfloat16),
                  torch.from_numpy(mask), H)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               _jax_kernel(qkv, mask, H, jnp.bfloat16),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("L", [13, 77])
def test_plain_k1_ragged_length(L):
    """L off the multiple of 16: the CUDA kernel masks its ragged edge
    itself; the plain version must agree with the JAX kernel there."""
    B, H, D = 3, 4, 64
    qkv, mask = _qkv(2, B, L, D), _mask(L, "causal")
    got = mha_qkv(torch.from_numpy(qkv), torch.from_numpy(mask), H)
    np.testing.assert_allclose(got.numpy(), _jax_kernel(qkv, mask, H),
                               rtol=2e-5, atol=2e-5)


def test_unpacked_matches_jax_packed_path():
    """The JAX wrapper packs 16 short text rows into one [16*L] sequence
    with a block-diagonal mask (ops/attention.py::_pack_rows); the port
    runs them unpacked with the shared [L, L] mask. Same math."""
    B, D, H, L = 16, 64, 4, 16
    assert A._pack_rows(B, L) == 16
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((B, L, D)) * 0.2).astype(np.float32)
    wqkv = (rng.standard_normal((D, 3 * D)) * 0.05).astype(np.float32)
    bqkv = (rng.standard_normal(3 * D) * 0.01).astype(np.float32)
    wo = (rng.standard_normal((D, D)) * 0.05).astype(np.float32)
    bo = (rng.standard_normal(D) * 0.01).astype(np.float32)
    mask = _mask(L, "causal")

    orig = PA.pallas_mha_qkv
    calls = []

    def interp(qkv, m, n_heads, interpret=True):
        calls.append(qkv.shape)
        return orig(qkv, m, n_heads, True)

    PA.pallas_mha_qkv = interp
    impl = A._ATTENTION_IMPL
    try:
        A.set_attention_impl("pallas")
        want = A.multi_head_attention(
            *(jnp.asarray(a) for a in (x, wqkv, bqkv, wo, bo)), H,
            jnp.asarray(mask))
    finally:
        PA.pallas_mha_qkv = orig
        A.set_attention_impl(impl)
    assert calls == [(1, B * L, 3 * D)]  # one packed row

    got = TA.multi_head_attention(
        *(torch.from_numpy(a) for a in (x, wqkv, bqkv, wo, bo)), H,
        torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_cpu_dispatch_does_not_count_launches():
    mha_qkv.launches = 0
    qkv = torch.from_numpy(_qkv(4, 1, 16, 64))
    mha_qkv(qkv, torch.from_numpy(_mask(16, "none")), 4)
    assert mha_qkv.launches == 0


def test_reference_is_the_cpu_path():
    qkv = torch.from_numpy(_qkv(5, 2, 32, 64))
    mask = torch.from_numpy(_mask(32, "causal"))
    assert torch.equal(mha_qkv(qkv, mask, 4),
                       mha_qkv_reference(qkv, mask, 4))


@pytest.mark.parametrize("case", ["dtype", "mask_shape", "mask_dtype",
                                  "noncontiguous", "grad", "heads"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    qkv = torch.from_numpy(_qkv(6, 2, 16, 64))
    mask = torch.from_numpy(_mask(16, "none"))
    heads = 4
    err = ValueError
    if case == "dtype":
        qkv, err = qkv.half(), TypeError
    elif case == "mask_shape":
        mask = mask[:8]
    elif case == "mask_dtype":
        mask = mask.double()
    elif case == "noncontiguous":
        qkv = qkv.transpose(0, 1)
    elif case == "grad":
        # qkv may require grad (K2 gives its gradient); the mask gets none
        mask = mask.requires_grad_()
    else:
        heads = 5
    with pytest.raises(err):
        mha_qkv(qkv, mask, heads)


def test_jax_reference_mask_helper_matches():
    np.testing.assert_array_equal(
        TA.causal_mask(9).numpy(), np.asarray(A.causal_mask(9)))


def test_layer_norm_and_quick_gelu_match_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    s = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    np.testing.assert_allclose(
        TA.layer_norm(*(torch.from_numpy(a) for a in (x, s, b))).numpy(),
        np.asarray(A.layer_norm(*(jnp.asarray(a) for a in (x, s, b)))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        TA.quick_gelu(torch.from_numpy(x)).numpy(),
        np.asarray(A.quick_gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    assert jax.default_backend() == "cpu"


# fp32 edge cases the CUDA kernels must keep (their plain versions stand
# for them here): (L, head dim, mask). "fullrow": the towers' pad mask
# (keys from 50 masked, padded rows pinned to key 0) with the last row
# and the keys 16..31 also set to finfo(float32).min, so one row is masked
# everywhere and one 16-key block for every row.
FP32_EDGES = [(37, 64, "causal"), (64, 64, "fullrow"), (48, 16, "pad"),
              (40, 32, "causal"), (77, 16, "fullrow")]


def _edge_mask(L, kind):
    if kind != "fullrow":
        m = _mask(L, kind)
        if kind == "pad" and L <= 50:
            m = np.zeros((L, L), np.float32)
            m[:, L - 5:] = NEG
            m[L - 5:, :] = NEG
            m[L - 5:, 0] = 0.0
        return m
    m = _mask(L, "pad")
    m[L - 1, :] = NEG
    m[:, 16:32] = NEG
    return m


@pytest.mark.parametrize("L,d,kind", FP32_EDGES,
                         ids=[f"{L}-d{d}-{k}" for L, d, k in FP32_EDGES])
def test_fp32_edges_match_jax_kernel(L, d, kind):
    """fp32 forward at a ragged L (not a multiple of 16), a fully masked
    row and key block, and head dims 16 and 32: the port (plain version on
    CPU tensors) against the interpret-mode Pallas kernel."""
    B, H = 2, 4
    qkv, mask = _qkv(8, B, L, H * d), _edge_mask(L, kind)
    got = mha_qkv(torch.from_numpy(qkv), torch.from_numpy(mask), H)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), _jax_kernel(qkv, mask, H),
                               rtol=2e-5, atol=2e-5)
