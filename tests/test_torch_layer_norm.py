"""The towers' LayerNorm (``ops/layer_norm.py``) on CPU tensors: its plain
versions, which the CUDA kernels are held to on the card
(``chip_smoke.py``). The forward is the decomposition the towers ran
before the kernels, bit for bit; the backward is the closed form the
backward kernel computes, held to autograd through that decomposition."""

import re

import pytest
import torch

from clip_calibration_tpu_torch.ops import attention, build
from clip_calibration_tpu_torch.ops import layer_norm as LN
from clip_calibration_tpu_torch.tools import profiling

WIDTHS = [64, 1664]
DTYPES = [torch.float32, torch.float64]
# closed form against autograd through the decomposition: the same
# function summed in another order
BWD_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def decomposition(x, scale, bias, eps=1e-5):
    """The towers' LayerNorm before the kernels, op for op (x.float() was
    its compute dtype; fp64 inputs now compute in fp64)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.to(xf.dtype) + bias.to(xf.dtype)).to(x.dtype)


def _inputs(width, dtype, seed=0, shape=(3, 5)):
    g = torch.Generator().manual_seed(seed)
    x = (3 * torch.randn(*shape, width, generator=g, dtype=torch.float64)
         + torch.randn(*shape, 1, generator=g, dtype=torch.float64))
    scale = 1 + 0.1 * torch.randn(width, generator=g, dtype=torch.float64)
    bias = 0.1 * torch.randn(width, generator=g, dtype=torch.float64)
    dy = torch.randn(*shape, width, generator=g, dtype=torch.float64)
    return x.to(dtype), scale.float(), bias.float(), dy.to(dtype)


def _close(got, want, rtol):
    scale = want.abs().max()
    assert torch.allclose(got, want, rtol=rtol, atol=rtol * float(scale)), \
        float((got - want).abs().max() / scale)


@pytest.mark.parametrize("dtype", DTYPES + [torch.bfloat16])
@pytest.mark.parametrize("width", WIDTHS)
def test_forward_is_the_decomposition_bit_for_bit(width, dtype):
    x, scale, bias, _ = _inputs(width, dtype)
    y = attention.layer_norm(x, scale, bias)
    assert y.dtype == dtype
    assert torch.equal(y, decomposition(x, scale, bias))
    # a strided view (ln_post's x[:, 0]) gives the rows it holds
    assert torch.equal(attention.layer_norm(x[:, 0], scale, bias), y[:, 0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", WIDTHS)
def test_backward_closed_form_matches_autograd(width, dtype):
    x, scale, bias, dy = _inputs(width, dtype, seed=1)
    xg = x.clone().requires_grad_()
    LN.layer_norm(xg, scale, bias).backward(dy)
    xr = x.clone().requires_grad_()
    decomposition(xr, scale, bias).backward(dy)
    assert xg.grad.dtype == dtype
    _close(xg.grad, xr.grad, BWD_RTOL[dtype])
    # the plain backward itself, from the forward's statistics
    _, mean, rstd = LN.layer_norm_reference(x, scale, bias)
    _close(LN.layer_norm_bwd_reference(x, scale, mean, rstd, dy), xr.grad,
           BWD_RTOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", WIDTHS)
def test_scale_and_bias_gradients_where_they_require_one(width, dtype):
    x, scale, bias, dy = _inputs(width, dtype, seed=2)
    cd = torch.promote_types(dtype, torch.float32)

    def grads(fn, trained=(True, True)):
        xs = x.clone().requires_grad_()
        s, b = (t.to(cd, copy=True).requires_grad_(on)
                for t, on in zip((scale, bias), trained))
        fn(xs, s, b).backward(dy)
        return xs.grad, s.grad, b.grad

    for got, want in zip(grads(LN.layer_norm), grads(decomposition)):
        _close(got, want, BWD_RTOL[dtype])
    # the bias alone: no scale gradient
    dx, dscale, dbias = grads(LN.layer_norm, (False, True))
    assert dscale is None
    _close(dbias, grads(decomposition)[2], BWD_RTOL[dtype])


@pytest.mark.parametrize("case", ["dtype", "rank", "scale_rank", "width",
                                  "device", "scale_device"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_input_checks_raise_by_name(case, dtype):
    x, scale, bias, _ = _inputs(64, dtype)
    error = ValueError
    if case == "dtype":
        x, error, said = x.half(), TypeError, "float16"
    elif case == "rank":
        x, said = x[0, 0, 0], "[..., D]"
    elif case == "scale_rank":
        scale, said = scale.reshape(8, 8), "scale"
    elif case == "width":
        x, scale, bias = x[..., :36], scale[:36], bias[:36]
        said = "width 36 is not a multiple of 8"
    elif case == "device":
        x, scale, bias = (t.to("meta") for t in (x, scale, bias))
        said = "meta"
    else:
        scale, said = scale.to("meta"), "scale on meta"
    with pytest.raises(error, match=re.escape(said)):
        LN.layer_norm(x, scale, bias)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", WIDTHS)
def test_cpu_calls_count_no_launches(width, dtype):
    LN.layer_norm.launches = LN.layer_norm_bwd.launches = 0
    before = profiling.snapshot().get("ln.calls", {"count": 0})["count"]
    x, scale, bias, dy = _inputs(width, dtype)
    xg = x.clone().requires_grad_()
    LN.layer_norm(xg, scale, bias).backward(dy)
    assert xg.grad is not None
    assert LN.layer_norm.launches == LN.layer_norm_bwd.launches == 0
    assert profiling.snapshot().get("ln.calls",
                                    {"count": 0})["count"] == before


def test_rows_are_a_view_where_the_kernels_take_them():
    """The kernels take contiguous rows that start 16-byte aligned: a view
    where x is one, else a copy (ln_post's x[:, 0], a row off
    alignment)."""
    x = torch.randn(4, 7, 64)
    rows = LN._rows(x)
    assert rows.shape == (28, 64) and rows.data_ptr() == x.data_ptr()
    for view in (x[:, 0], x.transpose(0, 1)):
        rows = LN._rows(view)
        assert rows.is_contiguous() and rows.data_ptr() % 16 == 0
        assert torch.equal(rows, view.reshape(-1, view.shape[-1]))
    odd = x.view(-1)[1:65].view(1, 64)  # contiguous, 4 bytes off
    rows = LN._rows(odd)
    assert rows.data_ptr() % 16 == 0 and torch.equal(rows, odd)


def _reordered(x, scale, bias, g, eps=1e-5):
    """y and dx as the kernels sum: per 8-element vector, then across the
    vectors of a row (another fp32 order than the plain versions'),
    rounded once to x's dtype."""
    D = x.shape[-1]
    xf = x.float()

    def row_mean(t):
        return t.reshape(*t.shape[:-1], D // 8, 8).sum(-1).sum(
            -1, keepdim=True) / D

    mean = row_mean(xf)
    rstd = torch.rsqrt(row_mean((xf - mean) ** 2) + eps)
    xh = (xf - mean) * rstd
    gs = g.float() * scale
    dx = rstd * (gs - row_mean(gs) - xh * row_mean(gs * xh))
    return (xh * scale + bias).to(x.dtype), dx.to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("width", WIDTHS)
def test_chip_tolerance_takes_another_sum_order_not_a_dropped_term(width,
                                                                   dtype):
    """chip_smoke.py's LN_TOL holds the kernels to their plain versions:
    it takes the same function summed in another order and rounded once,
    and rejects a backward without its xh * mean(g' xh) term."""
    import chip_smoke
    dname = str(dtype)[6:]
    x, scale, bias, dy = _inputs(width, dtype, seed=3, shape=(64,))
    y, mean, rstd = LN.layer_norm_reference(x, scale, bias)
    dx = LN.layer_norm_bwd_reference(x, scale, mean, rstd, dy)
    got_y, got_dx = _reordered(x, scale, bias, dy)
    assert chip_smoke.ln_within(got_y, y, dname)[1]
    assert chip_smoke.ln_within(got_dx, dx, dname)[1]
    dropped = chip_smoke.ln_dropped_term(x, scale, mean, rstd, dy)
    assert not chip_smoke.ln_within(dropped, dx, dname)[1]


def test_chip_recorder_counts_launches_by_path_and_shape():
    """chip_smoke.py's LayerNorm stand-in counts what the launcher's own
    counter counts (a CPU call counts nothing), by path and [rows, width,
    dtype]."""
    import chip_smoke

    def launcher(x):
        launcher.launches += x.device.type == "meta"
        return x

    launcher.launches = 0
    rec = chip_smoke.LayerNormRecorder(launcher, launcher)
    rec.path = "main_path"
    rec(torch.empty(2, 3, 64, device="meta"))
    rec(torch.empty(2, 3, 64, device="meta"))
    rec(torch.empty(5, 64))
    rec.path = "train_path"
    rec(torch.empty(4, 512, dtype=torch.bfloat16, device="meta"))
    assert rec.calls == {"main_path": {(6, 64, "float32"): 2},
                         "train_path": {(4, 512, "bfloat16"): 1}}
    assert (rec.count(), rec.count("main_path"), rec.launches) == (3, 2, 3)


def test_kernel_instances_are_named_in_the_build_report():
    assert build.SOURCES["layer_norm"] == "layer_norm.cu"
    assert build._kernel_name(
        "_ZN12_GLOBAL__N_119layer_norm_fwd_bf16ILi32ELi7EEEvPK13__nv_"
        "bfloat16PKfS5_PS1_PfS7_iif") == "layer_norm_fwd_bf16<32, 7>"
    assert build._kernel_name(
        "_ZN12_GLOBAL__N_118layer_norm_bwd_f32ILi8ELi1EEEvPKfS2_S2_S2_S2_"
        "Pfii") == "layer_norm_bwd_f32<8, 1>"
