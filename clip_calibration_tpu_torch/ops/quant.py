"""int8 quantization of the CLIP towers for serving and frozen-tower runs.

Counterpart of ``clip_calibration_tpu/ops/quant.py``, same arithmetic in
the same order, so on equal inputs ``quantize_int8``,
``quantize_activations_int8`` and ``qdot``'s int8 modes give the JAX
package's bits at fp32:

- a quantized weight is a ``QuantizedWeight`` module with buffers
  ``int8`` (shaped like the weight, [in, out]), ``scale`` (fp32, the
  contraction axis kept as 1: [1, out]) and optionally ``act_scale`` (a
  0-d fp32 static activation scale), and the non-persistent buffer
  ``kmajor``, ``int8`` transposed ([out, in], contiguous): the layout
  kernel K3 reads, made once; it follows ``.to(device)`` but is in no
  state dict, flat-params dict or file. ``quantize_clip_params`` puts these
  holders in place of the matmul ``Parameter``s on a copy of the tower;
  every other tensor (LayerNorms, embeddings, biases, the text tower, the
  logit scale) is shared with the original model, not copied.
- symmetric per-output-channel weight scales (``amax / 127``, all-zero
  columns get scale 1), round half to even (``torch.round``, like
  ``jnp.round``), division by the scale (not multiplication by its
  reciprocal), clip to +-127.
- ``qdot`` modes: ``dequant`` (weight-only: the dequantized weight in x's
  dtype through a plain ``torch.matmul``, as the JAX package leaves it to
  XLA); ``w8a8`` (static ``act_scale`` when attached, else dynamic per-row
  activation scales), ``w8a8_dynamic`` (per-row, ignoring any
  ``act_scale``) and ``w8a8_kernel`` (the JAX package's kernel-backed
  per-row path, which ``ops/int8_matmul.py::w8a8_matmul`` twins). All
  three int8 modes pick the activation scale once (static, per row, or
  per row through ``row_amax``), then run their int8 x int8 -> int32
  product and the fp32 rescale ``acc * x_scale * w_scale`` through
  ``ops/int8_matmul.py::rescaled_int8_matmul`` (on the card one launch of
  kernel K3, the rescale in its epilogue, the weight's ``kmajor`` copy
  passed).

The text tower's static scales (``calibrate_text_act_scales``,
``attach_text_act_scales``) serve the eval-time text fan-out of CoCoOp and
ProDA (``TRAINER.QUANT_EVAL_TEXT``). Only ViT image towers quantize: a
ModifiedResNet tower raises, as in the JAX package.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from .int8_matmul import rescaled_int8_matmul


class QuantizedWeight(nn.Module):
    """int8 weight, its fp32 per-output-channel scale and an optional
    static activation scale, as buffers (they follow ``.to(device)``), and
    the weight's K-major copy ``kmajor`` (non-persistent; made from ``q``
    unless given, and remade when a state dict is loaded)."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor,
                 act_scale: Optional[torch.Tensor] = None,
                 kmajor: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("int8", q)
        self.register_buffer("scale", scale)
        self.register_buffer("act_scale", act_scale)
        if kmajor is None:
            kmajor = q.transpose(-1, -2).contiguous()
        self.register_buffer("kmajor", kmajor, persistent=False)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)
        # kmajor is in no state dict: remake it from the int8 just loaded
        self.kmajor = self.int8.transpose(-1, -2).contiguous()

    @property
    def shape(self):
        return self.int8.shape

    def extra_repr(self) -> str:
        return (f"{tuple(self.int8.shape)}, static act scale: "
                f"{self.act_scale is not None}")


def _to_int8(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp32 / scale, rounded half to even, clipped to +-127."""
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def _absmax_scale(amax: torch.Tensor) -> torch.Tensor:
    """amax / 127; 1 where amax is 0 (an all-zero row or column)."""
    return torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))


def _quantize_symmetric(x: torch.Tensor, axis: int):
    xf = x.detach().float()
    scale = _absmax_scale(xf.abs().amax(dim=axis, keepdim=True))
    return _to_int8(xf, scale), scale


def quantize_int8(w: torch.Tensor, axis: int = -2) -> QuantizedWeight:
    """Symmetric per-output-channel int8; ``axis`` is the contraction
    (fan-in) axis the scale reduces over. All-zero columns get scale 1,
    so their dequant stays exact."""
    return QuantizedWeight(*_quantize_symmetric(w, axis))


def is_quantized(w: Any) -> bool:
    return isinstance(w, QuantizedWeight)


def dequantize(w: QuantizedWeight, dtype=torch.bfloat16) -> torch.Tensor:
    """int8 x fp32 scale, multiplied in fp32, cast once to ``dtype``."""
    return (w.int8.float() * w.scale).to(dtype)


def quantize_activations_int8(x: torch.Tensor):
    """Dynamic symmetric per-row int8 over the last axis. Returns (q int8,
    scale fp32 [..., 1])."""
    return _quantize_symmetric(x, -1)


QMODES = ("dequant", "w8a8", "w8a8_dynamic", "w8a8_kernel")


def qdot(x: torch.Tensor, w, qmode: str = "dequant",
         row_amax=None) -> torch.Tensor:
    """``x @ w`` for a plain or quantized weight: x [..., K], w [K, N];
    leading dims of x ride along. Plain weights take the ordinary matmul
    in x's dtype whatever ``qmode`` says.

    ``row_amax``: for a product over some of the contraction features
    (a row-cut weight of a tensor-parallel tower, ``parallel/tp.py``), the
    function that turns x's per-row absmax [..., 1] into the whole row's;
    the dynamic per-row activation scales are taken from it."""
    if not is_quantized(w):
        return x @ w.to(x.dtype)
    if qmode == "dequant":
        return x @ dequantize(w, x.dtype)
    if qmode not in QMODES:
        raise ValueError(f"qmode={qmode!r}: expected one of {QMODES}")
    xq, xs = _quantize_input(x, w, qmode, row_amax)
    return rescaled_int8_matmul(xq, xs, w.int8, w.scale, x.dtype, w.kmajor)


def _quantize_input(x: torch.Tensor, w: QuantizedWeight, qmode: str,
                    row_amax=None):
    """``qdot``'s int8 activation and its scale, picked once: the static
    ``act_scale`` under w8a8, else per row (through ``row_amax``). Its
    fp32 copy of x is freed before the product runs."""
    xf = x.detach().float()
    if qmode == "w8a8" and w.act_scale is not None:
        # static calibrated scale: one scalar, no reduction over x
        xs = w.act_scale
    else:
        amax = xf.abs().amax(dim=-1, keepdim=True)
        xs = _absmax_scale(amax if row_amax is None else row_amax(amax))
    return _to_int8(xf, xs), xs


def bucket_qmode(qmode: str, rows: int) -> str:
    """The qmode of a batch of ``rows`` rows (the global batch on a
    mesh): under w8a8 a single row runs the dynamic per-row path over the
    same int8 weights (the JAX package's rule; it changes the numbers,
    not only the speed)."""
    return "w8a8_dynamic" if qmode == "w8a8" and rows == 1 else qmode


# ---------------------------------------------------------------------------
# Whole towers
# ---------------------------------------------------------------------------

#: the quantized matmul weights of one block, as (submodule, attribute)
BLOCK_WEIGHTS = (("attn", "wqkv"), ("attn", "wo"),
                 ("mlp", "w_fc"), ("mlp", "w_proj"))


def _shallow(module: nn.Module) -> nn.Module:
    """A new module object sharing every parameter, buffer and submodule
    with ``module``; replacing an entry on it leaves ``module`` as it
    was."""
    new = copy.copy(module)
    new._parameters = dict(module._parameters)
    new._buffers = dict(module._buffers)
    new._modules = dict(module._modules)
    return new


def _replace(module: nn.Module, name: str, value: nn.Module) -> None:
    module._parameters.pop(name, None)
    module._modules.pop(name, None)
    module._modules[name] = value


def _copy_blocks(blocks: nn.ModuleList) -> nn.ModuleList:
    new = _shallow(blocks)
    for i, block in enumerate(blocks):
        b = _shallow(block)
        for outer, _ in BLOCK_WEIGHTS:
            b._modules[outer] = _shallow(getattr(block, outer))
        new._modules[str(i)] = b
    return new


def quantize_clip_params(model, towers=("visual",)):
    """Copy of a ``CLIP`` whose chosen towers' matmul weights are
    ``QuantizedWeight``s (per layer: per-(layer, column) scales, as the
    JAX package's stacked [L, 1, out]). New module objects along the
    touched paths only; every other tensor is the original's, and the
    input model is never changed. Default: the vision tower only (the
    per-request hot path; text encodes once per class set)."""
    new = _shallow(model)
    if "visual" in towers:
        if not model.cfg.is_vit:
            raise ValueError(
                "int8 weight quantization covers the ViT towers only; "
                "serve ResNet backbones unquantized")
        v = _shallow(model.visual)
        _replace(v, "patch_kernel", quantize_int8(model.visual.patch_kernel))
        _replace(v, "proj", quantize_int8(model.visual.proj))
        v._modules["blocks"] = _quantize_blocks(model.visual.blocks)
        new._modules["visual"] = v
    if "text" in towers:
        t = _shallow(model.text)
        _replace(t, "text_projection",
                 quantize_int8(model.text.text_projection))
        t._modules["blocks"] = _quantize_blocks(model.text.blocks)
        new._modules["text"] = t
    return new


def _quantize_blocks(blocks: nn.ModuleList) -> nn.ModuleList:
    new = _copy_blocks(blocks)
    for block in new:
        for outer, key in BLOCK_WEIGHTS:
            sub = getattr(block, outer)
            _replace(sub, key, quantize_int8(getattr(sub, key)))
    return new


# ---------------------------------------------------------------------------
# Static activation scales (calibrated w8a8)
# ---------------------------------------------------------------------------

@torch.no_grad()
def calibrate_image_act_scales(qmodel, cfg, images: torch.Tensor):
    """Per-site activation absmax of the vision tower over a calibration
    batch (preprocessed fp [B, H, W, 3] at the model resolution), taken
    at every quantized-matmul input with the quantized weights in
    weight-only mode. Runs the tower in its default dtype (bf16), as the
    JAX function does. Returns the stats pytree: 0-d tensors for
    ``patch_kernel``/``proj``, [L] for the block sites."""
    from ..models import clip as M

    _, stats = M.encode_image(qmodel, cfg, images, qmode="dequant",
                              collect_act_stats=True)
    return stats


def save_act_stats(path: str, stats) -> None:
    """The stats pytree as npz, in the JAX package's keys
    (``patch_kernel``, ``proj``, ``blocks.<outer>.<key>``), so either
    package loads the other's file."""
    stats = stats_to_numpy(stats)
    flat = {"patch_kernel": stats["patch_kernel"], "proj": stats["proj"]}
    for outer, key in BLOCK_WEIGHTS:
        flat[f"blocks.{outer}.{key}"] = stats["blocks"][outer][key]
    with open(path, "wb") as f:
        np.savez(f, **flat)


def load_act_stats(path: str) -> Dict[str, Any]:
    """Inverse of ``save_act_stats``: npz -> the stats pytree (numpy)."""
    with open(path, "rb") as f:
        data = np.load(f)
        flat = {k: data[k] for k in data.files}
    missing = ({"patch_kernel", "proj"}
               | {f"blocks.{o}.{k}" for o, k in BLOCK_WEIGHTS}) - set(flat)
    if missing:
        raise ValueError(
            f"{path}: not an activation-scale file (missing "
            f"{sorted(missing)}; write it with save_act_stats)")
    blocks: Dict[str, Any] = {}
    for outer, key in BLOCK_WEIGHTS:
        blocks.setdefault(outer, {})[key] = flat[f"blocks.{outer}.{key}"]
    return {"patch_kernel": flat["patch_kernel"], "proj": flat["proj"],
            "blocks": blocks}


def _with_act_scale(w: QuantizedWeight, amax) -> QuantizedWeight:
    a = torch.as_tensor(stats_to_numpy(amax), device=w.int8.device)
    return QuantizedWeight(w.int8, w.scale, _absmax_scale(a), w.kmajor)


def attach_act_scales(qmodel, stats):
    """Copy of a vision-quantized ``CLIP`` with a static ``act_scale``
    (absmax / 127, zero-guarded) on every vision ``QuantizedWeight``,
    which flips ``qdot``'s w8a8 mode from per-row to static scales; the
    int8 weights and scales are shared, not copied. ``stats``: the pytree
    of ``calibrate_image_act_scales`` or ``load_act_stats``."""
    new = _shallow(qmodel)
    v = _shallow(qmodel.visual)
    _replace(v, "patch_kernel",
             _with_act_scale(qmodel.visual.patch_kernel,
                             stats["patch_kernel"]))
    _replace(v, "proj", _with_act_scale(qmodel.visual.proj, stats["proj"]))
    v._modules["blocks"] = _blocks_with_act_scales(qmodel.visual.blocks,
                                                   stats["blocks"])
    new._modules["visual"] = v
    return new


def _blocks_with_act_scales(blocks: nn.ModuleList, stats) -> nn.ModuleList:
    """Copy of quantized blocks whose every ``QuantizedWeight`` carries the
    static scale of its layer's absmax in ``stats[outer][key]`` ([L])."""
    blocks = _copy_blocks(blocks)
    for i, block in enumerate(blocks):
        for outer, key in BLOCK_WEIGHTS:
            sub = getattr(block, outer)
            _replace(sub, key, _with_act_scale(getattr(sub, key),
                                               stats[outer][key][i]))
    return blocks


@torch.no_grad()
def calibrate_text_act_scales(qmodel, cfg, prompts: torch.Tensor,
                              eot_pos: torch.Tensor, seq_len=None):
    """Per-site activation absmax of the TEXT tower over embedded prompts
    [N, 77, D] (``models/clip.py::encode_text_embedded(collect_act_stats=
    True)``), with the quantized weights in weight-only mode. The inputs
    are the trainer's learned prompt rows (``_text_calibration_prompts``),
    so the scales follow from the checkpoint alone. Returns the stats
    pytree ``attach_text_act_scales`` takes: ``text_projection`` 0-d, the
    block sites [L]."""
    from ..models import clip as M

    _, stats = M.encode_text_embedded(qmodel, cfg, prompts, eot_pos,
                                      seq_len=seq_len, qmode="dequant",
                                      collect_act_stats=True)
    return stats


def attach_text_act_scales(qmodel, stats):
    """Copy of a text-quantized ``CLIP`` with a static ``act_scale`` on
    every text ``QuantizedWeight`` (the text twin of
    ``attach_act_scales``; the int8 weights and scales are shared)."""
    new = _shallow(qmodel)
    t = _shallow(qmodel.text)
    _replace(t, "text_projection",
             _with_act_scale(qmodel.text.text_projection,
                             stats["text_projection"]))
    t._modules["blocks"] = _blocks_with_act_scales(qmodel.text.blocks,
                                                   stats["blocks"])
    new._modules["text"] = t
    return new


def stats_to_numpy(stats):
    """The stats pytree with every leaf as a float32 numpy array."""
    if isinstance(stats, dict):
        return {k: stats_to_numpy(v) for k, v in stats.items()}
    if isinstance(stats, torch.Tensor):
        return stats.detach().float().cpu().numpy()
    return np.asarray(stats, np.float32)
