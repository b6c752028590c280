"""Weight import/export in the JAX package's formats.

- ``params_from_numpy``: the JAX package's flattened parameter dict
  (``flatten_params`` keys such as ``visual/blocks/attn/wqkv``, blocks
  stacked on a leading [n_layers] axis) -> the port's ``CLIP`` module.
  The npz loader and the OpenAI state-dict converter both go through it.
- ``save_params`` / ``load_params``: the native flat-key ``.npz`` format
  (bf16 stored as a uint16 view under a ``::bf16`` key suffix), read and
  written with numpy and ``torch.bfloat16`` views, so files move between
  the two packages.
- ``convert_torch_clip``: OpenAI/reference CLIP state dict -> ``CLIP``
  (shape-inference semantics of ``clip/model.py:656-699``; ViT only).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from .clip import CLIP, CLIPConfig

TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "float16": torch.float16}

# (JAX block leaf, torch resblock tensor, transpose [out,in] -> [in,out])
_BLOCK_LEAVES = (
    ("ln_1/scale", "ln_1.weight", False), ("ln_1/bias", "ln_1.bias", False),
    ("ln_2/scale", "ln_2.weight", False), ("ln_2/bias", "ln_2.bias", False),
    ("attn/wqkv", "attn.in_proj_weight", True),
    ("attn/bqkv", "attn.in_proj_bias", False),
    ("attn/wo", "attn.out_proj.weight", True),
    ("attn/bo", "attn.out_proj.bias", False),
    ("mlp/w_fc", "mlp.c_fc.weight", True),
    ("mlp/b_fc", "mlp.c_fc.bias", False),
    ("mlp/w_proj", "mlp.c_proj.weight", True),
    ("mlp/b_proj", "mlp.c_proj.bias", False),
)


def to_tensor(v) -> torch.Tensor:
    """numpy array (bf16 from ml_dtypes included) or tensor -> CPU tensor."""
    if isinstance(v, torch.Tensor):
        return v
    v = np.array(v, copy=None, order="C")  # keeps 0-d arrays 0-d
    if str(v.dtype) == "bfloat16":
        return torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(v)


def _module_name(key: str, layer: Optional[int] = None) -> str:
    parts = key.split("/")
    if layer is not None:
        parts.insert(2, str(layer))
    return ".".join(parts)


_QUANT_LEAVES = ("int8", "scale", "act_scale")


def _split_quantized(flat: Dict[str, Any]):
    """(plain leaves, {weight key: {"int8", "scale"[, "act_scale"]}}): a
    key ``<w>/int8`` marks ``<w>`` as an int8 weight of the JAX package's
    ``ops/quant.py`` (its ``<w>/scale`` is then no LayerNorm scale)."""
    qkeys = {k[:-len("/int8")] for k in flat if k.endswith("/int8")}
    plain, quant = {}, {}
    for key, value in flat.items():
        base, _, leaf = key.rpartition("/")
        if base in qkeys and leaf in _QUANT_LEAVES:
            quant.setdefault(base, {})[leaf] = value
        else:
            plain[key] = value
    return plain, quant


def _set_quantized(model: CLIP, key: str, leaves: Dict[str, Any], device):
    """Put ``QuantizedWeight``s in place of the parameter named by the
    JAX-layout ``key`` (stacked block leaves are split per layer)."""
    from ..ops.quant import QuantizedWeight, _replace
    parts = key.split("/")
    t = {k: to_tensor(v).to(device, copy=True) for k, v in leaves.items()}
    if "scale" not in t:
        raise KeyError(f"{key}: int8 weight without its scale")
    targets = ([(model.get_submodule(".".join(parts[:2] + [str(i)]
                                              + parts[2:-1])), i)
                for i in range(t["int8"].shape[0])]
               if parts[1:2] == ["blocks"] else
               [(model.get_submodule(".".join(parts[:-1])), None)])
    for module, i in targets:
        p = getattr(module, parts[-1])
        q = {k: v if i is None else v[i] for k, v in t.items()}
        if tuple(q["int8"].shape) != tuple(p.shape):
            raise ValueError(f"{key}: int8 shape {tuple(q['int8'].shape)}"
                             f" != {tuple(p.shape)}")
        _replace(module, parts[-1], QuantizedWeight(
            q["int8"].to(torch.int8), q["scale"].float(),
            q["act_scale"].float() if "act_scale" in q else None))


@torch.no_grad()
def params_from_numpy(flat: Dict[str, Any], cfg: CLIPConfig,
                      dtype=torch.bfloat16, device="cuda") -> CLIP:
    """Build a ``CLIP`` on ``device`` from a JAX-layout flat dict. Matmul
    weights are cast to ``dtype``; norms, biases, embeddings and the
    logit scale are kept in fp32 (biases are cast to the activations'
    dtype where they are added, as in the JAX code). The JAX package's
    quantized leaves (``<w>/int8``, ``<w>/scale``, ``<w>/act_scale``)
    become ``ops/quant.py::QuantizedWeight``s."""
    model = CLIP(cfg, dtype=dtype, device=device)
    flat, quant = _split_quantized(flat)
    for key, leaves in quant.items():
        _set_quantized(model, key, leaves, device)
    params = dict(model.named_parameters())
    filled = set()

    def assign(name, value):
        if name not in params:
            raise KeyError(f"unexpected parameter {name!r}")
        p = params[name]
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(value.shape)} != "
                             f"{tuple(p.shape)}")
        p.copy_(value)
        filled.add(name)

    for key, value in flat.items():
        t = to_tensor(value)
        if key.split("/")[1:2] == ["blocks"]:
            for i in range(t.shape[0]):
                assign(_module_name(key, i), t[i])
        else:
            assign(_module_name(key), t)
    missing = sorted(set(params) - filled)
    if missing:
        raise KeyError(f"parameters missing from the checkpoint: {missing}")
    return model


def flat_params(model: CLIP) -> Dict[str, torch.Tensor]:
    """Inverse of ``params_from_numpy``: JAX-layout flat dict of CPU
    tensors (block leaves stacked over layers; an int8 weight as its
    ``int8``/``scale``/``act_scale`` leaves)."""
    flat: Dict[str, torch.Tensor] = {}
    stacked: Dict[str, list] = {}
    for name, p in [*model.named_parameters(), *model.named_buffers()]:
        parts = name.split(".")
        if parts[1:2] == ["blocks"]:
            key = "/".join(parts[:2] + parts[3:])
            stacked.setdefault(key, []).append(p.detach().cpu())
        else:
            flat["/".join(parts)] = p.detach().cpu()
    for key, layers in stacked.items():
        flat[key] = torch.stack(layers)
    return flat


def save_params(path: str, model: CLIP) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = {}
    for k, v in flat_params(model).items():
        if v.dtype == torch.bfloat16:
            arrays[k + "::bf16"] = v.view(torch.int16).numpy().view(
                np.uint16)
        else:
            arrays[k] = v.numpy()
    np.savez_compressed(path, **arrays)


def load_params(path: str) -> Dict[str, Any]:
    """Flat dict from a native npz: numpy arrays, bf16 leaves as
    ``torch.bfloat16`` tensors."""
    flat = {}
    with np.load(path) as data:
        for k in data.files:
            v = data[k]
            if k.endswith("::bf16"):
                flat[k[:-6]] = torch.from_numpy(
                    v.view(np.int16)).view(torch.bfloat16)
            else:
                flat[k] = v
    return flat


# ---------------------------------------------------------------------------
# torch (OpenAI) state dict import
# ---------------------------------------------------------------------------

def config_from_torch_state_dict(sd: Dict[str, np.ndarray]) -> CLIPConfig:
    """Infer architecture hyperparams from tensor shapes (parity with
    reference ``build_model``, ``clip/model.py:656-680``)."""
    if "visual.proj" not in sd:
        raise ValueError("only ViT CLIP checkpoints are supported")
    vision_width = sd["visual.conv1.weight"].shape[0]
    vision_layers = len([k for k in sd if k.startswith("visual.")
                         and k.endswith(".attn.in_proj_weight")])
    vision_patch_size = sd["visual.conv1.weight"].shape[-1]
    grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
    transformer_width = sd["ln_final.weight"].shape[0]
    return CLIPConfig(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=vision_patch_size * grid,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=vision_patch_size,
        transformer_width=transformer_width,
        transformer_heads=transformer_width // 64,
        transformer_layers=len({k.split(".")[2] for k in sd
                                if k.startswith("transformer.resblocks")}),
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
    )


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu").float().numpy()
    return np.asarray(v)


def torch_state_dict_to_flat(sd: Dict[str, Any], cfg: CLIPConfig
                             ) -> Dict[str, np.ndarray]:
    """OpenAI state dict -> the JAX package's flat fp32 layout."""
    f32 = np.float32
    p = cfg.vision_patch_size
    conv1 = sd["visual.conv1.weight"].astype(f32)  # [vw, 3, p, p]
    flat = {
        # -> [(ph, pw, c), vw] to match patchify()'s patch vector order
        "visual/patch_kernel":
            conv1.transpose(2, 3, 1, 0).reshape(p * p * 3, -1),
        "visual/class_embedding": sd["visual.class_embedding"],
        "visual/positional_embedding": sd["visual.positional_embedding"],
        "visual/ln_pre/scale": sd["visual.ln_pre.weight"],
        "visual/ln_pre/bias": sd["visual.ln_pre.bias"],
        "visual/ln_post/scale": sd["visual.ln_post.weight"],
        "visual/ln_post/bias": sd["visual.ln_post.bias"],
        "visual/proj": sd["visual.proj"],
        "text/token_embedding": sd["token_embedding.weight"],
        "text/positional_embedding": sd["positional_embedding"],
        "text/ln_final/scale": sd["ln_final.weight"],
        "text/ln_final/bias": sd["ln_final.bias"],
        "text/text_projection": sd["text_projection"],
        "logit_scale": sd["logit_scale"],
    }
    for tower, prefix, n in (
            ("visual", "visual.transformer.resblocks", cfg.vision_layers),
            ("text", "transformer.resblocks", cfg.transformer_layers)):
        for leaf, name, transpose in _BLOCK_LEAVES:
            arrs = [sd[f"{prefix}.{i}.{name}"] for i in range(n)]
            flat[f"{tower}/blocks/{leaf}"] = np.stack(
                [a.T if transpose else a for a in arrs])
    return {k: np.asarray(v, f32) for k, v in flat.items()}


def convert_torch_clip(sd: Dict[str, Any], dtype_str: str = "bfloat16",
                       cfg: Optional[CLIPConfig] = None, device="cuda"):
    """Convert a torch CLIP state dict (tensors or numpy arrays) to
    (CLIP, cfg), matmul weights in ``dtype_str`` (reference fp16 policy:
    convert_weights touches Linear/Conv/MHA + projections only,
    ``clip/model.py:632-653``)."""
    sd = {k: _to_numpy(v) for k, v in sd.items()
          if k not in ("input_resolution", "context_length", "vocab_size")}
    if cfg is None:
        cfg = config_from_torch_state_dict(sd)
    model = params_from_numpy(torch_state_dict_to_flat(sd, cfg), cfg,
                              TORCH_DTYPES[dtype_str], device)
    return model, cfg


def load_torch_clip(path: str, dtype_str: str = "bfloat16", device="cuda"):
    """Read an OpenAI ``.pt`` checkpoint (TorchScript archive or plain
    state dict) and convert."""
    try:
        sd = torch.jit.load(path, map_location="cpu").eval().state_dict()
    except RuntimeError:
        obj = torch.load(path, map_location="cpu", weights_only=False)
        sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
        if "state_dict" in sd:
            sd = sd["state_dict"]
    return convert_torch_clip(sd, dtype_str, device=device)
