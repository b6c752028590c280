"""ModifiedResNet vision tower (RN50/RN101/RN50x* backbones).

Mirrors ``clip_calibration_tpu/models/resnet.py`` (parity target:
reference ``clip/model.py:10-150``): a 3-conv stem with average pooling,
anti-aliased bottlenecks (a 2x2 average pool before every stride-2 conv),
BatchNorm in inference mode with frozen statistics, and an attention pool
that evaluates only the mean-token query (the reference computes full
self-attention and keeps row 0).

PyTorch idiom: NCHW activations and OIHW conv weights through
``torch.nn.functional.conv2d`` (cuDNN on the card; the JAX package leaves
the convolutions and the pool's einsums to XLA, outside any Pallas
kernel). The attention pool's tokens are the feature map flattened H-major
then W, the JAX package's NHWC order. The parameter tree is the JAX
package's: the JAX-layout flat keys (``visual/stem/conv1``,
``visual/layer1/0/bn1/scale``, ``visual/attnpool/q_w``) name these modules'
parameters, and ``models/weights.py`` carries the conv kernels between
HWIO (JAX) and OIHW (here).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class BatchNorm(nn.Module):
    """Frozen BatchNorm: affine ``scale``/``bias`` and running ``mean``/
    ``var``, all fp32."""

    def __init__(self, channels: int, device):
        super().__init__()
        for name in ("scale", "bias", "mean", "var"):
            setattr(self, name, _param((channels,), torch.float32, device))

    def forward(self, x):
        std = torch.sqrt(self.var + 1e-5)
        scale = (self.scale / std).to(x.dtype)
        bias = (self.bias - self.mean * self.scale / std).to(x.dtype)
        return x * scale[:, None, None] + bias[:, None, None]


def _conv(x, kernel, stride: int = 1):
    # torch-style symmetric padding (k - 1) // 2
    pad = (kernel.shape[-1] - 1) // 2
    return F.conv2d(x, kernel.to(x.dtype), stride=stride, padding=pad)


class Stem(nn.Module):
    def __init__(self, width: int, dtype, device):
        super().__init__()
        half = width // 2
        self.conv1 = _param((half, 3, 3, 3), dtype, device)
        self.bn1 = BatchNorm(half, device)
        self.conv2 = _param((half, half, 3, 3), dtype, device)
        self.bn2 = BatchNorm(half, device)
        self.conv3 = _param((width, half, 3, 3), dtype, device)
        self.bn3 = BatchNorm(width, device)

    def forward(self, x):
        x = F.relu(self.bn1(_conv(x, self.conv1, stride=2)))
        x = F.relu(self.bn2(_conv(x, self.conv2)))
        x = F.relu(self.bn3(_conv(x, self.conv3)))
        return F.avg_pool2d(x, 2)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> (avgpool) -> 1x1 x4, with a pooled 1x1 downsample
    where the stride or the width changes."""

    def __init__(self, inplanes: int, planes: int, stride: int, dtype,
                 device):
        super().__init__()
        self.stride = stride
        self.conv1 = _param((planes, inplanes, 1, 1), dtype, device)
        self.bn1 = BatchNorm(planes, device)
        self.conv2 = _param((planes, planes, 3, 3), dtype, device)
        self.bn2 = BatchNorm(planes, device)
        self.conv3 = _param((planes * 4, planes, 1, 1), dtype, device)
        self.bn3 = BatchNorm(planes * 4, device)
        self.down_conv = self.down_bn = None
        if stride > 1 or inplanes != planes * 4:
            self.down_conv = _param((planes * 4, inplanes, 1, 1), dtype,
                                    device)
            self.down_bn = BatchNorm(planes * 4, device)

    def forward(self, x):
        out = F.relu(self.bn1(_conv(x, self.conv1)))
        out = F.relu(self.bn2(_conv(out, self.conv2)))
        if self.stride > 1:
            out = F.avg_pool2d(out, 2)
        out = self.bn3(_conv(out, self.conv3))
        identity = x
        if self.down_conv is not None:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, 2)
            identity = self.down_bn(_conv(identity, self.down_conv))
        return F.relu(out + identity)


class AttentionPool(nn.Module):
    """QKV attention pooling over the final feature map, evaluated for the
    mean-token query only. Projection weights [in, out] (``x @ w``)."""

    def __init__(self, spacial: int, embed_dim: int, out_dim: int, dtype,
                 device):
        super().__init__()
        f32 = torch.float32
        self.positional_embedding = _param((spacial ** 2 + 1, embed_dim),
                                           f32, device)
        for name, out in (("q", embed_dim), ("k", embed_dim),
                          ("v", embed_dim), ("c", out_dim)):
            setattr(self, name + "_w", _param((embed_dim, out), dtype,
                                              device))
            setattr(self, name + "_b", _param((out,), f32, device))

    def forward(self, x, n_heads: int):
        B, C = x.shape[:2]
        tokens = x.flatten(2).transpose(1, 2)            # [B, H*W, C]
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], 1)
        tokens = tokens + self.positional_embedding.to(tokens.dtype)
        head = C // n_heads

        def proj(t, name):
            return (t @ getattr(self, name + "_w").to(t.dtype)
                    + getattr(self, name + "_b").to(t.dtype))

        q = proj(tokens[:, :1], "q").reshape(B, 1, n_heads, head)
        k = proj(tokens, "k").reshape(B, -1, n_heads, head)
        v = proj(tokens, "v").reshape(B, -1, n_heads, head)
        scores = torch.einsum("bqhd,bkhd->bhqk",
                              (q * head ** -0.5).float(), k.float())
        probs = torch.softmax(scores, dim=-1).to(tokens.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, 1, C)
        return proj(out, "c")[:, 0]


def _stages(cfg) -> Tuple[Tuple[int, int, int], ...]:
    """(planes multiplier, blocks, stride) of layer1..layer4."""
    layers = cfg.vision_layers
    return ((1, layers[0], 1), (2, layers[1], 2), (4, layers[2], 2),
            (8, layers[3], 2))


class ModifiedResNet(nn.Module):
    """The tower's modules, parameters allocated uninitialised (fill them
    with ``init_modified_resnet`` or ``models/weights.py``)."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        width = cfg.vision_width
        self.stem = Stem(width, dtype, device)
        inplanes = width
        for li, (mult, n_blocks, stride) in enumerate(_stages(cfg)):
            planes = width * mult
            blocks = []
            for b in range(n_blocks):
                blocks.append(Bottleneck(inplanes, planes,
                                         stride if b == 0 else 1, dtype,
                                         device))
                inplanes = planes * 4
            setattr(self, f"layer{li + 1}", nn.ModuleList(blocks))
        self.attnpool = AttentionPool(cfg.image_resolution // 32, width * 32,
                                      cfg.embed_dim, dtype, device)

    def forward(self, x, n_heads: int):
        """x [B, H, W, 3] preprocessed (NHWC, as every tower takes it) ->
        [B, embed_dim]."""
        x = self.stem(x.permute(0, 3, 1, 2))
        for li in range(4):
            for block in getattr(self, f"layer{li + 1}"):
                x = block(x)
        return self.attnpool(x, n_heads)


# ---------------------------------------------------------------------------
# init / conversion
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_modified_resnet(tower: ModifiedResNet, gen: torch.Generator
                         ) -> ModifiedResNet:
    """Seeded random init in place, with the JAX package's distributions
    (He-normal convs, identity BatchNorm, N(0, embed^-1/2) pool weights,
    zero biases); values differ from the JAX package's draws."""
    device = tower.attnpool.q_b.device

    def normal(p, std):
        p.copy_(torch.randn(p.shape, generator=gen, device=device,
                            dtype=torch.float32) * std)

    for name, p in tower.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.ndim == 4:  # conv [O, I, kh, kw]: fan_in = kh kw I
            normal(p, (2.0 / (p.shape[1] * p.shape[2] * p.shape[3])) ** 0.5)
        elif leaf in ("scale", "var"):
            p.fill_(1.0)
        elif leaf in ("bias", "mean") or leaf.endswith("_b"):
            p.zero_()
    pool = tower.attnpool
    std = pool.positional_embedding.shape[1] ** -0.5
    normal(pool.positional_embedding, std)
    for name in ("q", "k", "v", "c"):
        normal(getattr(pool, name + "_w"), std)
    return tower


def convert_torch_resnet(sd: Dict[str, np.ndarray], cfg
                         ) -> Dict[str, np.ndarray]:
    """OpenAI ``visual.*`` ModifiedResNet tensors -> the JAX package's flat
    fp32 layout (``visual/...`` keys, HWIO conv kernels, [in, out]
    projections)."""
    f32 = np.float32
    flat = {}

    def conv(ours, theirs):
        w = np.asarray(sd[f"visual.{theirs}.weight"], f32)
        flat[f"visual/{ours}"] = w.transpose(2, 3, 1, 0)  # OIHW -> HWIO

    def bn(ours, theirs):
        for leaf, name in (("scale", "weight"), ("bias", "bias"),
                           ("mean", "running_mean"),
                           ("var", "running_var")):
            flat[f"visual/{ours}/{leaf}"] = np.asarray(
                sd[f"visual.{theirs}.{name}"], f32)

    for i in (1, 2, 3):
        conv(f"stem/conv{i}", f"conv{i}")
        bn(f"stem/bn{i}", f"bn{i}")
    for li, (_, n_blocks, _) in enumerate(_stages(cfg)):
        for b in range(n_blocks):
            pre = f"layer{li + 1}.{b}"
            ours = f"layer{li + 1}/{b}"
            for i in (1, 2, 3):
                conv(f"{ours}/conv{i}", f"{pre}.conv{i}")
                bn(f"{ours}/bn{i}", f"{pre}.bn{i}")
            if f"visual.{pre}.downsample.0.weight" in sd:
                conv(f"{ours}/down_conv", f"{pre}.downsample.0")
                bn(f"{ours}/down_bn", f"{pre}.downsample.1")
    flat["visual/attnpool/positional_embedding"] = np.asarray(
        sd["visual.attnpool.positional_embedding"], f32)
    for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                         ("c", "c_proj")):
        flat[f"visual/attnpool/{ours}_w"] = np.asarray(
            sd[f"visual.attnpool.{theirs}.weight"], f32).T
        flat[f"visual/attnpool/{ours}_b"] = np.asarray(
            sd[f"visual.attnpool.{theirs}.bias"], f32)
    return flat
