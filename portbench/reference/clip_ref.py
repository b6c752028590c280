"""Plain PyTorch CLIP: the benchmark's reference for the port.

OpenAI CLIP's forward (https://github.com/openai/CLIP, ``clip/model.py``):
pre-LN residual blocks whose MLP has the configuration's width and
activation (QuickGELU, or the exact GELU of OpenCLIP's ``nn.GELU``), a
ViT image tower (patches as one product, class token, positions,
``ln_pre``, blocks, ``ln_post`` on the class token, projection) and a
causal text tower pooled at the end-of-text token. Plain tensor
operations, no fused kernels, no padding of the token axis, computed in
blocks of rows so that it fits beside nothing else. It reads the
benchmark's weight dict (``weights.py``) and imports nothing of the port.

``products`` says how every product is computed:

- ``"fp32"``: fp32 operands and sums, TF32 off (the reference proper);
- ``"fp8"``: both operands of every product, attention's included,
  rounded to float8 (e4m3, one scale a tensor; gradients e5m2): the
  control of a bf16 configuration;
- ``"int8"``: the vision tower's projections as w8a8: weights int8 per
  output column (absmax / 127 over the fan-in), activations int8 with a
  static scale a site (absmax / 127 over a calibration batch, taken with
  the dequantized weights), or a dynamic one a row; integer sums exact;
  the rescale ``acc * x_scale * w_scale`` in fp32. Everything else fp32;
- ``"int4"``: the same with 4-bit integers (absmax / 7): the control of
  an int8 configuration.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from .. import schema

MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)
QMAX = {"int8": 127, "int4": 7}


@contextlib.contextmanager
def exact_fp32():
    """fp32 products in fp32 (no TF32) inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _fp8(x: torch.Tensor, fmt) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = amax / torch.finfo(fmt).max
    return (x / scale).to(fmt).float() * scale


class _Fp8Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


def _absmax_scale(amax: torch.Tensor, qmax: int) -> torch.Tensor:
    return torch.where(amax > 0, amax / qmax, torch.ones_like(amax))


def _quantize(x: torch.Tensor, scale: torch.Tensor, qmax: int):
    return torch.clamp(torch.round(x / scale), -qmax, qmax)


class ReferenceCLIP:
    """The forward of one configuration on the benchmark's weights."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor],
                 products: str = "fp32"):
        if products not in ("fp32", "fp8", "int8", "int4"):
            raise ValueError(f"products={products!r}")
        self.cfg = cfg
        self.w = weights
        self.products = products
        self.activation = schema.activation(cfg)
        self.act_scales: Optional[Dict[str, torch.Tensor]] = None
        self._calibrating: Optional[Dict[str, torch.Tensor]] = None
        self._dynamic = False
        self._qweights: Dict[str, tuple] = {}

    # -- products ------------------------------------------------------------
    def _f(self, name: str) -> torch.Tensor:
        return self.w[name].float()

    def _round(self, x):
        return _Fp8Round.apply(x) if self.products == "fp8" else x

    def _qweight(self, name: str):
        if name not in self._qweights:
            qmax = QMAX[self.products]
            w = self._f(name)
            ws = _absmax_scale(w.abs().amax(dim=0, keepdim=True), qmax)
            self._qweights[name] = (_quantize(w, ws, qmax), ws)
        return self._qweights[name]

    def mm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """x @ weight ``name`` as ``products`` says."""
        if self.products in QMAX and name.startswith("visual."):
            return self._int_product(x, name)
        return self._round(x) @ self._round(self._f(name))

    def _int_product(self, x: torch.Tensor, name: str) -> torch.Tensor:
        qmax = QMAX[self.products]
        wq, ws = self._qweight(name)
        if self._calibrating is not None:
            amax = x[:, :self._real_len].abs().amax() if x.ndim == 3 \
                else x.abs().amax()
            prev = self._calibrating.get(name)
            self._calibrating[name] = amax if prev is None \
                else torch.maximum(prev, amax)
            return x @ (wq * ws)
        if self._dynamic:
            xs = _absmax_scale(x.abs().amax(dim=-1, keepdim=True), qmax)
        else:
            xs = self.act_scales[name]
        xq = _quantize(x, xs, qmax)
        acc = (xq.double() @ wq.double()).float()
        return acc * xs * ws

    # -- blocks ----------------------------------------------------------------
    def _ln(self, x, name):
        return torch.nn.functional.layer_norm(
            x, x.shape[-1:], self._f(name + ".scale"), self._f(name + ".bias"),
            eps=1e-5)

    def _attention(self, qkv, heads: int, mask):
        B, L, D3 = qkv.shape
        D = D3 // 3
        q, k, v = (t.reshape(B, L, heads, D // heads).transpose(1, 2)
                   for t in qkv.split(D, dim=-1))
        s = (self._round(q) @ self._round(k).transpose(-1, -2)) \
            * (D // heads) ** -0.5
        if mask is not None:
            s = s + mask
        p = torch.softmax(s, dim=-1)
        out = self._round(p) @ self._round(v)
        return out.transpose(1, 2).reshape(B, L, D)

    def _block(self, x, p: str, heads: int, mask):
        h = self._ln(x, p + "ln_1")
        qkv = self.mm(h, p + "attn.wqkv") + self._f(p + "attn.bqkv")
        ctx = self._attention(qkv, heads, mask)
        x = x + self.mm(ctx, p + "attn.wo") + self._f(p + "attn.bo")
        h = self._ln(x, p + "ln_2")
        y = self.mm(h, p + "mlp.w_fc") + self._f(p + "mlp.b_fc")
        if self.activation == "gelu":
            y = torch.nn.functional.gelu(y)
        else:
            y = y * torch.sigmoid(1.702 * y)
        return x + self.mm(y, p + "mlp.w_proj") + self._f(p + "mlp.b_proj")

    # -- towers ----------------------------------------------------------------
    def _image_block(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        P = cfg["vision_patch_size"]
        x = images.float() / 255.0
        x = (x - torch.tensor(MEAN, device=x.device)) \
            / torch.tensor(STD, device=x.device)
        B, H, W, C = x.shape
        x = x.reshape(B, H // P, P, W // P, P, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, (H // P) * (W // P), P * P * C)
        self._real_len = x.shape[1] + 1
        x = self.mm(x, "visual.patch_kernel")
        cls = self._f("visual.class_embedding").expand(B, 1, -1)
        x = torch.cat([cls, x], dim=1) + self._f("visual.positional_embedding")
        x = self._ln(x, "visual.ln_pre")
        for i in range(cfg["vision_layers"]):
            x = self._block(x, f"visual.blocks.{i}.", cfg["vision_heads"],
                            None)
        x = self._ln(x[:, 0], "visual.ln_post")
        return self.mm(x, "visual.proj")

    @torch.no_grad()
    def image_features(self, images: torch.Tensor, chunk: int = 32,
                       dynamic: bool = False) -> torch.Tensor:
        """uint8 [B, H, W, 3] at the model's resolution -> [B, E] fp32
        (unnormalised); ``dynamic``: per-row activation scales (int
        products only)."""
        self._dynamic = dynamic
        try:
            with exact_fp32():
                return torch.cat([self._image_block(images[i:i + chunk])
                                  for i in range(0, len(images), chunk)])
        finally:
            self._dynamic = False

    @torch.no_grad()
    def calibrate(self, images: torch.Tensor, chunk: int = 32) -> None:
        """Static activation scales of the int products: absmax / qmax of
        every vision product's input over the real tokens of ``images``,
        with the dequantized weights."""
        self._calibrating = {}
        try:
            with exact_fp32():
                for i in range(0, len(images), chunk):
                    self._image_block(images[i:i + chunk])
            qmax = QMAX[self.products]
            self.act_scales = {k: _absmax_scale(v, qmax)
                               for k, v in self._calibrating.items()}
        finally:
            self._calibrating = None

    def token_embedding(self, tokens: torch.Tensor) -> torch.Tensor:
        return self._f("text.token_embedding")[tokens]

    def text_features_embedded(self, x: torch.Tensor,
                               eot: torch.Tensor) -> torch.Tensor:
        """Embedded rows [N, L, D] (L at least one past the furthest EOT;
        the causal mask keeps later tokens from the pooled row) ->
        [N, E] fp32 (unnormalised). Differentiable in x."""
        cfg = self.cfg
        L = x.shape[1]
        x = x + self._f("text.positional_embedding")[:L]
        mask = torch.triu(torch.full((L, L), float("-inf"),
                                     device=x.device), diagonal=1)
        with exact_fp32():
            for i in range(cfg["transformer_layers"]):
                x = self._block(x, f"text.blocks.{i}.",
                                cfg["transformer_heads"], mask)
            x = self._ln(x, "text.ln_final")
            pooled = x[torch.arange(x.shape[0], device=x.device), eot]
            return self.mm(pooled, "text.text_projection")

    @torch.no_grad()
    def text_features(self, tokens: torch.Tensor,
                      chunk: int = 1024) -> torch.Tensor:
        """Token ids [N, 77] -> [N, E] fp32 (unnormalised)."""
        eot = tokens.argmax(dim=-1)
        L = int(eot.max()) + 1
        return torch.cat([
            self.text_features_embedded(
                self.token_embedding(tokens[i:i + chunk, :L]),
                eot[i:i + chunk]) for i in range(0, len(tokens), chunk)])

    def logit_scale(self) -> torch.Tensor:
        return self._f("logit_scale").exp()


def normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True)
