"""Tensor-parallel (head- and hidden-sharded) tower execution, forward
only: the serving towers over a mesh's ``model`` axis.

Counterpart of ``clip_calibration_tpu/parallel/tp.py``. The JAX package
places sharding constraints on the activations and lets GSPMD partition
the matmuls and insert the two reductions. Here each model rank holds its
slices of every block (Megatron split) and runs them:

- attention: the rank's H/m heads. Their q, k and v columns of ``wqkv``
  are cut out of each of the three blocks and concatenated, so the fused
  attention (K1 on the card) reads a contiguous packed [B, L, 3D/m] with
  H/m heads; the matching rows of ``wo`` give a partial out-projection,
  summed over the model ranks by one ``all_reduce``, then ``bo`` added
  once.
- MLP: the rank's columns of ``w_fc`` (and of ``b_fc``) and the matching
  rows of ``w_proj``; one ``all_reduce`` after the down-projection, then
  ``b_proj``.

Weights stay whole on every rank (CLIP towers fit on one card); the
slices are copies made at a block's first TP forward. The JAX TP path
runs the einsum attention (its Pallas kernel is a one-device program);
the port runs K1 on the local heads: the same math, on the kernel.

Int8 weights (``ops/quant.py::QuantizedWeight``) are cut the same way:
the int8 weight, its K-major copy (which K3 reads) and, for the column
cuts, the per-output-channel scales; the static activation scale stays
whole. A row cut's product (``wo``, ``w_proj``) contracts features that
are split over the model ranks, so its dynamic per-row activation scale
takes the absmax over the whole row (``max``, a MAX ``all_reduce``), as
the JAX package's GSPMD-partitioned reduction does.

Scope: the ViT towers and the text tower. The ModifiedResNet tower is
data-parallel only (``models/clip.py::encode_image`` raises).
"""

from __future__ import annotations

import weakref
from typing import Optional

import torch
import torch.distributed as dist

from ..ops.quant import QuantizedWeight, is_quantized
from .mesh import Mesh


class TowerTP:
    """This model rank's block slices, and the reduction over the model
    group."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.m = mesh.dims[1]
        self.r = mesh.model_coord
        self._slices = weakref.WeakKeyDictionary()

    def heads(self, n_heads: int) -> int:
        """This rank's head count."""
        if n_heads % self.m:
            raise ValueError(
                f"{n_heads} heads do not split over a model axis of "
                f"{self.m}")
        return n_heads // self.m

    def block(self, block) -> dict:
        """The rank's slices of ``block``'s weights, made once."""
        got = self._slices.get(block)
        if got is None:
            got = self._slices[block] = self._cut(block)
        return got

    def _cut(self, block) -> dict:
        a, mlp = block.attn, block.mlp
        D = a.wo.shape[0]
        if D % self.m:
            raise ValueError(f"width {D} does not split over {self.m}")
        dl = D // self.m
        dev = a.bqkv.device
        heads = torch.cat([torch.arange(k * D + self.r * dl,
                                        k * D + (self.r + 1) * dl)
                           for k in range(3)]).to(dev)
        feats = torch.arange(self.r * dl, (self.r + 1) * dl, device=dev)
        hid = mlp.w_fc.shape[1] // self.m
        hidden = torch.arange(self.r * hid, (self.r + 1) * hid, device=dev)
        with torch.no_grad():
            return {
                "wqkv": _columns(a.wqkv, heads),
                "bqkv": a.bqkv.index_select(0, heads),
                "wo": _rows(a.wo, feats),
                "w_fc": _columns(mlp.w_fc, hidden),
                "b_fc": mlp.b_fc.index_select(0, hidden),
                "w_proj": _rows(mlp.w_proj, hidden),
            }

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of the model ranks' partial products (in place)."""
        if t.requires_grad:
            raise RuntimeError("tensor-parallel towers run forward only "
                               "(serving); they have no backward")
        t = t.contiguous()
        dist.all_reduce(t, group=self.mesh.model_group)
        return t

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise max over the model ranks (in place): a row's absmax
        from each rank's share of its features."""
        t = t.contiguous()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.mesh.model_group)
        return t


def _columns(w, idx: torch.Tensor):
    """The columns ``idx`` of a [K, N] weight, plain or int8 (with their
    scales and the matching rows of the K-major copy), contiguous."""
    if not is_quantized(w):
        return w.index_select(1, idx)
    return QuantizedWeight(w.int8.index_select(1, idx),
                           w.scale.index_select(1, idx), w.act_scale,
                           w.kmajor.index_select(0, idx))


def _rows(w, idx: torch.Tensor):
    """The rows ``idx`` of a [K, N] weight, plain or int8 (every column's
    scale kept, the matching columns of the K-major copy), contiguous."""
    if not is_quantized(w):
        return w.index_select(0, idx)
    return QuantizedWeight(w.int8.index_select(0, idx), w.scale,
                           w.act_scale, w.kmajor.index_select(1, idx))


def tower_tp(mesh: Optional[Mesh]) -> Optional[TowerTP]:
    """TowerTP for ``mesh``, or None when it has no model axis > 1 (a
    data-parallel mesh runs the towers whole)."""
    if mesh is None or mesh.dims[1] <= 1:
        return None
    return TowerTP(mesh)
