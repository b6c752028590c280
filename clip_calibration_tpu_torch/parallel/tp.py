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

Scope: the ViT towers and the text tower. The ModifiedResNet tower is
data-parallel only (``models/clip.py::encode_image`` raises). Int8
weights under TP are not ported (``ROADMAP.md`` queue 1) and raise.
"""

from __future__ import annotations

import weakref
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh

INT8_TP_ERROR = ("int8 weights on a tensor-parallel tower (model axis > 1) "
                 "are not ported yet (ROADMAP.md queue 1: int8 weights "
                 "under TP); serve them on a data-only mesh")


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
        from ..ops.quant import is_quantized
        a, mlp = block.attn, block.mlp
        if any(is_quantized(w) for w in (a.wqkv, a.wo, mlp.w_fc,
                                         mlp.w_proj)):
            raise NotImplementedError(INT8_TP_ERROR)
        D = a.wo.shape[0]
        if D % self.m:
            raise ValueError(f"width {D} does not split over {self.m}")
        dl = D // self.m
        cols = torch.cat([torch.arange(k * D + self.r * dl,
                                       k * D + (self.r + 1) * dl)
                          for k in range(3)]).to(a.wqkv.device)
        hid = mlp.w_fc.shape[1] // self.m
        hs = slice(self.r * hid, (self.r + 1) * hid)
        with torch.no_grad():
            return {
                "wqkv": a.wqkv.index_select(1, cols).contiguous(),
                "bqkv": a.bqkv.index_select(0, cols).contiguous(),
                "wo": a.wo[self.r * dl:(self.r + 1) * dl].contiguous(),
                "w_fc": mlp.w_fc[:, hs].contiguous(),
                "b_fc": mlp.b_fc[hs].contiguous(),
                "w_proj": mlp.w_proj[hs].contiguous(),
            }

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of the model ranks' partial products (in place)."""
        if t.requires_grad:
            raise RuntimeError("tensor-parallel towers run forward only "
                               "(serving); they have no backward")
        t = t.contiguous()
        dist.all_reduce(t, group=self.mesh.model_group)
        return t


def tower_tp(mesh: Optional[Mesh]) -> Optional[TowerTP]:
    """TowerTP for ``mesh``, or None when it has no model axis > 1 (a
    data-parallel mesh runs the towers whole)."""
    if mesh is None or mesh.dims[1] <= 1:
        return None
    return TowerTP(mesh)
