"""Process mesh over ``torch.distributed``: one process per device.

Counterpart of ``clip_calibration_tpu/parallel/mesh.py``. The JAX package
drives a host's devices from one process and lets GSPMD place the
collectives; here every device is a process (a rank) and the collectives
are explicit:

- ``data``: the batch axis (image encodes, train steps, eval sweeps are
  data-parallel: each data rank holds its slice of every global batch),
- ``model``: the class axis of the CoCoOp and ProDA text fan-outs, and
  the heads and MLP hidden features of tensor-parallel serving towers
  (``parallel/tp.py``).

A mesh of shape (d, m) lays the ranks out row-major: the data coordinate
is ``rank // m``, the model coordinate ``rank % m``. Each rank belongs to
one data group (the d ranks of its model coordinate) and one model group
(the m ranks of its data coordinate). Only ``all_reduce``, ``all_gather``
and ``broadcast`` run over them: gloo has these for CPU and CUDA tensors
alike, so one code path runs under NCCL on cards and under gloo on the
CPU. No autograd collective whose backward is a reduce-scatter or an
all-to-all is used (gloo has neither for CUDA tensors): ``gather_classes``
sends nothing in its backward, ``reduce_data_grad`` runs an
``all_reduce`` in its backward, and the trainables' gradients are
reduced explicitly (``reduce_trainable_grads``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model")


def world() -> Tuple[int, int]:
    """(rank, world size): (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize_distributed(backend: Optional[str] = None,
                           device="cuda") -> int:
    """Join the process group. Call once per process, before the device
    is chosen; every rank runs the same program. Returns the world size.

    The cluster comes from ``CC_COORD_ADDR`` (host:port of rank 0),
    ``CC_NUM_PROCS`` and ``CC_PROC_ID``, the variables the JAX package
    reads, so one launch script drives either package; without them from
    ``torchrun``'s environment (``env://``). ``backend``: ``nccl`` for a
    CUDA device and ``gloo`` for the CPU by default; gloo on cards lets
    several ranks share one. Failures propagate: a run that asked for
    several processes must not go on as independent single-process runs
    writing the same outputs."""
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if os.environ.get("CC_COORD_ADDR"):
        kwargs = dict(init_method=f"tcp://{os.environ['CC_COORD_ADDR']}",
                      world_size=int(os.environ["CC_NUM_PROCS"]),
                      rank=int(os.environ["CC_PROC_ID"]))
        rank = kwargs["rank"]
    else:
        kwargs = dict(init_method="env://")
        rank = int(os.environ.get("RANK", "0"))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, **kwargs)
    return dist.get_world_size()


@dataclasses.dataclass(eq=False)
class Mesh:
    """A (data, model) layout of all ranks, with this rank's groups.

    ``shape`` maps axis name to size, as a JAX mesh's does. A group is
    None where its axis has one rank: collectives over it are skipped."""

    dims: Tuple[int, int]
    rank: int
    data_group: Optional[object]
    model_group: Optional[object]
    data_ranks: Tuple[int, ...]

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.dims))

    @property
    def data_coord(self) -> int:
        return self.rank // self.dims[1]

    @property
    def model_coord(self) -> int:
        return self.rank % self.dims[1]

    @property
    def size(self) -> int:
        return self.dims[0] * self.dims[1]

    def __repr__(self):
        return (f"Mesh(data={self.dims[0]}, model={self.dims[1]}, "
                f"rank={self.rank})")


def make_mesh(mesh_shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = AXES) -> Mesh:
    """A mesh over every rank of the process group (one rank without
    one). Default: all ranks on the data axis. A one-entry shape is the
    data axis alone. Every rank must make the same meshes in the same
    order (the groups are made collectively)."""
    if tuple(axis_names) != AXES:
        raise ValueError(f"mesh axes must be {AXES}, got "
                         f"{tuple(axis_names)}")
    rank, n = world()
    shape = tuple(int(s) for s in (mesh_shape or ()))
    if not shape:
        shape = (n, 1)
    elif len(shape) == 1:
        shape = (shape[0], 1)
    if len(shape) != 2 or min(shape) < 1:
        raise ValueError(f"mesh shape {shape}: expected (data[, model])")
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} ranks")
    d, m = shape
    data_group = model_group = None
    data_ranks = tuple(i * m + rank % m for i in range(d))
    if n > 1:
        # new_group is collective over the whole world: every rank makes
        # every group, in one order
        for j in range(m):
            g = dist.new_group([i * m + j for i in range(d)])
            if j == rank % m and d > 1:
                data_group = g
        for i in range(d):
            g = dist.new_group([i * m + j for j in range(m)])
            if i == rank // m and m > 1:
                model_group = g
    return Mesh(shape, rank, data_group, model_group, data_ranks)


def mesh_from_cfg(cfg) -> Mesh:
    """Mesh from the TPU.MESH_SHAPE / TPU.MESH_AXES config keys."""
    return make_mesh(tuple(cfg.TPU.MESH_SHAPE), tuple(cfg.TPU.MESH_AXES))


def _gather(t: torch.Tensor, group, n: int, dim: int = 0) -> torch.Tensor:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def gather_data(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Concatenate each data rank's rows in data order (every rank holds
    the same number of rows). Identity without a data axis."""
    if mesh is None or mesh.data_group is None:
        return t
    return _gather(t, mesh.data_group, mesh.dims[0])


def local_rows(x, mesh: Optional[Mesh]):
    """This data rank's rows of a global batch that every rank holds
    whole (a serving request, a test batch); a batch the data axis does
    not divide raises."""
    if mesh is None or mesh.dims[0] == 1:
        return x
    n, d = len(x), mesh.dims[0]
    if n % d:
        raise ValueError(f"global batch {n} not divisible by the mesh data "
                         f"axis ({d} ranks); pick a batch size divisible "
                         f"by the data axis")
    k = n // d
    return x[mesh.data_coord * k:(mesh.data_coord + 1) * k]


def to_host_global(t: torch.Tensor, mesh: Optional[Mesh]) -> np.ndarray:
    """A device tensor of this data rank's rows -> the global rows as a
    host array (fp32 for floating types)."""
    t = gather_data(t, mesh)
    if t.is_floating_point():
        t = t.float()
    return t.cpu().numpy()


def from_last_data_rank(t: torch.Tensor,
                        mesh: Optional[Mesh]) -> torch.Tensor:
    """The value of the last data rank (which holds a global batch's
    last rows) on every rank of the data group."""
    if t is None or mesh is None or mesh.data_group is None:
        return t
    t = t.contiguous().clone()
    dist.broadcast(t, src=mesh.data_ranks[-1], group=mesh.data_group)
    return t


def data_mean(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The mean over the data axis of a per-rank value (a loss averaged
    over the rank's rows becomes the global batch's mean)."""
    if mesh is None or mesh.data_group is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=mesh.data_group)
    return t / mesh.dims[0]


def max_over_ranks(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Elementwise max over every rank (absmax calibration statistics
    taken on each rank's slice of the data)."""
    if mesh is None or mesh.size == 1:
        return t
    t = t.detach().clone().contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t


def broadcast_params(tensors, mesh: Optional[Mesh]) -> None:
    """Overwrite ``tensors`` in place with rank 0's values, so every rank
    starts a run from identical trainables."""
    if mesh is None or mesh.size == 1:
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0)


def class_slice(n: int, mesh: Optional[Mesh]) -> torch.Tensor:
    """Indices of this model rank's classes among ``n``: a contiguous
    block of ceil(n / m); where m does not divide n the last blocks repeat
    class n - 1 (the padding ``gather_classes`` trims)."""
    if mesh is None or mesh.model_group is None:
        return torch.arange(n)
    m = mesh.dims[1]
    per = -(-n // m)
    start = mesh.model_coord * per
    return torch.arange(start, start + per).clamp_(max=n - 1)


class _GatherClasses(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh, dim, n):
        m = mesh.dims[1]
        ctx.mesh, ctx.dim, ctx.per = mesh, dim, x.shape[dim]
        out = _gather(x, mesh.model_group, m, dim)
        return out.narrow(dim, 0, n)

    @staticmethod
    def backward(ctx, g):
        # every model rank computed the same loss on the gathered tensor,
        # so each takes its own slice of the gradient; nothing is sent
        # (the trainables' partial gradients are summed over the model
        # group afterwards, reduce_trainable_grads)
        start = ctx.mesh.model_coord * ctx.per
        n = g.shape[ctx.dim]
        take = max(0, min(ctx.per, n - start))
        part = g.narrow(ctx.dim, min(start, n), take)
        if take < ctx.per:
            pad = list(g.shape)
            pad[ctx.dim] = ctx.per - take
            part = torch.cat([part, g.new_zeros(pad)], dim=ctx.dim)
        return part, None, None, None


def gather_classes(x: torch.Tensor, mesh: Optional[Mesh], dim: int,
                   n: int) -> torch.Tensor:
    """The full class axis from each model rank's block (``class_slice``)
    along ``dim``, trimmed to ``n`` classes; differentiable. Identity
    without a model axis."""
    if mesh is None or mesh.model_group is None:
        return x
    return _GatherClasses.apply(x, mesh, dim, n)


class _CountOnce(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.keep = mesh.model_coord == 0
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None


def count_once(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Marks a value that every model rank computes alike (not sharded
    over classes): its gradient stays on model rank 0 and is zero on the
    others, so the model-group sum of ``reduce_trainable_grads`` adds it
    exactly once. Identity without a model axis."""
    if mesh is None or mesh.model_group is None:
        return x
    return _CountOnce.apply(x, mesh)


class _ReduceDataGrad(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # each rank's loss is the mean over its own rows: the sum over the
        # data group divided by its size is the global batch's gradient
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.data_group)
        return g / ctx.mesh.dims[0], None


def reduce_data_grad(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Marks a value that every data rank computes alike (the class text
    features) where it meets this rank's rows of the batch: the forward
    is the identity; the backward sums its gradient over the data group
    and divides by the data axis, so what lies behind it (the text
    tower) runs its backward on the global batch's gradient, the same on
    every data rank. This is the JAX mesh step's order: GSPMD sums the
    replicated operand's gradient over the data axis at the product with
    the sharded one, then runs the tower's backward once. Apply it after
    the fp32 cast, so the sum runs in fp32 and the bf16 backward rounds
    the global gradient as one rank's does. Identity without a data axis
    or on a value that takes no gradient."""
    if mesh is None or mesh.data_group is None or not x.requires_grad:
        return x
    return _ReduceDataGrad.apply(x, mesh)


def reduce_grads(grads, mesh: Optional[Mesh],
                 model_sharded: bool = False):
    """The global loss's gradients from each rank's ``grads`` (a sequence
    of tensors), as new tensors.

    ``model_sharded``: the step sharded the class axis over the model
    ranks (``gather_classes``; replicated parts under ``count_once``), so
    each holds a partial gradient: sum them over the model group. Then
    average over the data group (each rank's loss is its rows' mean).
    Without a class-sharded step the model ranks hold equal gradients
    and only the data average runs. One collective per dtype and axis.

    A step whose text side went through ``reduce_data_grad`` holds that
    side's part already equal on every data rank: the data average
    leaves it as it is (to fp32 rounding), and adds each rank's own part
    of an image side (MaPLe's and PromptSRC's vision prompts, MaPLe's
    projection of its context) into the global gradient, since the mean
    of G + v_r over the ranks is G + mean(v_r)."""
    grads = list(grads)
    if mesh is None or mesh.size == 1:
        return grads
    out = list(grads)
    by_dtype = {}
    for i, g in enumerate(grads):
        by_dtype.setdefault(g.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        if model_sharded and mesh.model_group is not None:
            dist.all_reduce(flat, group=mesh.model_group)
        if mesh.data_group is not None:
            dist.all_reduce(flat, group=mesh.data_group)
            flat /= mesh.dims[0]
        offset = 0
        for i in idx:
            k = grads[i].numel()
            out[i] = flat[offset:offset + k].view_as(grads[i])
            offset += k
    return out


def reduce_trainable_grads(params, mesh: Optional[Mesh],
                           model_sharded: bool = False) -> None:
    """``reduce_grads`` on the ``.grad`` of each of ``params``, in place;
    every one must have a gradient (``engine/trainer.py::optimizer_step``
    gives a missing one zeros)."""
    if mesh is None or mesh.size == 1:
        return
    params = list(params)
    for p, g in zip(params, reduce_grads([p.grad for p in params], mesh,
                                         model_sharded)):
        p.grad = g
