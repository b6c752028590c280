"""Optimizers and the LR schedule, with the JAX package's semantics.

Counterpart of ``clip_calibration_tpu/engine/optim.py`` (Dassl's
``build_optimizer`` / ``build_lr_scheduler`` as the reference configs use
them: SGD with momentum 0.9 and weight decay 5e-4, cosine annealing
stepped per epoch, constant-lr warmup). The optimizers are torch's, set
up to follow the optax chains exactly:

- sgd: ``add_decayed_weights`` before ``trace`` is torch SGD's
  ``weight_decay``; ``trace(decay, nesterov)`` is its momentum buffer
  with ``dampening=0`` (optax's trace starts at zero, torch's buffer at
  the first gradient: the same first step);
- adam: ``add_decayed_weights`` then ``scale_by_adam`` is torch Adam with
  ``weight_decay`` (eps 1e-8, eps_root 0);
- adamw: ``scale_by_adam`` then ``add_decayed_weights``, both scaled by
  the lr, is torch AdamW.

The schedule is a function of the optimizer's step count, as optax's
``scale_by_learning_rate(schedule)``: the trainer sets every param group's
lr to ``schedule(step)`` before each step (``set_lr``).

``opt_state_leaves`` / ``load_opt_state_leaves`` carry the state across
packages in optax's leaf order, the order the JAX checkpoints store it in
(``engine/checkpoint.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch


def build_lr_schedule(cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """step -> lr: the per-epoch table of the JAX ``build_lr_schedule``
    (Dassl's per-epoch stepping, warmup shift included), indexed by
    ``step // steps_per_epoch`` clipped to [0, MAX_EPOCH]."""
    base_lr = cfg.OPTIM.LR
    max_epoch = cfg.OPTIM.MAX_EPOCH
    name = cfg.OPTIM.LR_SCHEDULER
    warmup_epoch = cfg.OPTIM.WARMUP_EPOCH
    stepsize = cfg.OPTIM.STEPSIZE
    gamma = cfg.OPTIM.GAMMA

    def main_lr(epoch):
        if name == "cosine":
            return base_lr * 0.5 * (1.0 + math.cos(
                math.pi * epoch / max_epoch))
        if name == "single_step":
            # Dassl single_step takes the LAST list element
            ss = stepsize[-1] if isinstance(stepsize, (tuple, list)) \
                else stepsize
            return base_lr if ss <= 0 else base_lr * gamma ** (epoch // ss)
        if name == "multi_step":
            return base_lr * gamma ** sum(1 for s in stepsize if epoch >= s)
        if name == "constant":
            return base_lr
        raise ValueError(f"Unknown LR scheduler: {name}")

    table = []
    for e in range(max_epoch + 1):
        if warmup_epoch > 0 and e < warmup_epoch:
            if cfg.OPTIM.WARMUP_TYPE == "constant":
                table.append(cfg.OPTIM.WARMUP_CONS_LR)
            else:
                # Dassl LinearWarmupScheduler: min_lr at epoch 0, then
                # base_lr * e / warmup (no min_lr offset)
                table.append(cfg.OPTIM.WARMUP_MIN_LR if e == 0
                             else base_lr * e / warmup_epoch)
        else:
            # Dassl's warmup wrapper steps the inner scheduler lazily: the
            # first post-warmup epoch uses index 1, so the decay curve is
            # shifted by warmup_epoch - 1
            shift = warmup_epoch - 1 if warmup_epoch > 0 else 0
            table.append(main_lr(e - shift))
    steps_per_epoch = max(steps_per_epoch, 1)

    def schedule(step: int) -> float:
        return table[min(max(step // steps_per_epoch, 0), max_epoch)]

    return schedule


def build_optimizer(cfg, params: List[torch.Tensor]) -> torch.optim.Optimizer:
    """The torch optimizer of ``cfg.OPTIM.NAME`` over ``params`` (lr set
    per step by the trainer from the schedule)."""
    name = cfg.OPTIM.NAME
    wd = cfg.OPTIM.WEIGHT_DECAY
    betas = (cfg.OPTIM.ADAM_BETA1, cfg.OPTIM.ADAM_BETA2)
    if name == "sgd":
        momentum = cfg.OPTIM.MOMENTUM
        return torch.optim.SGD(params, lr=0.0, momentum=momentum,
                               dampening=0.0, weight_decay=wd,
                               nesterov=bool(momentum
                                             and cfg.OPTIM.SGD_NESTEROV))
    if name == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=betas, eps=1e-8,
                                weight_decay=wd)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=0.0, betas=betas, eps=1e-8,
                                 weight_decay=wd)
    raise ValueError(f"Unknown optimizer: {name}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def sorted_leaves(params: Dict[str, object]) -> List[torch.Tensor]:
    """Tensors of a nested dict in jax.tree.leaves order (sorted keys)."""
    out = []
    for k in sorted(params):
        v = params[k]
        out.extend(sorted_leaves(v) if isinstance(v, dict) else [v])
    return out


def opt_state_leaves(cfg, optimizer: torch.optim.Optimizer,
                     params: Dict[str, object], step: int
                     ) -> List[torch.Tensor]:
    """The optimizer's state as the leaves of the matching optax state,
    in its order: sgd [momentum buffers..., count] (no buffers without
    momentum); adam/adamw [count, first moments..., second moments...,
    count]. Counts are int32, buffers in their parameter's dtype."""
    leaves = sorted_leaves(params)
    count = torch.tensor(step, dtype=torch.int32)

    def buf(p, key):
        t = optimizer.state.get(p, {}).get(key)
        return (torch.zeros_like(p) if t is None else t).detach().cpu()

    if cfg.OPTIM.NAME == "sgd":
        bufs = ([buf(p, "momentum_buffer") for p in leaves]
                if cfg.OPTIM.MOMENTUM else [])
        return bufs + [count]
    return ([count] + [buf(p, "exp_avg") for p in leaves]
            + [buf(p, "exp_avg_sq") for p in leaves] + [count])


def load_opt_state_leaves(cfg, optimizer: torch.optim.Optimizer,
                          params: Dict[str, object],
                          saved: List[object]) -> int:
    """Inverse of ``opt_state_leaves``: set the optimizer's state from
    optax-ordered leaves; returns the step count. Raises ValueError when
    the leaves do not fit this optimizer."""
    leaves = sorted_leaves(params)
    if len(saved) != len(opt_state_leaves(cfg, optimizer, params, 0)):
        raise ValueError(f"{len(saved)} optimizer leaves do not fit "
                         f"{cfg.OPTIM.NAME} over {len(leaves)} parameters")
    saved = [torch.as_tensor(s) for s in saved]

    def like(p, t):
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"optimizer leaf shape {tuple(t.shape)} != "
                             f"parameter {tuple(p.shape)}")
        return t.detach().to(p.device, p.dtype).clone()

    n = len(leaves)
    if cfg.OPTIM.NAME == "sgd":
        if cfg.OPTIM.MOMENTUM:
            for p, t in zip(leaves, saved[:n]):
                optimizer.state[p]["momentum_buffer"] = like(p, t)
        return int(saved[-1])
    step = int(saved[0])
    for p, mu, nu in zip(leaves, saved[1:1 + n], saved[1 + n:1 + 2 * n]):
        optimizer.state[p].update(
            step=torch.tensor(float(step)), exp_avg=like(p, mu),
            exp_avg_sq=like(p, nu))
    return step
