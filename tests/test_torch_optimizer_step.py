"""``engine/trainer.py::optimizer_step`` on one rank against optax: a
trainable that gets no gradient in a step is still stepped (weight decay,
momentum, Adam's moments), as optax updates every leaf and as the mesh run
does, where ``reduce_trainable_grads`` joins its zeros to the
collectives.

The same numpy values go through the JAX package's optimizer (two steps;
the unused leaf's gradient is zeros) and through the port's trainer
engine (two backward passes of a loss that leaves the unused leaf out,
so its ``.grad`` is None after ``zero_grad(set_to_none=True)``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from test_torch_training import _cfg

# sgd: the same fp32 operations; adamw: optax's fp32 bias correction
# against the port's float64 one (tests/test_torch_training.py)
CASES = [("sgd", 1e-6), ("adamw", 5e-5)]


def _jax_steps(name, w, grads):
    from clip_calibration_tpu.engine.optim import build_optimizer
    opt, _ = build_optimizer(_cfg("jax", **_optim(name)), steps_per_epoch=1)
    p = {k: jnp.asarray(v) for k, v in w.items()}
    state = opt.init(p)
    for g in grads:
        updates, state = opt.update(
            {"used": jnp.asarray(g), "unused": jnp.zeros_like(p["unused"])},
            state, p)
        p = optax.apply_updates(p, updates)
    return {k: np.asarray(v) for k, v in p.items()}


def _optim(name):
    return dict(NAME=name, LR=0.1, MOMENTUM=0.9, WEIGHT_DECAY=0.05,
                SGD_NESTEROV=False, LR_SCHEDULER="cosine", MAX_EPOCH=3,
                WARMUP_EPOCH=-1)


@pytest.mark.parametrize("name,rtol", CASES)
def test_trainable_left_out_of_the_loss_is_stepped_as_optax(name, rtol):
    from clip_calibration_tpu_torch.engine.optim import (build_lr_schedule,
                                                         build_optimizer,
                                                         sorted_leaves)
    from clip_calibration_tpu_torch.engine.trainer import TrainerX
    rng = np.random.default_rng(3)
    w = {k: rng.standard_normal((2, 3)).astype(np.float32)
         for k in ("used", "unused")}
    grads = [rng.standard_normal((2, 3)).astype(np.float32)
             for _ in range(2)]

    cfg = _cfg("torch", **_optim(name))
    params = {k: torch.tensor(v, requires_grad=True) for k, v in w.items()}
    t = TrainerX.__new__(TrainerX)
    t._models, t._mesh = {}, None
    t.register_model("m", params,
                     lambda: build_optimizer(cfg, sorted_leaves(params)),
                     build_lr_schedule(cfg, 1))
    for g in grads:
        t.optimizer("m").zero_grad(set_to_none=True)
        (params["used"] * torch.tensor(g)).sum().backward()
        assert params["unused"].grad is None
        t.optimizer_step("m")

    want = _jax_steps(name, w, grads)
    assert not np.allclose(want["unused"], w["unused"])
    for k in ("used", "unused"):
        np.testing.assert_allclose(params[k].detach().numpy(), want[k],
                                   rtol=rtol, atol=1e-7, err_msg=k)
