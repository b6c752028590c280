"""The port's training slice against the JAX package: the fused attention
backward (K2's plain version), the autograd Function around K1/K2, the
optimizers and LR schedule, one CoOp train step, checkpoints with
optimizer state moving between the packages, resume, and the
deterministic train loader.

Both sides get the same numpy inputs. The JAX Pallas backward runs in
interpret mode, as its own tests run it; the port's wrappers run their
plain versions (CPU tensors). The CUDA kernels themselves are held to the
plain versions on the card by chip_smoke.py.
"""

import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_calibration_tpu.ops import pallas_attention as PA
from clip_calibration_tpu_torch.ops.mha_qkv import (
    mha_qkv, mha_qkv_bwd, mha_qkv_bwd_reference, mha_qkv_reference)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
NEG = float(np.finfo(np.float32).min)

# the JAX suite's gradient tolerances (tests/test_pallas_attention.py)
RTOL, ATOL = 2e-4, 2e-5


def _mask(L, kind, real=None):
    """The towers' masks: causal and/or pad (padded keys masked, padded
    rows pinned to key 0), or none."""
    real = L if real is None else real
    m = np.zeros((L, L), np.float32)
    if "causal" in kind:
        m[:real, :real] = np.triu(np.full((real, real), NEG, np.float32), 1)
    if "pad" in kind:
        m[:, real:] = NEG
        m[real:, :] = NEG
        m[real:, 0] = 0.0
    return m


def _inputs(seed, B, L, D):
    rng = np.random.default_rng(seed)
    qkv = (rng.standard_normal((B, L, 3 * D)) * 0.3).astype(np.float32)
    g = rng.standard_normal((B, L, D)).astype(np.float32)
    return qkv, g


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ K2

K2_CASES = [  # (L, mask kind, real length)
    (16, "causal", None), (32, "pad", 25), (32, "causal+pad", 26),
    (16, "none", None), (208, "pad", 197), (208, "causal", None),
    (13, "causal", None),  # L off the multiple of 16
]


@pytest.mark.parametrize("L,kind,real", K2_CASES,
                         ids=[f"{L}-{k}" for L, k, _ in K2_CASES])
def test_plain_k2_matches_jax_kernel(L, kind, real):
    B, H, D = 2, 4, 64
    qkv, g = _inputs(0, B, L, D)
    mask = _mask(L, kind, real)
    want, dmask = PA._bwd(H, True, (jnp.asarray(qkv), jnp.asarray(mask)),
                          jnp.asarray(g))
    got = mha_qkv_bwd(_t(qkv), _t(mask), _t(g), H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert not np.asarray(dmask).any()  # the mask's gradient is zero


@pytest.mark.parametrize("L,kind,real", [(32, "causal+pad", 26),
                                         (208, "none", None)])
def test_plain_k2_matches_jax_einsum_backward(L, kind, real):
    B, H, D = 2, 4, 64
    qkv, g = _inputs(1, B, L, D)
    mask = _mask(L, kind, real)
    want = PA._xla_bwd(jnp.asarray(qkv), jnp.asarray(mask), jnp.asarray(g),
                       H)
    got = mha_qkv_bwd_reference(_t(qkv), _t(mask), _t(g), H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_plain_k2_bf16_matches_jax_kernel():
    """bf16 in and out. Both sides scale q in bf16, keep scores, softmax
    and ds in fp32 and round P and ds to bf16 before the products that
    use them; the fp32 sums before those roundings run in different
    orders, so a rounding may flip by one bf16 ulp (2^-8 relative) and
    the outputs differ by a few ulps: rtol=atol=2e-2."""
    B, H, D, L = 2, 4, 64, 32
    qkv, g = _inputs(2, B, L, D)
    mask = _mask(L, "causal+pad", 26)
    want, _ = PA._bwd(H, True, (jnp.asarray(qkv, jnp.bfloat16),
                                jnp.asarray(mask)),
                      jnp.asarray(g, jnp.bfloat16))
    got = mha_qkv_bwd(_t(qkv).bfloat16(), _t(mask), _t(g).bfloat16(), H)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_plain_k2_padded_keys_get_zero_gradient():
    B, H, D, L, real = 2, 4, 64, 32, 20
    qkv, g = _inputs(3, B, L, D)
    got = mha_qkv_bwd(_t(qkv), _t(_mask(L, "causal+pad", real)), _t(g), H)
    assert torch.isfinite(got).all()
    assert not got[:, real:, D:].any()  # dk and dv of padded keys


@pytest.mark.parametrize("kind", ["causal", "pad"])
def test_function_gradient_matches_jax_grad(kind):
    """d sum(mha_qkv(qkv)^2) / d qkv: the port's autograd Function (plain
    versions on the CPU) vs jax.grad through the interpret-mode Pallas
    kernel with its custom VJP, and vs torch autograd through the plain
    forward."""
    B, H, D, L = 2, 4, 64, 32
    qkv, _ = _inputs(4, B, L, D)
    mask = _mask(L, kind, 26)

    def jax_loss(x):
        return jnp.sum(PA.pallas_mha_qkv(x, jnp.asarray(mask), H, True) ** 2)

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(qkv)))
    x = _t(qkv).requires_grad_()
    (mha_qkv(x, _t(mask), H) ** 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=RTOL, atol=ATOL)
    y = _t(qkv).requires_grad_()
    (mha_qkv_reference(y, _t(mask), H) ** 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_cpu_backward_does_not_count_launches():
    mha_qkv_bwd.launches = 0
    qkv, g = _inputs(5, 1, 16, 64)
    x = _t(qkv).requires_grad_()
    mha_qkv(x, _t(_mask(16, "causal")), 4).backward(_t(g))
    assert mha_qkv_bwd.launches == 0 and x.grad is not None


@pytest.mark.parametrize("case", ["g_dtype", "g_shape", "g_noncontiguous"])
def test_bwd_wrapper_rejects_what_the_kernel_does_not_take(case):
    qkv, g = _inputs(6, 2, 16, 64)
    qkv, g, mask = _t(qkv), _t(g), _t(_mask(16, "none"))
    if case == "g_dtype":
        g = g.double()
    elif case == "g_shape":
        g = g[:, :8]
    else:
        g = g.transpose(0, 1)
    with pytest.raises(ValueError):
        mha_qkv_bwd(qkv, mask, g, 4)


# ----------------------------------------------------- optimizer, schedule

def _cfg(pkg, **optim):
    if pkg == "jax":
        from clip_calibration_tpu.config import get_cfg_default
    else:
        from clip_calibration_tpu_torch.config import get_cfg_default
    cfg = get_cfg_default()
    for k, v in optim.items():
        setattr(cfg.OPTIM, k, v)
    return cfg


def test_schedule_matches_jax_every_step():
    from clip_calibration_tpu.engine.optim import build_lr_schedule as JS
    from clip_calibration_tpu_torch.engine.optim import build_lr_schedule
    kw = dict(LR=0.002, MAX_EPOCH=20, LR_SCHEDULER="cosine", WARMUP_EPOCH=1,
              WARMUP_TYPE="constant", WARMUP_CONS_LR=1e-5)
    want = JS(_cfg("jax", **kw), 7)
    got = build_lr_schedule(_cfg("torch", **kw), 7)
    steps = np.arange(20 * 7 + 10)  # past the end too: clipped
    np.testing.assert_allclose([got(int(s)) for s in steps],
                               np.asarray(jax.vmap(want)(steps)),
                               rtol=1e-6)


# sgd: the same fp32 operations, rtol 1e-6. adam/adamw: optax forms the
# bias correction 1 - b2^t in fp32, where 1 - 0.999 keeps four digits
# (1.3e-5 relative), torch in float64: rtol 5e-5 on the params.
@pytest.mark.parametrize("name,nesterov,rtol", [
    ("sgd", False, 1e-6), ("sgd", True, 1e-6), ("adam", False, 5e-5),
    ("adamw", False, 5e-5)])
def test_optimizer_trajectory_and_state_match_optax(name, nesterov, rtol):
    """Three steps on three gradients at a changing lr: the same params,
    and the torch state written as optax's leaves equals optax's state."""
    import optax
    from clip_calibration_tpu.engine.optim import build_optimizer as JB
    from clip_calibration_tpu_torch.engine.optim import (
        build_lr_schedule, build_optimizer, opt_state_leaves, set_lr)
    kw = dict(NAME=name, LR=0.1, MOMENTUM=0.9, WEIGHT_DECAY=0.01,
              SGD_NESTEROV=nesterov, LR_SCHEDULER="cosine", MAX_EPOCH=3,
              WARMUP_EPOCH=-1)
    w0 = np.array([[1.0, -2.0, 0.5], [0.3, 0.0, -0.7]], np.float32)
    grads = [(np.full_like(w0, 0.1) * np.arange(1, 4)).astype(np.float32),
             np.array([[-0.05, 0.1, 0.2], [0.4, -0.3, 0.0]], np.float32),
             np.array([[0.2, -0.1, 0.0], [0.0, 0.05, 0.1]], np.float32)]

    opt, _ = JB(_cfg("jax", **kw), steps_per_epoch=1)
    p = {"w": jnp.asarray(w0)}
    state = opt.init(p)
    for gr in grads:
        updates, state = opt.update({"w": jnp.asarray(gr)}, state, p)
        p = optax.apply_updates(p, updates)

    cfg = _cfg("torch", **kw)
    w = torch.tensor(w0, requires_grad=True)
    topt = build_optimizer(cfg, [w])
    sched = build_lr_schedule(cfg, 1)
    for step, gr in enumerate(grads):
        w.grad = torch.tensor(gr)
        set_lr(topt, sched(step))
        topt.step()
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(p["w"]),
                               rtol=rtol, atol=1e-7)
    leaves = opt_state_leaves(cfg, topt, {"w": w}, len(grads))
    want = jax.tree.leaves(state)
    assert len(leaves) == len(want)
    for got, ref in zip(leaves, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-7)


# ------------------------------------------------------- CoOp train step

def _opts(**kw):
    base = {"DATASET.NUM_SHOTS": 1, "MODEL.PRECISION": "fp32",
            "TRAINER.COOP.PREC": "fp32", "TRAINER.COOP.N_CTX": 4,
            "DATASET.SUBSAMPLE_CLASSES": "base", "OPTIM.NAME": "sgd",
            "OPTIM.LR": 0.02, "OPTIM.MAX_EPOCH": 3,
            "OPTIM.LR_SCHEDULER": "cosine", "OPTIM.WARMUP_EPOCH": 1,
            "OPTIM.WARMUP_TYPE": "constant", "OPTIM.WARMUP_CONS_LR": 1e-5,
            "DATALOADER.TRAIN_X.BATCH_SIZE": 8, "DATALOADER.NUM_WORKERS": 2,
            "TEST.NO_TEST": True}
    base.update(kw)
    return base


def _port_trainer(name, data_root, output_dir, overrides, seed=1):
    """The port's registered trainer over the Synthetic dataset on the
    ViT-Test backbone, configured as tests/helpers.py configures the JAX
    package's."""
    from clip_calibration_tpu_torch.config import get_cfg_default
    from clip_calibration_tpu_torch.data.base import set_random_seed
    from clip_calibration_tpu_torch.engine.registry import TRAINER_REGISTRY
    from clip_calibration_tpu_torch.ops.preprocess import (CLIP_PIXEL_MEAN,
                                                           CLIP_PIXEL_STD)
    import clip_calibration_tpu_torch.data.datasets  # noqa: F401
    import clip_calibration_tpu_torch.evaluators.vl_evaluator  # noqa: F401
    import clip_calibration_tpu_torch.trainers  # noqa: F401
    cfg = get_cfg_default()
    cfg.TEST.EVALUATOR = "VLClassification"
    cfg.DATASET.NAME = "Synthetic"
    cfg.DATASET.ROOT = str(data_root)
    cfg.SEED = seed
    cfg.OUTPUT_DIR = str(output_dir)
    cfg.MODEL.BACKBONE.NAME = "ViT-Test"
    cfg.INPUT.SIZE = (32, 32)
    cfg.INPUT.PIXEL_MEAN = list(CLIP_PIXEL_MEAN)
    cfg.INPUT.PIXEL_STD = list(CLIP_PIXEL_STD)
    cfg.INPUT.TRANSFORMS = ("random_resized_crop", "random_flip",
                            "normalize")
    cfg.TRAINER.NAME = name
    for key, v in overrides.items():
        node = cfg
        *parts, last = key.split(".")
        for p in parts:
            node = getattr(node, p)
        setattr(node, last, v)
    set_random_seed(seed)
    return TRAINER_REGISTRY.get(name)(cfg, device="cpu")


@pytest.fixture(scope="module")
def coop_pair(tmp_path_factory):
    """A JAX and a port CoOp trainer on the same ViT-Test weights (a
    seeded random init written in the native npz format both packages
    read: the golden fixture's weights give every class the same logit,
    and so a zero context gradient), the port's context set to the JAX
    one, and one batch."""
    import os
    import sys
    from clip_calibration_tpu_torch.models.clip import (CLIP, PRESETS,
                                                        init_clip)
    from clip_calibration_tpu_torch.models.weights import save_params
    sys.path.insert(0, osp.join(REPO, "tests"))
    from helpers import build_synthetic_trainer
    root = tmp_path_factory.mktemp("coop_pair")
    save_params(str(root / "weights" / "ViT-Test.npz"), init_clip(
        CLIP(PRESETS["ViT-Test"], torch.float32, "cpu"), 0))
    old = os.environ.get("CLIP_CHECKPOINT_DIR")
    os.environ["CLIP_CHECKPOINT_DIR"] = str(root / "weights")
    try:
        ov = _opts()
        jt = build_synthetic_trainer("CoOp", root / "data",
                                     output_dir=root / "jax", num_shots=1,
                                     overrides=ov)
        pt = _port_trainer("CoOp", root / "data", root / "port", ov)
    finally:
        if old is None:
            os.environ.pop("CLIP_CHECKPOINT_DIR")
        else:
            os.environ["CLIP_CHECKPOINT_DIR"] = old
    assert len(jt.train_loader_x) == len(pt.train_loader_x) == 1
    with torch.no_grad():
        pt.model_params("prompt_learner")["ctx"].copy_(_t(np.asarray(
            jt.model_params("prompt_learner")["ctx"])))
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, jt.num_classes, 8).astype(np.int32)
    return jt, pt, images, labels


def test_coop_loss_and_ctx_gradient_match_jax(coop_pair):
    jt, pt, images, labels = coop_pair
    loss, grads = jax.value_and_grad(jt._loss)(
        jt.model_params("prompt_learner"), jt.step_clip_params,
        jnp.asarray(images), jnp.asarray(labels))
    ctx = pt.model_params("prompt_learner")["ctx"]
    ctx.grad = None
    got = pt._loss(_t(images), _t(labels))
    got.backward()
    assert np.abs(np.asarray(grads["ctx"])).max() > 1e-3  # not degenerate
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    np.testing.assert_allclose(ctx.grad.numpy(), np.asarray(grads["ctx"]),
                               rtol=RTOL, atol=1e-6)
    ctx.grad = None


def test_coop_three_sgd_steps_match_jax(coop_pair):
    """Three train steps at the shipped schedule (one step an epoch:
    warmup lr 1e-5, then the cosine from 0.02): the same context."""
    jt, pt, images, labels = coop_pair
    batch = {"img": images, "label": labels}
    ctx0 = np.asarray(jt.model_params("prompt_learner")["ctx"])
    for _ in range(3):
        jt.forward_backward(dict(batch))
        pt.forward_backward(dict(batch))
    assert pt._models["prompt_learner"]["step"] == 3
    moved = np.abs(np.asarray(jt.model_params("prompt_learner")["ctx"])
                   - ctx0).max()
    assert moved > 1e-4  # the cosine lr of steps 2 and 3 moved it
    np.testing.assert_allclose(
        pt.model_params("prompt_learner")["ctx"].detach().numpy(),
        np.asarray(jt.model_params("prompt_learner")["ctx"]), rtol=RTOL,
        atol=1e-6)


def test_forward_backward_runs_after_build_model(tmp_path):
    """The towers are built under no_grad, not inference_mode, so a train
    step can save their tensors for backward."""
    t = _port_trainer("CoOp", tmp_path / "data", tmp_path / "out",
                      _opts(**{"MODEL.PRECISION": "bf16",
                               "TRAINER.COOP.PREC": "fp16"}))
    assert not t.clip_model.logit_scale.is_inference()
    # the optimizer is built at its first use: eval-only runs build none
    assert t._models["prompt_learner"]["optim"] is None
    batch = next(iter(t.train_loader_x))
    ctx = t.model_params("prompt_learner")["ctx"]
    before = ctx.detach().clone()
    t.optimizer("prompt_learner").zero_grad()
    t._loss(batch["img"], t.put_batch(batch["label"])).backward()
    assert torch.isfinite(ctx.grad).all() and ctx.grad.abs().max() > 0
    out = t.forward_backward(batch)
    assert torch.isfinite(out["loss"]) and not torch.equal(ctx, before)


# ------------------------------------------------- checkpoints and resume

def test_stopped_and_resumed_run_ends_where_an_uninterrupted_one_does(
        tmp_path):
    """CoOp, 2 epochs: stopped after epoch 1 and resumed in a new trainer
    (params, momentum, schedule position) vs straight through."""
    from clip_calibration_tpu_torch.engine.checkpoint import load_checkpoint
    ov = _opts(**{"DATASET.NUM_SHOTS": 4, "OPTIM.MAX_EPOCH": 2,
                  "TRAIN.CHECKPOINT_FREQ": 1})
    straight = _port_trainer("CoOp", tmp_path / "data", tmp_path / "a", ov)
    straight.train()
    first = _port_trainer("CoOp", tmp_path / "data", tmp_path / "b", ov)
    first.max_epoch = 1  # stop after epoch 1
    first.train()
    assert first._models["prompt_learner"]["step"] == len(
        first.train_loader_x) > 1
    resumed = _port_trainer("CoOp", tmp_path / "data", tmp_path / "b", ov)
    resumed.train()
    assert resumed.start_epoch == 1
    want = load_checkpoint(str(tmp_path / "a" / "prompt_learner" /
                               "model.pth.tar-2"))
    got = load_checkpoint(str(tmp_path / "b" / "prompt_learner" /
                              "model.pth.tar-2"))
    torch.testing.assert_close(got["state_dict"]["ctx"],
                               want["state_dict"]["ctx"], rtol=0, atol=0)
    for g, w in zip(got["opt_leaves"], want["opt_leaves"]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_jax_checkpoint_with_sgd_state_resumes_in_port(coop_pair,
                                                       tmp_path):
    jt, pt, images, labels = coop_pair
    batch = {"img": images, "label": labels}
    jt.forward_backward(dict(batch))
    jt.save_model(0, str(tmp_path))
    pt.resume_model_if_exist(str(tmp_path))
    slot = pt._models["prompt_learner"]
    ctx = slot["params"]["ctx"]
    trace, count = jax.tree.leaves(jt._models["prompt_learner"]
                                   ["opt_state"])
    assert slot["step"] == int(count) and pt.start_epoch == 1
    np.testing.assert_array_equal(
        ctx.detach().numpy(),
        np.asarray(jt.model_params("prompt_learner")["ctx"]))
    np.testing.assert_array_equal(
        pt.optimizer("prompt_learner").state[ctx]["momentum_buffer"].numpy(),
        np.asarray(trace))
    # and the next step agrees
    jt.forward_backward(dict(batch))
    pt.forward_backward(dict(batch))
    np.testing.assert_allclose(
        ctx.detach().numpy(),
        np.asarray(jt.model_params("prompt_learner")["ctx"]), rtol=RTOL,
        atol=1e-6)


def test_port_checkpoint_with_sgd_state_resumes_in_jax(coop_pair, tmp_path):
    jt, pt, images, labels = coop_pair
    pt.forward_backward({"img": images, "label": labels})
    pt.save_model(0, str(tmp_path))
    jt.resume_model_if_exist(str(tmp_path))
    slot = pt._models["prompt_learner"]
    ctx = slot["params"]["ctx"]
    trace, count = jax.tree.leaves(jt._models["prompt_learner"]
                                   ["opt_state"])
    assert int(count) == slot["step"] and jt.start_epoch == 1
    np.testing.assert_array_equal(
        np.asarray(jt.model_params("prompt_learner")["ctx"]),
        ctx.detach().numpy())
    np.testing.assert_array_equal(
        np.asarray(trace),
        pt.optimizer("prompt_learner").state[ctx]["momentum_buffer"])


def test_resume_skips_corrupt_checkpoint(tmp_path):
    """A run killed mid-save leaves a truncated checkpoint; auto-resume
    starts fresh instead of crashing (twin of
    tests/test_scripts_resume.py::test_resume_skips_corrupt_checkpoint)."""
    from clip_calibration_tpu_torch.engine.trainer import TrainerX
    t = TrainerX.__new__(TrainerX)
    t._models = {}
    t.register_model("m", {"w": torch.zeros(3)})
    t.start_epoch = 0
    d = tmp_path / "m"
    d.mkdir()
    (d / "model.pth.tar-3").write_bytes(b"truncated-garbage")
    t.resume_model_if_exist(str(tmp_path))
    assert t.start_epoch == 0


# ------------------------------------------------------------ the loader

def test_train_batches_do_not_depend_on_worker_count(tmp_path):
    """The repaired fault: each item's crop and flip come from its own
    generator, so 1 and 8 worker threads give the same bytes."""
    from clip_calibration_tpu_torch.data.loader import DataLoader
    from clip_calibration_tpu_torch.data.transforms import build_transform
    t = _port_trainer("CoOp", tmp_path / "data", tmp_path / "out",
                      _opts(**{"DATASET.NUM_SHOTS": 8}))
    src = t.train_loader_x.data_source
    tfm = build_transform(t.cfg, is_train=True)

    def epoch(workers, e):
        loader = DataLoader(src, 8, tfm, is_train=True,
                            num_workers=workers, seed=1)
        loader.set_epoch(e)
        return [b["img"].tobytes() for b in loader]

    one = epoch(1, 3)
    assert len(one) == len(src) // 8 > 1
    assert epoch(8, 3) == one
    assert epoch(8, 4) != one  # a new epoch draws anew


def test_train_transform_needs_its_generator(tmp_path):
    from PIL import Image
    from clip_calibration_tpu_torch.config import get_cfg_default
    from clip_calibration_tpu_torch.data.transforms import build_transform
    import random
    cfg = get_cfg_default()
    cfg.INPUT.SIZE = (32, 32)
    cfg.INPUT.TRANSFORMS = ("random_resized_crop", "random_flip")
    img = Image.fromarray(np.random.default_rng(0).integers(
        0, 256, (48, 40, 3), dtype=np.uint8))
    with pytest.raises(ValueError):
        build_transform(cfg, is_train=True)(img)
    a = build_transform(cfg, is_train=True)(img, random.Random(5))
    b = build_transform(cfg, is_train=True)(img, random.Random(5))
    assert a.shape == (32, 32, 3) and np.array_equal(a, b)
    assert build_transform(cfg, is_train=False)(img).shape == (32, 32, 3)


# ----------------------------------------------------------- TempScaling

def test_scaling_epochs_replay_cached_cos(tmp_path, monkeypatch):
    """Twin of tests/test_tempscaling.py::
    test_scaling_epochs_replay_cached_cos: from epoch 2 the scaling loop
    replays the cached cosine logits (zero image decodes) with the same
    temperature trajectory as iterating the val loader every epoch."""
    import clip_calibration_tpu_torch.data.loader as L
    from clip_calibration_tpu_torch.trainers.calibration import tempscaling

    def run(force_no_replay):
        if force_no_replay:
            monkeypatch.setattr(tempscaling._CachedCosReplay, "replaying",
                                property(lambda self: False))
        else:
            monkeypatch.undo()
        t = _port_trainer(
            "TempScaling", tmp_path / ("d1" if force_no_replay else "d0"),
            tmp_path / "out",
            _opts(**{"CALIBRATION.SCALING.BASE_LEARNER": "CoOp",
                     "DATASET.NUM_SHOTS": 4,
                     "DATALOADER.DECODE_CACHE_MB": 0}))
        calls = []
        real = L._load_image
        monkeypatch.setattr(L, "_load_image",
                            lambda p, d=0: calls.append(p) or real(p, d))
        temps = []
        for epoch in range(3):
            t.train_loader_x.set_epoch(epoch)
            if epoch == 1:
                calls.clear()
            for batch in t._device_staged(t.train_loader_x):
                t.forward_backward(batch)
            temps.append(float(torch.exp(
                t.model_params("scale_learner")["scale"].detach())))
        return temps, len(calls)

    temps_replay, decodes_after_e1 = run(force_no_replay=False)
    assert decodes_after_e1 == 0
    temps_plain, decodes_plain = run(force_no_replay=True)
    assert decodes_plain > 0
    np.testing.assert_allclose(temps_replay, temps_plain, rtol=1e-7)
    assert temps_replay[-1] != pytest.approx(100.0)  # it trained


def test_tempscaling_cache_bypassed_on_shuffled_loader():
    """Twin of tests/test_scripts_resume.py::
    test_tempscaling_cache_bypassed_on_shuffled_loader."""
    from clip_calibration_tpu_torch.trainers.calibration.tempscaling import (
        TempScaling)
    ts = TempScaling.__new__(TempScaling)
    ts.train_loader_x = object()  # not the val loader
    ts.val_loader = None
    ts._cos_cache = {}
    ts._fingerprint_checked = False
    ts.parse_batch_train = lambda b: (b["img"], b["label"])
    ts._unit_logits = lambda images: (torch.ones((2, 3)), None, None)
    batch = {"img": 0, "label": torch.tensor([0, 1]), "n_real": 2,
             "impath": ["a", "b"]}
    cos, labels = ts._cached_cos(batch)
    assert tuple(cos.shape) == (2, 3) and ts._cos_cache == {}
