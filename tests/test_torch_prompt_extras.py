"""The rest of the prompt-trainer slice against the JAX package: the
context assembly (every class-token position, shared and class-specific
contexts), PromptSRC's Gaussian prompt aggregation, ParameterizedTempScaling
(``pts_log_scale`` and a fit), TaskRes's ImageNet-A/R residual subset, and
``TRAINER.QUANT_FROZEN_VISION`` on the vision-prompt trainers. fp32 on the
CPU, inputs from numpy seeds."""

import filecmp
import os.path as osp
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, osp.dirname(osp.abspath(__file__)))
from test_torch_prompt_trainers import (TRAINERS, _assert_state_equal,  # noqa
                                        _numpy, build_pair)
from test_torch_training import ATOL, RTOL, _opts, _port_trainer  # noqa

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
NPZ = osp.join(REPO, "tests", "fixtures", "golden_e2e", "weights",
               "ViT-Test.npz")


# -------------------------------------------------------- context assembly

@pytest.fixture(scope="module")
def towers():
    from clip_calibration_tpu.models import weights as JW
    from clip_calibration_tpu_torch.models import clip as TM
    from clip_calibration_tpu_torch.models import weights as TW
    jparams = JW.load_params(NPZ)
    model = TW.params_from_numpy(JW.flatten_params(jparams),
                                 TM.PRESETS["ViT-Test"], torch.float32,
                                 "cpu")
    return jparams, model


POSITIONS = [(p, csc) for p in ("end", "middle", "front")
             for csc in (False, True)]


@pytest.mark.parametrize("position,csc", POSITIONS,
                         ids=[f"{p}-{'csc' if c else 'shared'}"
                              for p, c in POSITIONS])
def test_context_assembly_and_its_gradient_match_jax(towers, position,
                                                     csc):
    """The prompt rows and d sum(rows * w) / d ctx: the port writes the
    context into the rows (its gradient a gather), the JAX package
    gathers it (its gradient a scatter-add)."""
    from clip_calibration_tpu.trainers import coop as JC
    from clip_calibration_tpu_torch.trainers import coop as TC
    jparams, model = towers
    names = ["amber", "basalt rock", "sea green glass pattern", "x"]
    n_ctx = 5  # odd: "middle" splits it 2 / 3
    jasm = JC.build_prompt_assembly(names, n_ctx, position, "", jparams,
                                    jnp.float32)
    tasm = TC.build_prompt_assembly(names, n_ctx, position, "", model,
                                    torch.float32)
    rng = np.random.default_rng(0)
    shape = (len(names), n_ctx, 64) if csc else (n_ctx, 64)
    ctx = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((len(names), 77, 64)).astype(np.float32)

    def jloss(c):
        return jnp.sum(JC.assemble_prompts(c, jasm) * jnp.asarray(w))

    want_rows = JC.assemble_prompts(jnp.asarray(ctx), jasm)
    want_grad = jax.grad(jloss)(jnp.asarray(ctx))
    c = torch.from_numpy(ctx).requires_grad_()
    rows = TC.assemble_prompts(c, tasm)
    (rows * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(rows.detach().numpy(),
                                  np.asarray(want_rows))
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-6, atol=1e-6)


def _backward_nodes(t):
    seen, stack = set(), [t.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        stack.extend(f for f, _ in fn.next_functions)
    return {type(f).__name__ for f in seen}


@pytest.mark.parametrize("name", ["CoOp", "KgCoOp", "PromptSRC", "MaPLe"])
def test_text_prompt_losses_run_no_accumulating_index(name, tmp_path):
    """No indexed read in a train step's graph: its backward is an
    index_put with accumulate, PyTorch's sorting
    indexing_backward_kernel on the card. The context is written into
    the prompts (an index_put, whose backward is a gather) and the EOT
    rows are pooled by torch.gather (a scatter-add backward)."""
    ov = _opts(**TRAINERS[name][1]) if name in TRAINERS else _opts()
    t = _port_trainer(name, tmp_path / "data", tmp_path / "out", ov)
    batch = next(iter(t.train_loader_x))
    nodes = _backward_nodes(t._loss(batch["img"],
                                    torch.as_tensor(batch["label"])))
    assert "IndexBackward0" not in nodes
    assert {"IndexPutBackward0", "GatherBackward0"} <= nodes


# ------------------------------------------------------------- PromptSRC

def test_promptsrc_aggregated_prompts_after_two_epochs_match_jax(tmp_path):
    """Two epochs of one step each: after the last, the prompts are the
    Gaussian-weighted sum, written into the same tensors the optimizer
    holds, and the last checkpoint has them."""
    from clip_calibration_tpu.trainers.promptsrc import gpa_schedule as JG
    from clip_calibration_tpu_torch.engine.checkpoint import load_checkpoint
    from clip_calibration_tpu_torch.trainers.promptsrc import gpa_schedule
    overrides = _opts(**{**TRAINERS["PromptSRC"][1],
                         "OPTIM.MAX_EPOCH": 2,
                         "TRAINER.PROMPTSRC.GPA_MEAN": 2,
                         "TRAINER.PROMPTSRC.GPA_STD": 1})
    jt, pt = build_pair(tmp_path, "PromptSRC", overrides)
    np.testing.assert_allclose(pt.gauss, JG(2, 2, 1), rtol=1e-12)
    np.testing.assert_allclose(gpa_schedule(50, 30, 30), JG(50, 30, 30),
                               rtol=1e-12)
    live = dict(pt.model_params("prompt_learner"))
    optim = pt.optimizer("prompt_learner")
    rng = np.random.default_rng(3)
    batch = {"img": rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8),
             "label": rng.integers(0, jt.num_classes, 8).astype(np.int32)}
    seen = []
    for epoch in range(2):
        jt.epoch = pt.epoch = epoch
        jt.forward_backward(dict(batch))
        pt.forward_backward(dict(batch))
        seen.append(_numpy(pt.model_params("prompt_learner")))
        jt.after_epoch()
        pt.after_epoch()
    _assert_state_equal(jt, pt, "prompt_learner")
    params = pt.model_params("prompt_learner")
    w = JG(2, 2, 1)
    for k, v in params.items():
        assert v is live[k]  # replaced in place
        np.testing.assert_allclose(v.detach().numpy(),
                                   w[0] * seen[0][k] + w[1] * seen[1][k],
                                   rtol=1e-6, atol=1e-7)
    assert {id(p) for g in optim.param_groups for p in g["params"]} == \
        {id(v) for v in params.values()}
    saved = load_checkpoint(str(tmp_path / "port" / "prompt_learner" /
                                "model.pth.tar-2"))["state_dict"]
    for k, v in params.items():
        torch.testing.assert_close(saved[k], v.detach(), rtol=0, atol=0)


# ------------------------------------------------- ParameterizedTempScaling

@pytest.mark.parametrize("n_cls,n_layers", [(12, 2), (6, 2), (12, 1),
                                            (10, 3)])
def test_pts_log_scale_and_gradient_match_jax(n_cls, n_layers):
    """``pts_log_scale`` on the same tensors (more classes than k = 10,
    fewer: padded with the row minimum, exactly k), and the gradient of
    the scaled cross-entropy w.r.t. every PTS tensor."""
    from clip_calibration_tpu.trainers.calibration import (
        parameterized_tempscaling as JP)
    from clip_calibration_tpu_torch.trainers.calibration import (
        parameterized_tempscaling as TP)
    jparams = JP.init_pts_params(10, 5, n_layers, 4.6052, seed=2)
    # a larger output layer than the init's, so the MLP matters
    jparams["w_out"] = jparams["w_out"] * 100
    rng = np.random.default_rng(n_cls)
    cos = rng.uniform(-0.3, 0.4, (16, n_cls)).astype(np.float32)
    labels = rng.integers(0, n_cls, 16)

    def jloss(p):
        s = JP.pts_log_scale(p, jnp.asarray(cos))
        logits = jnp.exp(s)[:, None] * jnp.asarray(cos)
        lse = jax.nn.logsumexp(logits, axis=-1)
        return jnp.mean(lse - logits[jnp.arange(16), labels])

    tparams = {k: torch.from_numpy(np.array(v)).requires_grad_()
               for k, v in jparams.items()}
    s = TP.pts_log_scale(tparams, torch.from_numpy(cos))
    np.testing.assert_allclose(
        s.detach().numpy(), np.asarray(JP.pts_log_scale(
            jparams, jnp.asarray(cos))), rtol=1e-6, atol=1e-6)
    logits = torch.exp(s)[:, None] * torch.from_numpy(cos)
    torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(labels)).backward()
    want = jax.grad(jloss)(jparams)
    for k, g in want.items():
        got = tparams[k].grad
        if got is None:  # the empty stack of mid layers (n_layers 1)
            assert np.asarray(g).size == 0
            continue
        np.testing.assert_allclose(got.numpy(), np.asarray(g), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    shapes = {k: tuple(v.shape) for k, v in TP.init_pts_params(
        10, 5, n_layers, 4.6052, seed=2).items()}
    assert shapes == {k: tuple(v.shape) for k, v in jparams.items()}


def test_pts_fit_matches_jax(tmp_path):
    """ParameterizedTempScaling over the same CoOp base: the same val
    batches through both for three epochs (the cached cosine logits
    replayed from epoch 2), then the same PTS tensors and the same
    calibrated logits."""
    overrides = _opts(**{"CALIBRATION.SCALING.BASE_LEARNER": "CoOp",
                         "DATASET.NUM_SHOTS": 4})
    jt, pt = build_pair(tmp_path, "ParameterizedTempScaling", overrides)
    # carry the base learner's context across too
    pt.base._set_params("prompt_learner", _numpy(
        jt.base.model_params("prompt_learner")))
    pt.base._cached_text_features = None
    pt._base_fingerprint = pt._fingerprint_base()
    batches = list(jt.val_loader)
    assert len(batches) >= 1
    before = _numpy(pt.model_params("scale_learner"))
    for _ in range(3):
        for b in batches:
            jt.forward_backward(dict(b))
            pt.forward_backward(dict(b))
    moved = max(np.abs(np.asarray(v) - before[k]).max()
                for k, v in jt.model_params("scale_learner").items())
    assert moved > 1e-4
    _assert_state_equal(jt, pt, "scale_learner")
    want = np.asarray(jt.model_inference(batches[0]["img"])[0])
    with torch.inference_mode():
        got = pt.model_inference(batches[0]["img"])[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------------- TaskRes

def test_taskres_index_asset_is_the_jax_packages():
    assert filecmp.cmp(
        osp.join(REPO, "clip_calibration_tpu", "assets",
                 "imagenet_a_r_indexes.json"),
        osp.join(REPO, "clip_calibration_tpu_torch", "assets",
                 "imagenet_a_r_indexes.json"), shallow=False)


def test_taskres_enhanced_base_matches_jax(tmp_path):
    """TRAINER.TaskRes.ENHANCED_BASE: the frozen base text features
    through a text projection loaded from an npz, in its own precision;
    the tower's own projection stays."""
    proj = np.random.default_rng(5).standard_normal((64, 32)).astype(
        np.float32) * 0.1
    np.savez(tmp_path / "enhanced.npz", text_projection=proj)
    overrides = _opts(**{**TRAINERS["TaskRes"][1],
                         "TRAINER.TaskRes.ENHANCED_BASE":
                         str(tmp_path / "enhanced.npz")})
    jt, pt = build_pair(tmp_path, "TaskRes", overrides)
    np.testing.assert_allclose(pt.base_text_features.numpy(),
                               np.asarray(jt.base_text_features),
                               rtol=1e-5, atol=1e-6)
    assert not np.allclose(pt.clip_model.text.text_projection.numpy(), proj)


@pytest.mark.parametrize("dataset", ["ImageNetA", "ImageNetR"])
def test_taskres_subsets_imagenet_residual_as_jax(dataset):
    from clip_calibration_tpu.trainers.taskres import TaskRes as JT
    from clip_calibration_tpu_torch.config import get_cfg_default
    from clip_calibration_tpu_torch.trainers.taskres import TaskRes
    res = np.random.default_rng(0).standard_normal((1000, 8)).astype(
        np.float32)
    got = {}

    class Stub:
        pass

    for cls in (JT, TaskRes):
        t = cls.__new__(cls)
        t.cfg = get_cfg_default()
        t.cfg.DATASET.NAME = dataset
        seen = {}
        base = cls.__mro__[1]
        # what reaches the engine's merge
        orig = base._set_params
        base._set_params = lambda self, name, loaded: seen.update(loaded)
        try:
            t._set_params("taskres_learner", {"residual": res})
        finally:
            base._set_params = orig
        got[cls.__module__.split(".")[0]] = np.asarray(seen["residual"])
    assert got["clip_calibration_tpu_torch"].shape == (200, 8)
    np.testing.assert_array_equal(got["clip_calibration_tpu_torch"],
                                  got["clip_calibration_tpu"])


# ------------------------------------------- TRAINER.QUANT_FROZEN_VISION

@pytest.mark.parametrize("name", ["VPT", "MaPLe", "PromptSRC"])
def test_quant_frozen_vision_raises_for_vision_prompt_trainers(name,
                                                               tmp_path):
    with pytest.raises(ValueError, match="vision-side prompts"):
        _port_trainer(name, tmp_path / "data", tmp_path / "out",
                      _opts(**TRAINERS[name][1],
                            **{"TRAINER.QUANT_FROZEN_VISION": "int8"}))


@pytest.mark.parametrize("name", ["KgCoOp", "CLIP_Adapter", "TaskRes"])
def test_quant_frozen_vision_runs_for_frozen_tower_trainers(name,
                                                            tmp_path):
    """int8 frozen tower: built, and a train step runs on it."""
    t = _port_trainer(name, tmp_path / "data", tmp_path / "out",
                      _opts(**TRAINERS[name][1],
                            **{"TRAINER.QUANT_FROZEN_VISION": "int8"}))
    assert t._step_clip_params is not None
    assert t.step_clip_params is not t.clip_model
    out = t.forward_backward(next(iter(t.train_loader_x)))
    assert torch.isfinite(out["loss"])
