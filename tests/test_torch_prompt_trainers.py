"""The port's prompt trainers against the JAX package's: KgCoOp,
CLIP-Adapter, VPT, TaskRes, PromptSRC and MaPLe.

For each, a JAX and a port trainer are built on the same ViT-Test weights
(a seeded init written in the native npz format both read), the port's
trainable tensors are set to the JAX ones (carried across), and one batch
of 8 images goes through both: the loss and every trainable's gradient at
step 0, the state after 3 SGD steps (Adam for TaskRes, as its config), the
checkpoints resuming across the packages with their optimizer state, and
the reference-format state both ways. fp32 on the CPU: the port's
attention runs its plain version, the JAX one as its suite runs it.
"""

import inspect
import os
import os.path as osp
import sys

import numpy as np
import pytest
import torch

import jax

sys.path.insert(0, osp.dirname(osp.abspath(__file__)))
from test_torch_training import ATOL, RTOL, _opts, _port_trainer  # noqa: E402

# name -> (registered slot, config overrides, JAX loss takes the fixed
# text features)
TRAINERS = {
    "KgCoOp": ("prompt_learner", {"TRAINER.KGCOOP.PREC": "fp32",
                                  "TRAINER.KGCOOP.CTX_INIT": "a photo of a"},
               False),
    "CLIP_Adapter": ("adapter", {"TRAINER.COOP.PREC": "fp32"}, True),
    # 17 patch tokens + 8 prompts: 25 real rows padded to 32
    "VPT": ("vpt_prompts", {"TRAINER.VPT.PREC": "fp32",
                            "TRAINER.VPT.N_CTX_VISION": 8,
                            "TRAINER.VPT.PROMPT_DEPTH_VISION": 2}, True),
    "TaskRes": ("taskres_learner", {"TRAINER.TaskRes.PREC": "fp32",
                                    "OPTIM.NAME": "adam",
                                    "OPTIM.LR": 0.002}, False),
    "PromptSRC": ("prompt_learner", {
        "TRAINER.PROMPTSRC.PREC": "fp32",
        "TRAINER.PROMPTSRC.PROMPT_DEPTH_VISION": 2,
        "TRAINER.PROMPTSRC.PROMPT_DEPTH_TEXT": 2,
        "TRAINER.PROMPTSRC.GPA_MEAN": 1, "TRAINER.PROMPTSRC.GPA_STD": 1},
        False),
    "MaPLe": ("prompt_learner", {"TRAINER.MAPLE.PREC": "fp32",
                                 "TRAINER.MAPLE.PROMPT_DEPTH": 2}, False),
}


def _numpy(params):
    """Copies of the tensors (in-place steps must not reach them)."""
    return {k: np.array(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in params.items()}


def _weights(root):
    from clip_calibration_tpu_torch.models.clip import CLIP, PRESETS, init_clip
    from clip_calibration_tpu_torch.models.weights import save_params
    path = root / "weights" / "ViT-Test.npz"
    save_params(str(path), init_clip(
        CLIP(PRESETS["ViT-Test"], torch.float32, "cpu"), 0))
    return str(root / "weights")


def build_pair(root, name, overrides, seed=1):
    """(JAX trainer, port trainer) on the same weights, the port's
    trainables set to the JAX ones."""
    from helpers import build_synthetic_trainer
    slot = TRAINERS[name][0] if name in TRAINERS else "scale_learner"
    old = os.environ.get("CLIP_CHECKPOINT_DIR")
    os.environ["CLIP_CHECKPOINT_DIR"] = _weights(root)
    try:
        jt = build_synthetic_trainer(name, root / "data", seed=seed,
                                     output_dir=root / "jax", num_shots=1,
                                     overrides=overrides)
        pt = _port_trainer(name, root / "data", root / "port", overrides,
                           seed=seed)
    finally:
        if old is None:
            os.environ.pop("CLIP_CHECKPOINT_DIR")
        else:
            os.environ["CLIP_CHECKPOINT_DIR"] = old
    pt._set_params(slot, _numpy(jt.model_params(slot)))
    return jt, pt


@pytest.fixture(scope="module", params=list(TRAINERS))
def pair(request, tmp_path_factory):
    name = request.param
    jt, pt = build_pair(tmp_path_factory.mktemp(name), name,
                        _opts(**TRAINERS[name][1]))
    assert len(jt.train_loader_x) == len(pt.train_loader_x) == 1
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, jt.num_classes, 8).astype(np.int32)
    return name, jt, pt, images, labels


def _jax_value_and_grad(name, jt, images, labels):
    slot, _, text_arg = TRAINERS[name]
    loss_fn = inspect.getclosurevars(
        jt._train_step.__wrapped__).nonlocals["loss_fn"]
    args = ([jt.step_clip_params]
            + ([jt.text_features] if text_arg else [])
            + [jax.numpy.asarray(images), jax.numpy.asarray(labels)])
    return jax.value_and_grad(loss_fn)(jt.model_params(slot), *args)


def _assert_state_equal(jt, pt, slot, rtol=RTOL, atol=1e-6):
    want = _numpy(jt.model_params(slot))
    got = _numpy(pt.model_params(slot))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def test_loss_and_gradients_match_jax(pair):
    name, jt, pt, images, labels = pair
    slot = TRAINERS[name][0]
    loss, grads = _jax_value_and_grad(name, jt, images, labels)
    pt.optimizer(slot).zero_grad(set_to_none=True)
    got = pt._loss(images, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    params = pt.model_params(slot)
    assert sorted(params) == sorted(grads)
    for k, g in grads.items():
        g = np.asarray(g)
        assert np.abs(g).max() > 1e-5, k  # every trainable is reached
        np.testing.assert_allclose(params[k].grad.numpy(), g, rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    pt.optimizer(slot).zero_grad(set_to_none=True)


def test_three_steps_match_jax(pair):
    """Three train steps at the shipped schedule (one step an epoch:
    warmup lr 1e-5, then the cosine from the base lr)."""
    name, jt, pt, images, labels = pair
    slot = TRAINERS[name][0]
    batch = {"img": images, "label": labels}
    before = _numpy(jt.model_params(slot))
    for _ in range(3):
        jt.forward_backward(dict(batch))
        pt.forward_backward(dict(batch))
    moved = max(np.abs(np.asarray(v) - before[k]).max()
                for k, v in jt.model_params(slot).items())
    assert moved > 1e-5
    _assert_state_equal(jt, pt, slot)


def _opt_leaves(pt, slot):
    from clip_calibration_tpu_torch.engine.optim import opt_state_leaves
    s = pt._models[slot]
    return opt_state_leaves(pt.cfg, pt.optimizer(slot), s["params"],
                            s["step"])


def test_jax_checkpoint_resumes_in_port(pair, tmp_path):
    name, jt, pt, images, labels = pair
    slot = TRAINERS[name][0]
    jt.forward_backward({"img": images, "label": labels})
    jt.save_model(0, str(tmp_path))
    pt.resume_model_if_exist(str(tmp_path))
    assert pt.start_epoch == 1
    _assert_state_equal(jt, pt, slot, rtol=0, atol=0)
    want = jax.tree.leaves(jt._models[slot]["opt_state"])
    got = _opt_leaves(pt, slot)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # and the next step agrees
    jt.forward_backward({"img": images, "label": labels})
    pt.forward_backward({"img": images, "label": labels})
    _assert_state_equal(jt, pt, slot)


def test_port_checkpoint_resumes_in_jax(pair, tmp_path):
    name, jt, pt, images, labels = pair
    slot = TRAINERS[name][0]
    pt.forward_backward({"img": images, "label": labels})
    pt.save_model(0, str(tmp_path))
    jt.resume_model_if_exist(str(tmp_path))
    assert jt.start_epoch == 1
    _assert_state_equal(jt, pt, slot, rtol=0, atol=0)
    want = _opt_leaves(pt, slot)
    got = jax.tree.leaves(jt._models[slot]["opt_state"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_reference_state_both_ways(pair):
    """The port's reference-format state equals the JAX package's and
    converts back to the port's own."""
    from clip_calibration_tpu_torch.engine.checkpoint import flatten_params
    name, jt, pt, _, _ = pair
    slot = TRAINERS[name][0]
    state = pt.model_params(slot)
    ref = flatten_params(pt.convert_to_reference_state(slot, state))
    want = jax.tree.map(np.asarray, jt.convert_to_reference_state(
        slot, jt.model_params(slot)))
    want = flatten_params(want)
    assert sorted(ref) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(ref[k].detach()), want[k],
                                   rtol=0, atol=0, err_msg=k)
    back = pt.convert_reference_state(
        slot, pt.convert_to_reference_state(slot, state))
    for k, v in state.items():
        torch.testing.assert_close(torch.as_tensor(back[k]), v.detach(),
                                   rtol=0, atol=0)


def test_exported_reference_checkpoint_loads_in_jax(pair, tmp_path):
    """A port checkpoint exported in the reference's torch layout (under
    the reference's directory name) loads into the JAX trainer."""
    name, jt, pt, images, labels = pair
    slot = TRAINERS[name][0]
    pt.forward_backward({"img": images, "label": labels})
    pt.save_model(0, str(tmp_path / "native"))
    pt.export_reference_checkpoint(str(tmp_path / "native"),
                                   str(tmp_path / "ref"), epoch=1)
    jt.load_model(str(tmp_path / "ref"), epoch=1)
    _assert_state_equal(jt, pt, slot, rtol=0, atol=0)
    # and back into the port
    pt.load_model(str(tmp_path / "ref"), epoch=1)
    _assert_state_equal(jt, pt, slot, rtol=0, atol=0)
