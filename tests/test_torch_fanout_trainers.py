"""The port's text fan-out trainers against the JAX package's: CoCoOp,
ProGrad and ProDA.

For each, a JAX and a port trainer are built on the same ViT-Test weights
(a seeded init in the native npz format both read), the port's trainable
tensors set to the JAX ones, and one batch of 8 images goes through both:
the loss (rtol 1e-5) and every trainable's gradient at step 0 (ProGrad:
both of its gradients and the projected one), the state after 3 SGD
steps, the checkpoints resuming across the packages with their optimizer
state, and the reference-format state both ways. Then ProGrad's
projection, ProDA's prompt assembly, merged tower call and
``set_classifier``, and the checkpointed fan-outs against plain ones.
fp32 on the CPU: the port's attention runs its plain version, the JAX one
as its suite runs it. Gradient tolerances are PR 8's
(tests/test_torch_training.py: rtol 2e-4, atol 2e-5).
"""

import inspect
import os
import os.path as osp
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, osp.dirname(osp.abspath(__file__)))
from test_torch_prompt_trainers import _opt_leaves, _weights  # noqa: E402
from test_torch_training import ATOL, RTOL, _opts, _port_trainer  # noqa: E402

from clip_calibration_tpu_torch.engine.checkpoint import (  # noqa: E402
    flatten_params)

SLOT = "prompt_learner"
TRAINERS = {
    "CoCoOp": {"TRAINER.COCOOP.PREC": "fp32", "TRAINER.COCOOP.N_CTX": 4},
    # CTX_INIT True: the Synthetic template's 6 words in the last 6 of 8
    # zero-initialized slots (reference prograd.py:88-105)
    "ProGrad": {"TRAINER.PROGRAD.PREC": "fp32", "TRAINER.PROGRAD.N_CTX": 8,
                "TRAINER.PROGRAD.CTX_INIT": True},
    "ProDA": {"TRAINER.PRODA.PREC": "fp32", "TRAINER.PRODA.N_CTX": 4,
              "TRAINER.PRODA.N_PROMPT": 4, "TRAINER.PRODA.PROMPT_BS": 2},
}
# ProDA's prompt minibatch for the step-0 comparison
PRODA_IDX = np.array([3, 0])


def _flat(params):
    return {k: np.array(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in flatten_params(params).items()}


def _set_port(pt, jt):
    from clip_calibration_tpu_torch.engine.checkpoint import unflatten_params
    pt._set_params(SLOT, unflatten_params(_flat(jt.model_params(SLOT))))


def build_pair(root, name, overrides, seed=1):
    """(JAX trainer, port trainer) on the same weights, the port's
    trainables set to the JAX ones."""
    from helpers import build_synthetic_trainer
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
    _set_port(pt, jt)
    return jt, pt


def _batch(jt):
    rng = np.random.default_rng(7)
    return (rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8),
            rng.integers(0, jt.num_classes, 8).astype(np.int32))


@pytest.fixture(scope="module", params=list(TRAINERS))
def pair(request, tmp_path_factory):
    name = request.param
    jt, pt = build_pair(tmp_path_factory.mktemp(name), name,
                        _opts(**TRAINERS[name]))
    assert len(jt.train_loader_x) == len(pt.train_loader_x) == 1
    if name == "CoCoOp":
        # ViT-Test's meta-net has 2 hidden units, both ReLUs dead at init
        # on this batch: lift their bias so every meta-net leaf is reached
        p = jt._models[SLOT]["params"]
        p["meta"] = dict(p["meta"], b1=jnp.full_like(p["meta"]["b1"], 0.5))
        _set_port(pt, jt)
    return (name, jt, pt) + _batch(jt)


def _jax_loss_fn(jt):
    return inspect.getclosurevars(
        jt._train_step.__wrapped__).nonlocals["loss_fn"]


def _port_grads(pt, loss):
    params = pt.model_params(SLOT)
    leaves = [t for t in flatten_params(params).values()]
    grads = torch.autograd.grad(loss, leaves)
    return dict(zip(flatten_params(params), (g.numpy() for g in grads)))


def _assert_grads(got, want):
    want = {k: np.asarray(v) for k, v in flatten_params(want).items()}
    assert sorted(got) == sorted(want)
    for k, g in want.items():
        assert np.abs(g).max() > 1e-5, k  # every trainable is reached
        np.testing.assert_allclose(got[k], g, rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_loss_and_gradients_match_jax(pair):
    name, jt, pt, images, labels = pair
    frozen = jt.step_clip_params
    trainable = jt.model_params(SLOT)
    ji, jl = jnp.asarray(images), jnp.asarray(labels)
    tl = torch.from_numpy(labels)
    if name == "ProGrad":
        from clip_calibration_tpu.trainers.prograd import (
            prograd_project as jax_project)
        from clip_calibration_tpu_torch.trainers.prograd import (
            prograd_project)
        (xe, kl), vjp_fn = jax.vjp(
            lambda tr: jt._losses(tr, frozen, ji, jl), trainable)
        g_ce, = vjp_fn((jnp.ones(()), jnp.zeros(())))
        g_kl, = vjp_fn((jnp.zeros(()), jnp.ones(())))
        pxe, pkl = pt._losses(images, tl)
        np.testing.assert_allclose(float(pxe.detach()), float(xe),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(pkl.detach()), float(kl),
                                   rtol=1e-5)
        ctx = pt.model_params(SLOT)["ctx"]
        ce, = torch.autograd.grad(pxe, [ctx], retain_graph=True)
        kd, = torch.autograd.grad(pkl, [ctx])
        _assert_grads({"ctx": ce.numpy()}, g_ce)
        _assert_grads({"ctx": kd.numpy()}, g_kl)
        proj = prograd_project({"ctx": ce}, {"ctx": kd}, pt.lambda_)
        _assert_grads({"ctx": proj["ctx"].numpy()},
                      jax_project(g_ce, g_kl, jt.lambda_))
        return
    args = (trainable, frozen, ji, jl) + (
        (jnp.asarray(PRODA_IDX),) if name == "ProDA" else ())
    loss, grads = jax.value_and_grad(_jax_loss_fn(jt))(*args)
    extra = (PRODA_IDX,) if name == "ProDA" else ()
    got = pt._loss(images, tl, *extra)
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    _assert_grads(_port_grads(pt, got), grads)


def _sync_prompt_batches(jt, pt):
    """ProDA's prompt permutation is host state in neither package's
    checkpoints: give the port the JAX trainer's."""
    if hasattr(jt, "_perm_rng"):
        import copy
        pt._perm_rng = copy.deepcopy(jt._perm_rng)
        pt._perm = None if jt._perm is None else np.array(jt._perm)
        pt._iter_idx = jt._iter_idx


def test_three_steps_match_jax(pair):
    """Three train steps at the shipped schedule (one step an epoch)."""
    name, jt, pt, images, labels = pair
    batch = {"img": images, "label": labels}
    before = _flat(jt.model_params(SLOT))
    _sync_prompt_batches(jt, pt)
    for _ in range(3):
        jt.forward_backward(dict(batch))
        pt.forward_backward(dict(batch))
    moved = max(np.abs(v - before[k]).max()
                for k, v in _flat(jt.model_params(SLOT)).items())
    assert moved > 1e-5
    _assert_flat_equal(jt, pt)


def _assert_flat_equal(jt, pt, rtol=RTOL, atol=1e-6):
    want, got = _flat(jt.model_params(SLOT)), _flat(pt.model_params(SLOT))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def test_jax_checkpoint_resumes_in_port(pair, tmp_path):
    name, jt, pt, images, labels = pair
    batch = {"img": images, "label": labels}
    jt.forward_backward(dict(batch))
    jt.save_model(0, str(tmp_path))
    pt.resume_model_if_exist(str(tmp_path))
    assert pt.start_epoch == 1
    _assert_flat_equal(jt, pt, rtol=0, atol=0)
    want = jax.tree.leaves(jt._models[SLOT]["opt_state"])
    got = _opt_leaves(pt, SLOT)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # and the next step agrees
    _sync_prompt_batches(jt, pt)
    jt.forward_backward(dict(batch))
    pt.forward_backward(dict(batch))
    _assert_flat_equal(jt, pt)


def test_port_checkpoint_resumes_in_jax(pair, tmp_path):
    name, jt, pt, images, labels = pair
    pt.forward_backward({"img": images, "label": labels})
    pt.save_model(0, str(tmp_path))
    jt.resume_model_if_exist(str(tmp_path))
    assert jt.start_epoch == 1
    _assert_flat_equal(jt, pt, rtol=0, atol=0)
    want = _opt_leaves(pt, SLOT)
    got = jax.tree.leaves(jt._models[SLOT]["opt_state"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_reference_state_both_ways(pair):
    """The port's reference-format state equals the JAX package's (CoCoOp:
    ``meta_net.linear{1,2}`` in torch's [out, in] layout) and converts
    back to the port's own."""
    name, jt, pt, _, _ = pair
    state = pt.model_params(SLOT)
    ref = flatten_params(pt.convert_to_reference_state(SLOT, state))
    want = flatten_params(jax.tree.map(
        np.asarray, jt.convert_to_reference_state(SLOT,
                                                   jt.model_params(SLOT))))
    assert sorted(ref) == sorted(want)
    if name == "CoCoOp":
        assert "meta_net/linear1/weight" in ref
    for k in want:
        np.testing.assert_array_equal(np.asarray(ref[k].detach()), want[k],
                                      err_msg=k)
    back = flatten_params(pt.convert_reference_state(
        SLOT, pt.convert_to_reference_state(SLOT, state)))
    for k, v in flatten_params(state).items():
        torch.testing.assert_close(torch.as_tensor(back[k]), v.detach(),
                                   rtol=0, atol=0)


def test_exported_reference_checkpoint_loads_in_jax(pair, tmp_path):
    name, jt, pt, images, labels = pair
    pt.forward_backward({"img": images, "label": labels})
    pt.save_model(0, str(tmp_path / "native"))
    pt.export_reference_checkpoint(str(tmp_path / "native"),
                                   str(tmp_path / "ref"), epoch=1)
    jt.load_model(str(tmp_path / "ref"), epoch=1)
    _assert_flat_equal(jt, pt, rtol=0, atol=0)
    pt.load_model(str(tmp_path / "ref"), epoch=1)
    _assert_flat_equal(jt, pt, rtol=0, atol=0)


# ------------------------------------------------------------- ProGrad

@pytest.mark.parametrize("sign", [-1.0, 1.0], ids=["conflict", "agree"])
def test_prograd_project_matches_jax(sign):
    """Conflicting gradients lose their component along the KL direction;
    agreeing ones pass unchanged."""
    from clip_calibration_tpu.trainers.prograd import (
        prograd_project as jax_project)
    from clip_calibration_tpu_torch.trainers.prograd import prograd_project
    rng = np.random.default_rng(int(sign > 0))
    g_kl = {"ctx": rng.standard_normal((4, 8)).astype(np.float32),
            "b": rng.standard_normal((3,)).astype(np.float32)}
    g_ce = {k: (sign * v + 0.3 * rng.standard_normal(v.shape)
                ).astype(np.float32) for k, v in g_kl.items()}
    want = jax_project({k: jnp.asarray(v) for k, v in g_ce.items()},
                       {k: jnp.asarray(v) for k, v in g_kl.items()}, 0.7)
    got = prograd_project({k: torch.from_numpy(v) for k, v in g_ce.items()},
                          {k: torch.from_numpy(v) for k, v in g_kl.items()},
                          0.7)
    for k in g_ce:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
        cos = float((got[k] * torch.from_numpy(g_kl[k])).sum())
        if sign < 0:  # the conflict is gone: orthogonal at lambda 1 only
            assert not np.allclose(got[k].numpy(), g_ce[k])
        else:
            np.testing.assert_array_equal(got[k].numpy(), g_ce[k])
            assert cos > 0


# ------------------------------------------------------------- ProDA

@pytest.fixture(scope="module")
def proda(tmp_path_factory):
    jt, pt = build_pair(tmp_path_factory.mktemp("proda_extra"), "ProDA",
                        _opts(**TRAINERS["ProDA"]))
    return jt, pt


def test_proda_assembly_matches_jax(proda):
    """Every prompt's rows in its own position variant (front, middle,
    end), the context written where the JAX gather + select puts it."""
    jt, pt = proda
    ctx = np.asarray(jt.model_params(SLOT)["ctx"])
    for idx in ([0, 1, 2, 3], [3, 1]):
        want = np.asarray(jt._assemble(jnp.asarray(ctx)[np.asarray(idx)],
                                       jt.pos[np.asarray(idx)]))
        got = pt._assemble(torch.from_numpy(ctx[idx]), pt.pos[idx],
                           pt.seq_len)
        np.testing.assert_array_equal(got.numpy(),
                                      want[:, :, :pt.seq_len])
    assert sorted(set(pt.pos.tolist())) == [0, 1, 2]


def test_proda_merged_tower_call_equals_separate(proda):
    """The class-free rows appended to the fan-out (at their longer
    sequence length) give the features of two separate encodes."""
    from clip_calibration_tpu_torch.models import clip as M
    _, pt = proda
    ctx = pt.model_params(SLOT)["ctx"].detach()
    nc = pt.nc_embedding[None].expand(4, *pt.nc_embedding.shape)
    nc = torch.cat([nc[:, :1], ctx, nc[:, 1 + pt.n_ctx:]], dim=1)
    # the two row sets' own lengths differ: one set runs longer merged
    assert pt.nc_eot + 1 != pt.seq_len
    with torch.no_grad():
        tf, nc_f = pt._text_features_all(ctx[:2], pt.pos[:2],
                                         pt.clip_model, extra_rows=nc,
                                         extra_eots=[pt.nc_eot] * 4)
        alone = pt._text_features_all(ctx[:2], pt.pos[:2], pt.clip_model)
        nc_alone = M.normalize(M.encode_text_embedded(
            pt.clip_model, pt.clip_cfg, nc,
            torch.full((4,), pt.nc_eot), seq_len=pt.nc_eot + 1))
    np.testing.assert_allclose(tf.numpy(), alone.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(nc_f.numpy(), nc_alone.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_proda_set_classifier_matches_jax(proda):
    jt, pt = proda
    jt.set_classifier()
    pt.set_classifier()
    np.testing.assert_allclose(pt.text_features.numpy(),
                               np.asarray(jt.text_features), rtol=1e-5,
                               atol=1e-6)
    images, _ = _batch(jt)
    want = jt.model_inference(images)
    with torch.inference_mode():
        got = pt.model_inference(images)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4)
    # a train step makes the classifier stale in both
    batch = {"img": images, "label": np.zeros(8, np.int32)}
    pt.forward_backward(dict(batch))
    assert pt.text_features is None


# ------------------------------------------- checkpointed fan-outs

def test_cocoop_checkpointed_chunks_match_plain(tmp_path, monkeypatch):
    """One image a chunk, each checkpointed (the rule from 512 rows, here
    from 8): bit for bit the same chunks run plain, and within summation
    order of one chunk of all 8 images."""
    from clip_calibration_tpu_torch.trainers import cocoop
    pt = _port_trainer("CoCoOp", tmp_path / "data", tmp_path / "out",
                       _opts(**TRAINERS["CoCoOp"]))
    images, labels = _batch(pt)
    tl = torch.from_numpy(labels)
    one = pt._loss(images, tl)
    one_grads = _port_grads(pt, one)
    monkeypatch.setattr(cocoop, "_CHUNK_TARGET_ROWS", 8)
    assert pt.num_classes > 4  # 8 // n_cls: one image a chunk
    calls = []
    real = cocoop.checkpoint

    def counted(fn, *args, **kwargs):
        calls.append(1)
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(cocoop, "checkpoint", lambda fn, *a, **k: fn(*a))
    plain = pt._loss(images, tl)
    want = _port_grads(pt, plain)
    monkeypatch.setattr(cocoop, "checkpoint", counted)
    chunked = pt._loss(images, tl)
    got = _port_grads(pt, chunked)
    assert len(calls) == 8  # one checkpointed chunk an image
    np.testing.assert_array_equal(chunked.detach().numpy(),
                                  plain.detach().numpy())
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_allclose(got[k], one_grads[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(chunked.detach()), float(one.detach()),
                               rtol=1e-6)


def test_proda_remat_tower_matches_plain(tmp_path, monkeypatch):
    """The fan-out with every text layer checkpointed (the rule from 512
    rows, here from 1) against the plain tower: the same gradient."""
    from clip_calibration_tpu_torch.models import clip as M
    from clip_calibration_tpu_torch.trainers import proda
    pt = _port_trainer("ProDA", tmp_path / "data", tmp_path / "out",
                       _opts(**TRAINERS["ProDA"]))
    images, labels = _batch(pt)
    tl = torch.from_numpy(labels)
    plain = pt._loss(images, tl, PRODA_IDX)
    want = _port_grads(pt, plain)
    monkeypatch.setattr(proda, "_REMAT_MIN_TEXT_ROWS", 1)
    forwards = M.transformer.forwards
    remat = pt._loss(images, tl, PRODA_IDX)
    got = _port_grads(pt, remat)
    assert M.transformer.forwards == forwards + 2  # vision, one text call
    np.testing.assert_array_equal(remat.detach().numpy(),
                                  plain.detach().numpy())
    np.testing.assert_array_equal(got["ctx"], want["ctx"])


def test_remat_text_encode_matches_plain_gradients():
    """``encode_text_embedded(remat=True)`` against JAX's ``remat=True``
    (tests/test_clip_model.py's case): same features and gradients."""
    from clip_calibration_tpu.models import clip as JM
    from clip_calibration_tpu_torch.models import clip as TM
    from clip_calibration_tpu_torch.models.weights import params_from_numpy
    from test_torch_resnet import jax_flat
    cfg = JM.PRESETS["ViT-Test"]
    params = JM.init_clip(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    model = params_from_numpy(jax_flat(params), TM.PRESETS["ViT-Test"],
                              torch.float32, "cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 77, 64)).astype(np.float32) * 0.02
    eot = np.array([5, 9, 3, 12, 7, 4])
    w = rng.standard_normal((6, 32)).astype(np.float32)

    def jloss(v):
        return jnp.sum(JM.encode_text_embedded(
            params, cfg, v, jnp.asarray(eot), remat=True, seq_len=13)
            * jnp.asarray(w))

    want = jax.grad(jloss)(jnp.asarray(x))
    grads = []
    for remat in (True, False):
        xt = torch.from_numpy(x).requires_grad_()
        out = TM.encode_text_embedded(model, TM.PRESETS["ViT-Test"], xt,
                                      torch.from_numpy(eot), seq_len=13,
                                      remat=remat)
        (out * torch.from_numpy(w)).sum().backward()
        grads.append(xt.grad.numpy())
    np.testing.assert_array_equal(grads[0], grads[1])
    np.testing.assert_allclose(grads[0], np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# ------------------------------------------------- no accumulating index

def _backward_nodes(t):
    seen, stack = set(), [t.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        stack.extend(f for f, _ in fn.next_functions)
    return {type(f).__name__ for f in seen}


@pytest.mark.parametrize("name,want", [
    ("CoCoOp", {"CatBackward0", "GatherBackward0"}),
    ("ProGrad", {"IndexPutBackward0", "GatherBackward0"}),
    ("ProDA", {"IndexPutBackward0", "IndexSelectBackward0",
               "GatherBackward0"})])
def test_fanout_losses_run_no_accumulating_index(name, want, tmp_path):
    """No indexed read in a train step's graph (its backward is PyTorch's
    sorting ``indexing_backward_kernel`` on the card): the prompts are
    concatenations or index_put writes, the minibatch and label rows
    ``index_select``s, the EOT rows and label logits ``torch.gather``s."""
    t = _port_trainer(name, tmp_path / "data", tmp_path / "out",
                      _opts(**TRAINERS[name]))
    batch = next(iter(t.train_loader_x))
    labels = torch.as_tensor(batch["label"])
    if name == "ProGrad":
        xe, kl = t._losses(batch["img"], labels)
        loss = xe + kl
    elif name == "ProDA":
        loss = t._loss(batch["img"], labels, PRODA_IDX)
    else:
        loss = t._loss(batch["img"], labels)
    nodes = _backward_nodes(loss)
    assert "IndexBackward0" not in nodes
    assert want <= nodes
