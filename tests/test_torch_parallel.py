"""The port's process meshes (``clip_calibration_tpu_torch/parallel/``)
against one rank and the JAX package: the twin of tests/test_parallel.py.

The JAX tests run on 8 virtual devices of one process; the port runs one
process per device, so here each mesh is a gloo process group of CPU
processes (``tests/torch_parallel_driver.py``): one group of 2 ranks and
one of 4, each running several cases in turn. The same inputs (seeded
numpy arrays, one weight file) go through the mesh, through the port on
one rank (this process, no process group) and through the JAX package.
fp32: the sharded sums run in another order, bounded at rel 2e-5 as
tests/test_parallel.py bounds them; against JAX the port's own
tolerances (tests/test_torch_training.py).

bf16 (the configs' precision; the ``step:`` cases at the end): the
prompt trainers' data-parallel steps, each rank's loss and gradients
held to one rank's and to the JAX package's on a mesh of its virtual
CPU devices. The JAX mesh step sums the text features' fp32 gradient
over the data axis before the bf16 text tower's backward; the port does
it in the same place (``parallel/mesh.py::reduce_data_grad``).
"""

import os
import os.path as osp
import sys

import numpy as np
import pytest
import torch

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, osp.dirname(osp.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_fanout_trainers import (PRODA_IDX, TRAINERS,  # noqa: E402
                                        _batch, _jax_loss_fn, build_pair)
from test_torch_prompt_trainers import (  # noqa: E402
    TRAINERS as PROMPT_TRAINERS)
from test_torch_training import ATOL, RTOL, _opts  # noqa: E402
from torch_parallel_driver import port_trainer, run_ranks  # noqa: E402

# mesh vs one rank, fp32 (tests/test_parallel.py's bound)
MESH_RTOL = MESH_ATOL = 2e-5
TP_PRESET = "ViT-TP-Test"

#: the bf16 trainers (MODEL.PRECISION bf16, PREC fp16 as the published
#: configs): key -> (trainer, its overrides beside ``_opts``'), at the
#: fp32 tests' sizes
BF16 = {
    "bf16_coop": ("CoOp", {}),
    "bf16_prograd": ("ProGrad", TRAINERS["ProGrad"]),
    "bf16_kgcoop": ("KgCoOp", PROMPT_TRAINERS["KgCoOp"][1]),
    "bf16_promptsrc": ("PromptSRC", PROMPT_TRAINERS["PromptSRC"][1]),
    "bf16_maple": ("MaPLe", PROMPT_TRAINERS["MaPLe"][1]),
    "bf16_proda": ("ProDA", TRAINERS["ProDA"]),
    "bf16_vpt": ("VPT", PROMPT_TRAINERS["VPT"][1]),
    "bf16_clip_adapter": ("CLIP_Adapter", {}),
    "bf16_taskres": ("TaskRes", PROMPT_TRAINERS["TaskRes"][1]),
}
#: (rank group, driver case): the data-parallel steps on (2, 1), CoOp
#: also on (4, 1), ProDA on (2, 2) (data x class-sharded)
BF16_CASES = [
    ("two", "step:bf16_coop@2,1"), ("four", "step:bf16_coop@4,1"),
    ("two", "step:bf16_prograd@2,1"), ("two", "step:bf16_kgcoop@2,1"),
    ("two", "step:bf16_promptsrc@2,1"), ("two", "step:bf16_maple@2,1"),
    ("four", "step:bf16_proda@2,2"), ("two", "step:bf16_vpt@2,1"),
    ("two", "step:bf16_clip_adapter@2,1"),
    ("two", "step:bf16_taskres@2,1")]
#: the bf16 mesh step against one rank: loss |diff| / |one rank|, and
#: every gradient's max |diff| / max |one rank|. With the text features'
#: gradient summed over the data ranks before the text tower's backward
#: the text side's leaves come out equal (0.0 on this batch); each rank
#: backpropagating its own part instead puts them 8.3e-3 (KgCoOp) to
#: 6.2e-2 (ProGrad's projection) apart
BF16_MESH_LOSS_RTOL = 1e-5
BF16_MESH_GRAD_RTOL = 1e-3
#: the recorded gaps between a bf16 mesh step and one device's that are
#: larger than the fp32 summation order's, by (key, leaf): (the JAX
#: package's, the port's), max |diff| / max |one device|. The leaves an
#: image side reaches: each device runs the vision tower's bf16 backward
#: on its own rows, in both packages (the port's gap is the smaller on
#: each). ProDA's (2, 2): its model axis sums partial gradients of bf16
#: towers, in both. CLIP-Adapter's head: the port rounds each rank's
#: weight gradient to bf16 before the fp32 average, the JAX package on
#: the CPU does not (a recorded deviation, ROADMAP.md §3)
MESH_GAP = {
    ("bf16_promptsrc", "vpt_shallow"): (4.26e-3, 2.16e-3),
    ("bf16_promptsrc", "deep_vis"): (4.63e-3, 2.30e-3),
    ("bf16_maple", "ctx"): (1.16e-4, 5.73e-5),
    ("bf16_maple", "compound_text"): (6.96e-5, 3.45e-5),
    ("bf16_maple", "proj_w"): (4.74e-3, 2.09e-3),
    ("bf16_maple", "proj_b"): (4.89e-3, 1.84e-3),
    ("bf16_maple", "compound_proj_w"): (4.27e-3, 1.74e-3),
    ("bf16_maple", "compound_proj_b"): (4.27e-3, 1.06e-3),
    ("bf16_proda", "ctx"): (3.15e-3, 3.13e-3),
    ("bf16_vpt", "shallow"): (5.59e-3, 4.17e-3),
    ("bf16_vpt", "deep"): (5.46e-3, 2.72e-3),
    ("bf16_clip_adapter", "w1"): (0.0, 2.99e-3),
    ("bf16_clip_adapter", "w2"): (0.0, 3.95e-3),
}
#: the fp32 summation order's gap (every other leaf)
JAX_SUM_ORDER_RTOL = 1e-6
#: the port's bf16 step against the JAX package's, on one device and on
#: a mesh: both round the towers in bf16 at their own points (the
#: features 1-2 bf16 ulps apart), which the loss's cancellations
#: magnify. Measured here: loss 8.1e-3 (CoOp), gradients 8.6e-3
#: (CLIP-Adapter's w1) to 6.7e-2 (ProGrad's projection) and 1.31e-1
#: (CLIP-Adapter's w2)
BF16_JAX_LOSS_RTOL = 2e-2
BF16_JAX_GRAD_RTOL = 0.15


def _bf16_opts(overrides):
    """``_opts`` at bf16: the trainer's PREC fp16 (CoOp's and
    CLIP-Adapter's read TRAINER.COOP.PREC), MODEL.PRECISION bf16."""
    return _opts(**{k: ("fp16" if k.endswith(".PREC") else v)
                    for k, v in overrides.items()},
                 **{"MODEL.PRECISION": "bf16", "TRAINER.COOP.PREC": "fp16"})


def _slot(name):
    return (PROMPT_TRAINERS[name][0] if name in PROMPT_TRAINERS
            else "prompt_learner")


def _jax_trainer(root, name, overrides, weights):
    """The JAX trainer alone, as ``build_pair`` builds it."""
    from helpers import build_synthetic_trainer
    old = os.environ.get("CLIP_CHECKPOINT_DIR")
    os.environ["CLIP_CHECKPOINT_DIR"] = weights
    try:
        return build_synthetic_trainer(name, root / "data", seed=1,
                                       output_dir=root / "jax", num_shots=1,
                                       overrides=overrides)
    finally:
        if old is None:
            os.environ.pop("CLIP_CHECKPOINT_DIR")
        else:
            os.environ["CLIP_CHECKPOINT_DIR"] = old


def _tp_params():
    """The TP tower's seeded JAX init, flat (both packages load it)."""
    from clip_calibration_tpu.models import clip as JM
    from clip_calibration_tpu.models.weights import flatten_params
    from clip_calibration_tpu_torch.parallel.dryrun import TP_CFG
    cfg = JM.CLIPConfig(*[getattr(TP_CFG, f) for f in (
        "embed_dim", "image_resolution", "vision_layers", "vision_width",
        "vision_patch_size", "transformer_width", "transformer_heads",
        "transformer_layers")])
    params = JM.init_clip(jax.random.PRNGKey(2), cfg, dtype=jnp.float32)
    return cfg, params, {k: np.asarray(v)
                         for k, v in flatten_params(params).items()}


def _coop_inputs(jt):
    """The dry run's CoOp problem (seeded numpy): 8 classes, batch 8."""
    rng = np.random.default_rng(11)
    D = 64
    return {"ctx": (rng.standard_normal((2, D)) * 0.02).astype(np.float32),
            "embedding": (rng.standard_normal((8, 77, D)) * 0.01
                          ).astype(np.float32),
            "eot_pos": np.full((8,), 5, np.int64),
            "images": rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8),
            "labels": np.arange(8) % 8, "n_ctx": 2}


class Fixture:
    """Everything the cases compare: the inputs, the JAX trainers and
    their numbers, the port on one rank, and the ranks' results."""


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    from clip_calibration_tpu.models.weights import flatten_params as jflat
    from clip_calibration_tpu_torch.models.weights import (params_from_numpy,
                                                           save_params)
    from clip_calibration_tpu_torch.parallel.dryrun import TP_CFG
    root = tmp_path_factory.mktemp("parallel")
    f = Fixture()
    f.pairs = {}
    specs = {"dp_coop": ("CoOp", _opts()),
             "cocoop": ("CoCoOp", _opts(**TRAINERS["CoCoOp"])),
             "proda": ("ProDA", _opts(**TRAINERS["ProDA"]))}
    for key, (name, overrides) in specs.items():
        jt, pt = build_pair(root, name, overrides)
        if name == "CoCoOp":
            # both meta-net ReLUs are dead at init on this batch (as in
            # test_torch_fanout_trainers.py): lift their bias
            p = jt._models["prompt_learner"]["params"]
            p["meta"] = dict(p["meta"],
                             b1=jnp.full_like(p["meta"]["b1"], 0.5))
            from test_torch_fanout_trainers import _set_port
            _set_port(pt, jt)
        f.pairs[key] = (jt, pt)
    f.weights = osp.join(root, "weights")
    f.images, f.labels = _batch(f.pairs["cocoop"][0])
    f.jax_tp_cfg, f.jax_tp_params, tp_flat = _tp_params()
    save_params(osp.join(f.weights, TP_PRESET + ".npz"),
                params_from_numpy(tp_flat, TP_CFG, torch.float32, "cpu"))
    rng = np.random.default_rng(5)
    f.tp_images = rng.normal(0, 1, (8, 32, 32, 3)).astype(np.float32)
    f.coop = _coop_inputs(None)
    f.classnames = ["cat", "dog", "pelican"]
    f.serve_images = rng.integers(0, 256, (10, 32, 32, 3), dtype=np.uint8)
    f.trainer_images = rng.integers(0, 256, (5, 32, 32, 3), dtype=np.uint8)
    inputs = {
        "data_root": str(root / "data"), "coop": f.coop,
        "tp_params": tp_flat, "tp_images": f.tp_images,
        "classnames": f.classnames, "serve_images": f.serve_images,
        "trainer_images": f.trainer_images, "trainers": {}}
    for key, (name, overrides) in specs.items():
        jt = f.pairs[key][0]
        spec = {"trainer": name, "overrides": overrides,
                "images": f.images, "labels": f.labels,
                "trainables": {k: np.asarray(v) for k, v in jflat(
                    jt.model_params("prompt_learner")).items()}}
        if name == "ProDA":
            spec["prompt_idx"] = PRODA_IDX
        inputs["trainers"][key] = spec
    f.bf16 = {}
    for key, (name, overrides) in BF16.items():
        f.bf16[key] = _jax_trainer(root, name, _bf16_opts(overrides),
                                   f.weights)
        inputs["trainers"][key] = {
            "trainer": name, "overrides": _bf16_opts(overrides),
            "images": f.images, "labels": f.labels,
            "trainables": {k: np.asarray(v) for k, v in jflat(
                f.bf16[key].model_params(_slot(name))).items()},
            **({"prompt_idx": PRODA_IDX} if name == "ProDA" else {})}
    f.inputs = inputs
    steps = {group: [c for g, c in BF16_CASES if g == group]
             for group in ("two", "four")}
    f.two = run_ranks(str(root / "two"), 2, inputs,
                      ["coop_loss@1,2", "cocoop@1,2", "proda@1,2",
                       "tp@1,2", "predictor@1,2", *steps["two"]],
                      f.weights)
    f.four = run_ranks(str(root / "four"), 4, inputs,
                       ["shapes@2,2", "coop_loss@2,2", "dp_coop@4,1",
                        "cocoop@2,2", "proda@2,2", "tp@2,2",
                        "predictor@2,2", "dryrun", *steps["four"]],
                       f.weights)
    return f


def _same_on_every_rank(results, case):
    """The case's results of every rank, held equal; rank 0's."""
    first = results[0][case]

    def eq(a, b, where):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), where
            for k in a:
                eq(a[k], b[k], f"{where}/{k}")
        elif isinstance(a, (tuple, list)) and not (
                a and isinstance(a[0], (int, float))):
            for i, (x, y) in enumerate(zip(a, b)):
                eq(x, y, f"{where}[{i}]")
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=where)
    for r in results[1:]:
        eq(first, r[case], case)
    return first


def _close(got, want, rtol=MESH_RTOL, atol=MESH_ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


# ---------------------------------------------------------------- meshes

def test_make_mesh_shapes_one_rank():
    """Without a process group: one rank on the data axis; a shape whose
    product is not the world size raises (JAX mesh.py:72-73)."""
    from clip_calibration_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh()
    assert mesh.dims == (1, 1) and mesh.shape == {"data": 1, "model": 1}
    assert make_mesh((1,)).dims == (1, 1)
    with pytest.raises(ValueError, match="!= 1 ranks"):
        make_mesh((3, 2))


def test_make_mesh_shapes(fx):
    """Four ranks: the default puts all on the data axis; (2, 2) lays
    them out row-major; (3, 2) raises."""
    for rank, res in enumerate(fx.four):
        r = res["shapes@2,2"]
        assert r["default"] == (4, 1)
        assert r["shape"] == {"data": 2, "model": 2}
        assert r["coords"] == (rank // 2, rank % 2)
        assert r["groups"] == ([i * 2 + rank % 2 for i in range(2)],
                               [(rank // 2) * 2 + j for j in range(2)])
        assert r["data_ranks"] == r["groups"][0]
        assert "(3, 2) != 4 ranks" in r["bad"]


def test_mesh_from_cfg(fx):
    from clip_calibration_tpu_torch.config import get_cfg_default
    from clip_calibration_tpu_torch.parallel.mesh import mesh_from_cfg
    cfg = get_cfg_default()
    assert mesh_from_cfg(cfg).dims == (1, 1)
    for res in fx.four:
        assert res["shapes@2,2"]["cfg"] == {"data": 2, "model": 2}


def test_dryrun_multichip_executes(fx):
    """The dry-run twin on four ranks (a (2, 2) mesh): it holds itself to
    one rank (it raises otherwise); every rank ends with the same
    numbers, and the TP tower ran."""
    r = _same_on_every_rank(fx.four, "dryrun")
    assert r["tp"]
    _close(*r["coop_loss"])
    _close(*r["coop_grad"])


def _jax_coop_loss(fx):
    """The JAX dry run's loss (``__graft_entry__._loss_fn``) at fp32 on
    the same inputs and weights."""
    from clip_calibration_tpu.models import clip as JM
    from clip_calibration_tpu.models.backbone import load_clip_backbone
    from clip_calibration_tpu.ops.preprocess import normalize_images
    import optax
    os.environ["CLIP_CHECKPOINT_DIR"] = fx.weights
    try:
        params, cfg = load_clip_backbone("ViT-Test", "float32")
    finally:
        os.environ.pop("CLIP_CHECKPOINT_DIR")
    c = fx.coop
    n_ctx = c["n_ctx"]

    def loss_fn(ctx):
        emb = jnp.asarray(c["embedding"])
        tiled = jnp.broadcast_to(ctx, (emb.shape[0],) + ctx.shape)
        prompts = jnp.concatenate(
            [emb[:, :1], tiled, emb[:, 1 + n_ctx:]], axis=1)
        txt = JM.encode_text_embedded(params, cfg, prompts,
                                      jnp.asarray(c["eot_pos"]),
                                      seq_len=1 + n_ctx + 3)
        img = JM.encode_image(params, cfg, normalize_images(
            jnp.asarray(c["images"]), dtype=jnp.float32),
            dtype=jnp.float32)
        logits = JM.cosine_logits(img, txt, params["logit_scale"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(c["labels"])).mean()

    return jax.value_and_grad(loss_fn)(jnp.asarray(c["ctx"]))


@pytest.mark.parametrize("group,case", [("two", "coop_loss@1,2"),
                                        ("four", "coop_loss@2,2")])
def test_sharded_vs_single_device_same_loss(fx, group, case):
    """The sharded CoOp step (batch over data, class prompts over model)
    computes the JAX loss and context gradient, and one rank's."""
    from clip_calibration_tpu_torch.models.backbone import load_clip_backbone
    from clip_calibration_tpu_torch.parallel import dryrun as D
    r = _same_on_every_rank(getattr(fx, group), case)
    loss, grad = _jax_coop_loss(fx)
    np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-5)
    _close(r["grad"], np.asarray(grad), rtol=RTOL, atol=ATOL)
    os.environ["CLIP_CHECKPOINT_DIR"] = fx.weights
    try:
        model, cfg = load_clip_backbone("ViT-Test", "float32", "cpu")
    finally:
        os.environ.pop("CLIP_CHECKPOINT_DIR")
    c = {k: torch.as_tensor(v) for k, v in fx.coop.items()}
    loss1, grad1, _ = D.coop_step(c["ctx"], model, cfg, c["embedding"],
                                  c["eot_pos"], c["images"], c["labels"],
                                  2, None)
    _close(r["loss"], float(loss1))
    _close(r["grad"], grad1.numpy())


# ------------------------------------------------------------- trainers

def _jax_numbers(fx, key):
    """JAX trainer on the batch: loss, gradients, logits (ProDA's after
    set_classifier, and its text features), then one step's
    trainables."""
    from clip_calibration_tpu.models.weights import flatten_params
    jt = fx.pairs[key][0]
    ji, jl = jnp.asarray(fx.images), jnp.asarray(fx.labels)
    extra = (jnp.asarray(PRODA_IDX),) if key == "proda" else ()
    loss, grads = jax.value_and_grad(_jax_loss_fn(jt))(
        jt.model_params("prompt_learner"), jt.step_clip_params, ji, jl,
        *extra)
    out = {"loss": float(loss),
           "grads": {k: np.asarray(v) for k, v in
                     flatten_params(grads).items()}}
    if key == "proda":
        jt.set_classifier()
        out["text_features"] = np.asarray(jt.text_features)
        jt._next_prompt_batch = lambda: PRODA_IDX
    logits, _, _ = jt.model_inference(ji)
    out["logits"] = np.asarray(logits)
    jt.forward_backward({"img": fx.images, "label": fx.labels})
    out["trainables"] = {k: np.asarray(v) for k, v in flatten_params(
        jt.model_params("prompt_learner")).items()}
    return out


def _port_one_rank(fx, key):
    """The port on one rank (this process): the same numbers."""
    from clip_calibration_tpu_torch.engine.checkpoint import flatten_params
    from clip_calibration_tpu_torch.parallel import dryrun as D
    pt = fx.pairs[key][1]
    images = torch.as_tensor(fx.images)
    extra = (PRODA_IDX,) if key == "proda" else ()
    out = D.trainer_step_check(pt, images, fx.labels, *extra)
    with torch.no_grad():
        if key == "proda":
            pt.set_classifier()
            out["text_features"] = pt.text_features.numpy()
            pt._next_prompt_batch = lambda: PRODA_IDX
        out["logits"] = pt.model_inference(images)[0].numpy()
    out["step_loss"] = float(pt.forward_backward(
        {"img": fx.images, "label": fx.labels})["loss"])
    out["trainables"] = {k: v.detach().numpy() for k, v in flatten_params(
        pt.model_params("prompt_learner")).items()}
    return out


@pytest.fixture(scope="module")
def trainer_numbers(fx):
    return {key: (_jax_numbers(fx, key), _port_one_rank(fx, key))
            for key in ("dp_coop", "cocoop", "proda")}


def _assert_trainer(fx, trainer_numbers, group, case):
    key = case.split("@")[0]
    want, one = trainer_numbers[key]
    r = _same_on_every_rank(getattr(fx, group), case)
    # on the mesh against one rank, inside each rank and here
    _close(*r["loss"])
    _close(r["loss"][0], one["loss"][1])
    for k, (g_mesh, g_one) in r["grads"].items():
        _close(g_mesh, g_one, what=k)
        _close(g_mesh, one["grads"][k][1], what=k)
        # every trainable is reached, and its gradient is JAX's
        assert np.abs(want["grads"][k]).max() > 1e-5, k
        _close(g_mesh, want["grads"][k], rtol=RTOL, atol=ATOL, what=k)
    np.testing.assert_allclose(r["loss"][0], want["loss"], rtol=1e-5)
    _close(r["logits"], one["logits"], rtol=2e-4, atol=2e-4)
    _close(r["logits"], want["logits"], rtol=2e-4, atol=2e-4)
    if key == "proda":
        _close(r["text_features"], one["text_features"])
        _close(r["text_features"], want["text_features"], rtol=RTOL,
               atol=ATOL)
    _close(r["step_loss"], one["step_loss"])
    for k, v in r["trainables"].items():
        _close(v, one["trainables"][k], what=k)
        _close(v, want["trainables"][k], rtol=RTOL, atol=ATOL, what=k)


def test_trainer_data_parallel_matches_single_device(fx, trainer_numbers):
    """CoOp over a (4, 1) mesh (each rank 2 of the 8 rows; gradients
    averaged over the data axis): loss, context gradient, logits and one
    step equal one rank's and the JAX trainer's."""
    _assert_trainer(fx, trainer_numbers, "four", "dp_coop@4,1")


@pytest.mark.parametrize("group,case", [("two", "cocoop@1,2"),
                                        ("four", "cocoop@2,2")])
def test_cocoop_class_sharded_matches_single_device(fx, trainer_numbers,
                                                    group, case):
    """CoCoOp's fan-out with its classes over the model axis: the loss,
    the context's and the meta-net's gradients (summed over the model
    ranks, averaged over the data ranks), the logits and one step equal
    one rank's and JAX's."""
    _assert_trainer(fx, trainer_numbers, group, case)


@pytest.mark.parametrize("group,case", [("two", "proda@1,2"),
                                        ("four", "proda@2,2")])
def test_proda_class_sharded_matches_single_device(fx, trainer_numbers,
                                                   group, case):
    """ProDA's n_cls x P fan-out with its classes over the model axis
    (the class-free rows counted once), and the ``set_classifier``
    sweep."""
    _assert_trainer(fx, trainer_numbers, group, case)


# --------------------------------------------------------------- TP towers

def test_tower_tp_gating():
    """tower_tp is None without a model axis > 1; otherwise it holds this
    rank's model coordinate and splits the heads over the model axis."""
    from clip_calibration_tpu_torch.parallel.mesh import Mesh, make_mesh
    from clip_calibration_tpu_torch.parallel.tp import tower_tp
    assert tower_tp(None) is None
    assert tower_tp(make_mesh()) is None
    assert tower_tp(Mesh((4, 1), 0, None, None, (0,))) is None
    tp = tower_tp(Mesh((2, 2), 3, None, None, (1, 3)))
    assert tp is not None and (tp.m, tp.r) == (2, 1)
    assert tower_tp(Mesh((1, 2), 0, None, None, (0,))).heads(12) == 6


def _jax_tp(fx, mesh_shape):
    from clip_calibration_tpu.models import clip as JM
    from clip_calibration_tpu.parallel.mesh import make_mesh
    from clip_calibration_tpu.parallel.tp import tower_tp
    from jax.sharding import NamedSharding, PartitionSpec as P
    cfg, params = fx.jax_tp_cfg, fx.jax_tp_params
    n = mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(mesh_shape, devices=jax.devices()[:n])
    tp = tower_tp(mesh)
    repl = NamedSharding(mesh, P())
    data_sh = NamedSharding(mesh, P("data"))
    with mesh:
        return np.asarray(jax.jit(
            lambda p, x: JM.encode_image(p, cfg, x, dtype=jnp.float32,
                                         tp=tp),
            in_shardings=(repl, data_sh), out_shardings=repl)(
            jax.device_put(params, repl),
            jax.device_put(jnp.asarray(fx.tp_images), data_sh)))


@pytest.mark.parametrize("group,case,shape", [("two", "tp@1,2", (1, 2)),
                                              ("four", "tp@2,2", (2, 2))],
                         ids=["pure-tp", "dp-x-tp"])
def test_tensor_parallel_encode_matches_single_device(fx, group, case,
                                                      shape):
    """The TP towers (this rank's heads and hidden features, K1 on the
    local heads, two all_reduces a layer) equal the whole towers on one
    rank and JAX's ``tower_tp`` encode."""
    from clip_calibration_tpu_torch.models import clip as M
    from clip_calibration_tpu_torch.models.weights import params_from_numpy
    from clip_calibration_tpu_torch.parallel.dryrun import TP_CFG
    r = _same_on_every_rank(getattr(fx, group), case)
    model = params_from_numpy(fx.inputs["tp_params"], TP_CFG,
                              torch.float32, "cpu")
    with torch.inference_mode():
        img = M.encode_image(model, TP_CFG, torch.as_tensor(fx.tp_images),
                             dtype=torch.float32).numpy()
    tp_img, whole = r["image"]
    _close(whole, img)
    _close(tp_img, img)
    _close(tp_img, _jax_tp(fx, shape), rtol=RTOL, atol=ATOL)
    _close(*r["text"])


def test_tensor_parallel_rejects_resnet_and_int8():
    """ResNet towers are data-parallel only (ValueError, as JAX). Int8
    weights are no longer rejected: each rank cuts its columns of
    ``wqkv`` (its heads' q, k and v) and ``w_fc`` with their scales, its
    rows of ``wo`` and ``w_proj`` with every column's scale, the K-major
    copy to match, all contiguous; the static activation scale stays
    whole (the encodes are held to one rank in test_torch_int8_tp.py)."""
    from clip_calibration_tpu_torch.models import clip as M
    from clip_calibration_tpu_torch.ops import quant as Q
    from clip_calibration_tpu_torch.parallel.mesh import Mesh
    from clip_calibration_tpu_torch.parallel.tp import tower_tp
    from clip_calibration_tpu_torch.serving import Predictor
    mesh = Mesh((1, 2), 0, None, None, (0,))
    tp = tower_tp(mesh)
    rn = M.init_clip(M.CLIP(M.PRESETS["RN-Test"], torch.float32, "cpu"), 0)
    with pytest.raises(ValueError, match="data-parallel"):
        M.encode_image(rn, M.PRESETS["RN-Test"],
                       torch.zeros((2, 32, 32, 3)), tp=tp)
    with pytest.raises(ValueError, match="data-only"):
        Predictor("RN-Test", ["a", "b"], precision="fp32", mesh=mesh,
                  device="cpu")
    vit = Q.quantize_clip_params(M.init_clip(
        M.CLIP(M.PRESETS["ViT-Test"], torch.float32, "cpu"), 0))
    vit = Q.attach_act_scales(vit, Q.calibrate_image_act_scales(
        vit, vit.cfg, torch.zeros((2, 32, 32, 3))))
    block = vit.visual.blocks[1]
    for r in range(2):
        cut = tower_tp(Mesh((1, 2), r, None, None, (0,))).block(block)
        D, lo, hid = 64, r * 32, slice(r * 128, (r + 1) * 128)
        heads = np.concatenate([np.arange(k * D + lo, k * D + lo + 32)
                                for k in range(3)])
        whole = {"wqkv": (block.attn.wqkv, np.s_[:, heads]),
                 "w_fc": (block.mlp.w_fc, np.s_[:, hid]),
                 "wo": (block.attn.wo, np.s_[lo:lo + 32]),
                 "w_proj": (block.mlp.w_proj, np.s_[hid])}
        for key, (w, part) in whole.items():
            got = cut[key]
            assert Q.is_quantized(got)
            assert got.act_scale is w.act_scale
            for t in (got.int8, got.scale, got.kmajor):
                assert t.is_contiguous()
            np.testing.assert_array_equal(got.int8, w.int8.numpy()[part])
            np.testing.assert_array_equal(got.kmajor, got.int8.T)
            cols = part[1] if key in ("wqkv", "w_fc") else slice(None)
            np.testing.assert_array_equal(got.scale,
                                          w.scale.numpy()[:, cols])


# ----------------------------------------------------------------- serving

@pytest.mark.parametrize("group,case", [("two", "predictor@1,2"),
                                        ("four", "predictor@2,2")])
def test_serving_predictor_on_a_mesh(fx, group, case, monkeypatch):
    """Predictor on a mesh (batch over data, the ViT tower TP over model)
    and TrainerPredictor over a CoCoOp trainer built on it (class-sharded
    fan-out): every rank returns the meshless predictors' probabilities;
    the batch size rounds up to the data axis."""
    from clip_calibration_tpu_torch.models import clip as M
    from clip_calibration_tpu_torch.parallel.dryrun import TP_CFG
    from clip_calibration_tpu_torch.serving import (Predictor,
                                                    TrainerPredictor)
    r = _same_on_every_rank(getattr(fx, group), case)
    d = 2 if group == "four" else 1
    assert r["batch_size"] == r["trainer_batch_size"] == 3 + (d - 1)
    monkeypatch.setitem(M.PRESETS, TP_PRESET, TP_CFG)
    monkeypatch.setenv("CLIP_CHECKPOINT_DIR", fx.weights)
    plain = Predictor(TP_PRESET, fx.classnames, precision="fp32",
                      batch_size=3, device="cpu")
    _close(r["probs"], plain.predict(fx.serve_images)["probs"])
    spec = fx.inputs["trainers"]["cocoop"]
    t = port_trainer("CoCoOp", fx.inputs["data_root"],
                     osp.join(osp.dirname(fx.weights), "serve_one"),
                     spec["overrides"], None)
    want = TrainerPredictor(t, batch_size=3).predict(fx.trainer_images)
    _close(r["trainer_probs"], want["probs"])


# ------------------------------------------------ bf16 data-parallel steps

def _rel(got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_step(jt, name, images, labels, mesh=None):
    """The JAX trainer's (loss, {leaf: gradient}) on the fixture's batch,
    jitted as its step is: on one device, or on ``mesh`` with the batch
    over its data axis and everything else replicated (ProDA's classes
    over its model axis: ``_build_steps`` reads the trainer's mesh).
    ProGrad: the CE, and its CE and KL gradients (``ce/``, ``kl/``)
    beside their projection."""
    from clip_calibration_tpu.models.weights import flatten_params
    from clip_calibration_tpu.trainers.prograd import prograd_project
    from jax.sharding import NamedSharding, PartitionSpec as P
    if name == "ProDA" and mesh is not None:
        jt._mesh = mesh
        jt._build_steps()
    slot = _slot(name)
    args = [jt.model_params(slot), jt.step_clip_params]
    data = [False, False]
    if name == "ProGrad":
        def fn(tr, frozen, x, y):
            (xe, _), vjp = jax.vjp(lambda t: jt._losses(t, frozen, x, y),
                                   tr)
            g_ce, = vjp((jnp.ones(()), jnp.zeros(())))
            g_kl, = vjp((jnp.zeros(()), jnp.ones(())))
            return xe, {"proj": prograd_project(g_ce, g_kl, jt.lambda_),
                        "ce": g_ce, "kl": g_kl}
    else:
        fn = jax.value_and_grad(_jax_loss_fn(jt))
        if PROMPT_TRAINERS.get(name, (0, 0, False))[2]:
            args.append(jt.text_features)
            data.append(False)
    args += [jnp.asarray(images), jnp.asarray(labels)]
    data += [True, True]
    if name == "ProDA":
        args.append(jnp.asarray(PRODA_IDX))
        data.append(False)
    if mesh is None:
        loss, grads = jax.jit(fn)(*args)
    else:
        sh = [NamedSharding(mesh, P("data") if d else P()) for d in data]
        with mesh:
            loss, grads = jax.jit(fn, in_shardings=tuple(sh),
                                  out_shardings=NamedSharding(mesh, P()))(
                *[jax.device_put(a, s) for a, s in zip(args, sh)])
    flat = {k: np.asarray(v, np.float32)
            for k, v in flatten_params(grads).items()}
    if name == "ProGrad":
        flat = {(k[len("proj/"):] if k.startswith("proj/") else k): v
                for k, v in flat.items()}
    return float(loss), flat


@pytest.fixture(scope="module")
def bf16_jax(fx):
    """key -> {"one": (loss, grads), "d,m": (loss, grads)}: each bf16 JAX
    trainer on one device and on the mesh of each of its cases (the
    first d x m virtual CPU devices)."""
    from clip_calibration_tpu.parallel.mesh import make_mesh
    out = {}
    for key, (name, _) in BF16.items():
        jt = fx.bf16[key]
        out[key] = {"one": _jax_step(jt, name, fx.images, fx.labels)}
        for _, case in BF16_CASES:
            k, shape = case[len("step:"):].split("@")
            if k == key:
                d, m = (int(x) for x in shape.split(","))
                out[key][shape] = _jax_step(
                    jt, name, fx.images, fx.labels,
                    make_mesh((d, m), devices=jax.devices()[:d * m]))
    return out


def _bf16_case(fx, group, case):
    key, shape = case[len("step:"):].split("@")
    return key, shape, _same_on_every_rank(getattr(fx, group), case)


@pytest.mark.parametrize("group,case", BF16_CASES)
def test_bf16_mesh_step_matches_one_rank(fx, group, case):
    """(a) The bf16 step on the mesh against the same step on one rank
    (every rank recomputes it without its mesh): the loss, and every
    trainable's gradient within ``BF16_MESH_GRAD_RTOL`` of its max; a
    leaf of ``MESH_GAP`` within twice the larger of its two recorded
    gaps (the JAX package's, where an image side reaches it)."""
    key, shape, r = _bf16_case(fx, group, case)
    lm, l1 = r["loss"]
    np.testing.assert_allclose(lm, l1, rtol=BF16_MESH_LOSS_RTOL)
    for k, (g_mesh, g_one) in r["grads"].items():
        assert np.abs(g_one).max() > 1e-5, k  # every trainable is reached
        bound = max(BF16_MESH_GRAD_RTOL, 2 * max(MESH_GAP.get((key, k),
                                                              (0, 0))))
        assert _rel(g_mesh, g_one) <= bound, (k, _rel(g_mesh, g_one), bound)


@pytest.mark.parametrize("group,case", BF16_CASES)
def test_bf16_mesh_step_matches_jax_mesh(fx, bf16_jax, group, case):
    """(b) The port's bf16 mesh step against the JAX trainer's on a mesh
    of the same shape: the loss and every gradient within the bf16
    tolerances the one-device comparison holds
    (``test_bf16_one_rank_matches_jax``)."""
    key, shape, r = _bf16_case(fx, group, case)
    loss, grads = bf16_jax[key][shape]
    np.testing.assert_allclose(r["loss"][0], loss, rtol=BF16_JAX_LOSS_RTOL)
    assert sorted(r["grads"]) == sorted(grads)
    for k, (g_mesh, _) in r["grads"].items():
        assert _rel(g_mesh, grads[k]) <= BF16_JAX_GRAD_RTOL, (
            k, _rel(g_mesh, grads[k]))


@pytest.mark.parametrize("key", list(BF16))
def test_bf16_one_rank_matches_jax(fx, bf16_jax, key):
    """The port's bf16 step on one rank (each rank's own recomputation,
    of the first case of ``key``) against the JAX trainer's on one
    device."""
    group, case = next((g, c) for g, c in BF16_CASES
                       if c.startswith(f"step:{key}@"))
    _, _, r = _bf16_case(fx, group, case)
    loss, grads = bf16_jax[key]["one"]
    np.testing.assert_allclose(r["loss"][1], loss, rtol=BF16_JAX_LOSS_RTOL)
    for k, (_, g_one) in r["grads"].items():
        assert _rel(g_one, grads[k]) <= BF16_JAX_GRAD_RTOL, (
            k, _rel(g_one, grads[k]))


@pytest.mark.parametrize("group,case", BF16_CASES)
def test_jax_bf16_mesh_step_equals_one_device(bf16_jax, group, case):
    """The reference property: the JAX mesh step's loss and gradients are
    its one-device step's, to fp32 summation order, on every leaf its
    text side alone reaches; on the leaves an image side reaches (and
    ProDA's, whose model axis sums bf16 partial gradients) the gap is
    the one recorded in ``MESH_GAP``, within a factor of 2."""
    key, shape = case[len("step:"):].split("@")
    l1, g1 = bf16_jax[key]["one"]
    lm, gm = bf16_jax[key][shape]
    np.testing.assert_allclose(lm, l1, rtol=BF16_MESH_LOSS_RTOL)
    for k in g1:
        gap, want = _rel(gm[k], g1[k]), MESH_GAP.get((key, k), (0,))[0]
        if want == 0:
            assert gap <= JAX_SUM_ORDER_RTOL, (k, gap)
        else:
            assert want / 2 <= gap <= 2 * want, (k, gap, want)
