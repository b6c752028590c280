"""The port's process meshes (``clip_calibration_tpu_torch/parallel/``)
against one rank and the JAX package: the twin of tests/test_parallel.py.

The JAX tests run on 8 virtual devices of one process; the port runs one
process per device, so here each mesh is a gloo process group of CPU
processes (``tests/torch_parallel_driver.py``): one group of 2 ranks and
one of 4, each running several cases in turn. The same inputs (seeded
numpy arrays, one weight file) go through the mesh, through the port on
one rank (this process, no process group) and through the JAX package.
fp32 throughout: the sharded sums run in another order, bounded at rel
2e-5 as tests/test_parallel.py bounds them; against JAX the port's own
tolerances (tests/test_torch_training.py).
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
from test_torch_training import ATOL, RTOL, _opts  # noqa: E402
from torch_parallel_driver import port_trainer, run_ranks  # noqa: E402

# mesh vs one rank, fp32 (tests/test_parallel.py's bound)
MESH_RTOL = MESH_ATOL = 2e-5
TP_PRESET = "ViT-TP-Test"


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
    f.inputs = inputs
    f.two = run_ranks(str(root / "two"), 2, inputs,
                      ["coop_loss@1,2", "cocoop@1,2", "proda@1,2",
                       "tp@1,2", "predictor@1,2"], f.weights)
    f.four = run_ranks(str(root / "four"), 4, inputs,
                       ["shapes@2,2", "coop_loss@2,2", "dp_coop@4,1",
                        "cocoop@2,2", "proda@2,2", "tp@2,2",
                        "predictor@2,2", "dryrun"], f.weights)
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
