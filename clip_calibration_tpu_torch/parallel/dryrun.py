"""Multi-rank dry run: one sharded train step, the calibrated eval, the
class-sharded product trainers and the tensor-parallel tower, each held to
the same work on one rank.

Counterpart of ``__graft_entry__.py::dryrun_multichip``. It runs inside an
initialized process group (``parallel/mesh.py::initialize_distributed``);
every rank calls the same functions with the same seeded inputs. The
pieces take a mesh and a model, so a caller can run them at any width and
mesh (the tests at ViT-Test on the CPU under gloo, ``chip_smoke.py`` at
ViT-B/16 on the card); ``dryrun_multichip`` composes them as the JAX
function does: a (world / 2, 2) mesh, or (world, 1) for an odd world.

Where a piece compares with one rank, the unsharded work is recomputed on
every rank with no mesh: no collective runs in it. Every entry runs on the
card unless the caller passes ``device="cpu"``, and raises without one.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models import clip as M
from ..ops.preprocess import normalize_images
from ..tools.device import resolve_device
from .mesh import (Mesh, class_slice, data_mean, gather_classes,
                   gather_data, local_rows, make_mesh, reduce_data_grad,
                   reduce_grads, world)
from .tp import tower_tp

#: the TP check's tower: 2 vision heads (width 128) and 4 text heads, so
#: a model axis of 2 splits both (the JAX dry run's config)
TP_CFG = M.CLIPConfig(32, 32, 2, 128, 8, 64, 4, 2)


def setup(preset: str, n_cls: int, batch: int, n_ctx: int = 4,
          seed: int = 0, device="cuda", dtype=torch.float32):
    """(cfg, model, ctx, embedding, eot_pos, images, labels): a seeded
    random CLIP and a CoOp problem on it (constant pre-embedded class
    prompts [SOS | ctx slots | class tokens]), the same on every rank
    (drawn on the CPU, then moved)."""
    device = resolve_device(device)
    cfg = M.PRESETS[preset] if isinstance(preset, str) else preset
    model = M.init_clip(M.CLIP(cfg, dtype, device), seed)
    gen = torch.Generator().manual_seed(seed + 1)
    D = cfg.transformer_width
    ctx = torch.randn((n_ctx, D), generator=gen) * 0.02
    embedding = torch.randn((n_cls, cfg.context_length, D),
                            generator=gen) * 0.01
    eot_pos = torch.full((n_cls,), 1 + n_ctx + 2, dtype=torch.long)
    res = cfg.image_resolution
    images = (torch.rand((batch, res, res, 3), generator=gen) * 255
              ).to(torch.uint8)
    labels = torch.arange(batch) % n_cls
    return (cfg, model, ctx.to(device), embedding.to(device),
            eot_pos.to(device), images.to(device), labels.to(device))


def text_features(model, cfg, ctx, embedding, eot_pos, n_ctx: int,
                  mesh: Optional[Mesh], dtype=torch.float32):
    """Normalized class text features [n_cls, E] of ``ctx`` spliced into
    every class prompt; on a model axis each rank encodes its classes
    and the class axis is gathered."""
    n_cls = embedding.shape[0]
    cls = class_slice(n_cls, mesh).to(embedding.device)
    emb = embedding if len(cls) == n_cls else embedding[cls]
    eot = eot_pos if len(cls) == n_cls else eot_pos[cls]
    tiled = ctx.to(emb.dtype)[None].expand(emb.shape[0], *ctx.shape)
    prompts = torch.cat([emb[:, :1], tiled, emb[:, 1 + n_ctx:]], dim=1)
    txt = M.encode_text_embedded(model, cfg, prompts.to(dtype), eot,
                                 seq_len=1 + n_ctx + 3)
    return gather_classes(M.normalize(txt), mesh, 0, n_cls)


def coop_loss(ctx, model, cfg, embedding, eot_pos, images, labels,
              n_ctx: int, mesh: Optional[Mesh] = None,
              dtype=torch.float32) -> torch.Tensor:
    """The JAX dry run's ``_loss_fn``: CoOp's cross-entropy with the
    batch over the data axis (this rank's rows of ``images``) and the
    class prompts over the model axis. The mean over this rank's rows."""
    txt_f = text_features(model, cfg, ctx, embedding, eot_pos, n_ctx,
                          mesh, dtype)
    with torch.no_grad():
        img_f = M.encode_image(model, cfg,
                               normalize_images(local_rows(images, mesh),
                                                dtype=dtype), dtype=dtype)
    logits = M.cosine_logits(img_f, txt_f, model.logit_scale,
                             text_hook=lambda t: reduce_data_grad(t, mesh))
    return F.cross_entropy(logits, local_rows(labels, mesh).long())


def coop_step(ctx, model, cfg, embedding, eot_pos, images, labels,
              n_ctx: int, mesh: Optional[Mesh], dtype=torch.float32,
              lr: float = 1e-2):
    """One SGD (momentum 0.9) step of the context on the mesh: returns
    (the global batch's loss, the context's global gradient, the new
    context)."""
    ctx = ctx.detach().clone().requires_grad_(True)
    opt = torch.optim.SGD([ctx], lr=lr, momentum=0.9)
    loss = coop_loss(ctx, model, cfg, embedding, eot_pos, images, labels,
                     n_ctx, mesh, dtype)
    grad, = torch.autograd.grad(loss, [ctx])
    ctx.grad, = reduce_grads([grad], mesh, model_sharded=True)
    opt.step()
    return data_mean(loss.detach(), mesh), ctx.grad, ctx.detach()


@torch.no_grad()
def calibrated_eval(model, cfg, ctx, embedding, eot_pos, images, labels,
                    n_ctx: int, mesh: Optional[Mesh], dtype=torch.float32):
    """The sharded calibrated eval (reference ``base_learner.py:59-152``):
    4-way class text features (zero and tuned contexts, the base classes
    and an independent draw standing in for new ones), the DAC fit, the
    image features of this rank's rows, the fused DAC scores gathered
    over the data axis, accuracy and ECE. Returns (probs, conf, acc,
    ece)."""
    from ..ops.scoring import dac_class_confidence, fused_dac_scores
    from ..tools.metrics import ECE
    gen = torch.Generator().manual_seed(7)
    cur = (torch.randn(embedding.shape, generator=gen) * 0.01).to(
        embedding.device, embedding.dtype)
    zs = torch.zeros_like(ctx)

    def feats(c, emb):
        return text_features(model, cfg, c, emb, eot_pos, n_ctx, mesh,
                             dtype).float()

    cur_tuned = feats(ctx, cur)
    conf = dac_class_confidence(feats(zs, embedding), feats(zs, cur),
                                feats(ctx, embedding), cur_tuned, k=2)
    img_f = M.normalize(M.encode_image(
        model, cfg, normalize_images(local_rows(images, mesh), dtype=dtype),
        dtype=dtype)).float()
    probs, _ = fused_dac_scores(img_f, cur_tuned, model.logit_scale, conf,
                                normalized=True)
    probs = gather_data(probs, mesh).double().cpu().numpy()
    pred = probs.argmax(axis=1)
    gt = labels.cpu().numpy()
    return (probs, conf.cpu().numpy(), float((pred == gt).mean()),
            ECE(probs.max(axis=1), pred, gt, conf_bin_num=5))


@contextlib.contextmanager
def one_rank(trainer):
    """The trainer's work without its mesh (every rank alone), for the
    comparison with one process."""
    mesh = trainer._mesh
    trainer._mesh = None
    try:
        yield trainer
    finally:
        trainer._mesh = mesh


def trainer_step_check(trainer, images: np.ndarray, labels: np.ndarray,
                       *loss_args):
    """One train loss of a built trainer on a global batch, on its mesh
    (this rank's rows; gradients reduced over the mesh) and on one rank
    (the whole batch): returns {"loss": (mesh, one rank), "grads":
    {leaf: (mesh, one rank)}} as host arrays. ProGrad's step takes two
    gradients (``loss_grads``: CE and KL, two backward passes) and
    projects them: its loss is the CE, its leaves the projected gradient
    beside ``ce/<leaf>`` and ``kl/<leaf>``. Leaves the trainables
    unchanged."""
    from ..engine.checkpoint import flatten_params
    from ..engine.optim import sorted_leaves
    from ..trainers.prograd import ProGrad, prograd_project
    params = trainer.model_params(trainer.get_model_names()[0])
    flat = flatten_params(params)
    keys, leaves = list(flat), list(flat.values())
    lab = torch.as_tensor(labels).to(trainer.device)
    mesh = trainer.mesh

    def step(images, labels):
        """(loss, {key: gradient}) as the trainer's step reduces them."""
        if isinstance(trainer, ProGrad):
            name = {id(t): k for k, t in flat.items()}
            order = [name[id(t)] for t in sorted_leaves(params)]
            xe, g_ce, g_kl = trainer.loss_grads(images, labels)
            proj = prograd_project(g_ce, g_kl, trainer.lambda_)
            return xe, {**dict(zip(order, proj)),
                        **{f"ce/{k}": g for k, g in zip(order, g_ce)},
                        **{f"kl/{k}": g for k, g in zip(order, g_kl)}}
        loss = trainer._loss(images, labels, *loss_args)
        return loss, dict(zip(keys, reduce_grads(
            torch.autograd.grad(loss, leaves), trainer.mesh,
            model_sharded=trainer.class_sharded)))

    loss, g_mesh = step(local_rows(images, mesh), local_rows(lab, mesh))
    loss_mesh = data_mean(loss.detach(), mesh)
    with one_rank(trainer):
        loss1, g_one = step(images, lab)
    host = lambda t: t.detach().float().cpu().numpy()  # noqa: E731
    return {"loss": (float(loss_mesh), float(loss1.detach())),
            "grads": {k: (host(g_mesh[k]), host(g_one[k]))
                      for k in g_mesh}}


def _product_cfg(mesh_shape, trainer_name: str, root: str, out_dir: str,
                 batch: int):
    from ..config import get_cfg_default
    from ..ops.preprocess import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD
    from .. import trainers as _trainers  # noqa: F401 (registration)
    from ..data import datasets as _datasets  # noqa: F401
    from ..evaluators import vl_evaluator as _evaluator  # noqa: F401
    cfg = get_cfg_default()
    cfg.TEST.EVALUATOR = "VLClassification"
    cfg.DATASET.NAME = "Synthetic"
    cfg.DATASET.ROOT = root
    cfg.DATASET.NUM_SHOTS = 4
    cfg.SEED = 1
    cfg.OUTPUT_DIR = out_dir
    cfg.MODEL.BACKBONE.NAME = "ViT-Test"
    cfg.MODEL.PRECISION = "fp32"
    cfg.INPUT.SIZE = (32, 32)
    cfg.INPUT.PIXEL_MEAN = list(CLIP_PIXEL_MEAN)
    cfg.INPUT.PIXEL_STD = list(CLIP_PIXEL_STD)
    cfg.INPUT.TRANSFORMS = ("random_resized_crop", "random_flip",
                            "normalize")
    cfg.TRAINER.NAME = trainer_name
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = batch
    cfg.DATALOADER.TEST.BATCH_SIZE = batch
    cfg.DATALOADER.NUM_WORKERS = 1
    cfg.TPU.MESH_SHAPE = tuple(mesh_shape)
    return cfg


def product_trainers(mesh: Mesh, device="cuda", root: Optional[str] = None,
                     batch: Optional[int] = None) -> dict:
    """The product trainers on the mesh, ViT-Test on the synthetic data:
    CoCoOp and ProDA (the class-sharded fan-outs; ProDA's eval
    ``set_classifier`` too), a TempScaling epoch over a CoOp base, CoOp
    with a w8a8 frozen vision tower and CoCoOp with a w8a8 eval text
    tower. Each runs one step on its first batch and its inference; the
    fan-out trainers' steps are also held to one rank. Every rank needs
    its own ``root`` (the synthetic images and outputs are written
    there). ``batch``: the global batch (default 2 a data rank)."""
    from ..data.base import set_random_seed
    from ..engine.registry import TRAINER_REGISTRY
    from ..ops.quant import QuantizedWeight
    device = resolve_device(device)
    root = root or tempfile.mkdtemp(prefix="dryrun_")
    batch = batch or mesh.dims[0] * 2
    out = {}

    def build(name, **tcfg):
        cfg = _product_cfg(mesh.dims, name, os.path.join(root, "data"),
                           os.path.join(root, "out_" + name), batch)
        for key, v in tcfg.items():
            node = cfg
            *parts, last = key.split(".")
            for p in parts:
                node = getattr(node, p)
            setattr(node, last, v)
        cfg.freeze()
        # every rank draws the same few-shot split
        set_random_seed(cfg.SEED)
        return TRAINER_REGISTRY.get(name)(cfg, device=device)

    def global_batch(trainer):
        rng = np.random.default_rng(3)
        res = trainer.clip_cfg.image_resolution
        return (torch.as_tensor(rng.integers(0, 256, (batch, res, res, 3),
                                             dtype=np.uint8),
                                device=trainer.device),
                rng.integers(0, trainer.num_classes, batch))

    t = build("CoCoOp", **{"TRAINER.COCOOP.N_CTX": 2,
                           "TRAINER.COCOOP.PREC": "fp32"})
    images, labels = global_batch(t)
    out["cocoop"] = trainer_step_check(t, images, labels)
    step = t.forward_backward(next(iter(t.train_loader_x)))
    logits, _, _ = t.model_inference(local_rows(images, mesh))
    out["cocoop"]["step_loss"] = float(step["loss"])
    out["cocoop"]["logits"] = gather_data(logits.detach(), mesh).cpu().numpy()

    t = build("ProDA", **{"TRAINER.PRODA.N_CTX": 2,
                          "TRAINER.PRODA.N_PROMPT": 4,
                          "TRAINER.PRODA.PROMPT_BS": 2,
                          "TRAINER.PRODA.PREC": "fp32"})
    images, labels = global_batch(t)
    out["proda"] = trainer_step_check(t, images, labels,
                                      np.array([3, 0]))
    step = t.forward_backward(next(iter(t.train_loader_x)))
    t.set_classifier()
    mesh_tf = t.text_features.float().cpu().numpy()
    with one_rank(t):
        t.set_classifier()
        one_tf = t.text_features.float().cpu().numpy()
    t.set_classifier()
    logits, _, _ = t.model_inference(local_rows(images, mesh))
    out["proda"].update(step_loss=float(step["loss"]),
                        text_features=(mesh_tf, one_tf),
                        logits=gather_data(logits.detach(), mesh).cpu().numpy())

    t = build("TempScaling", **{"CALIBRATION.SCALING.BASE_LEARNER": "CoOp",
                                "TRAINER.COOP.N_CTX": 2,
                                "TRAINER.COOP.PREC": "fp32"})
    for b in t.train_loader_x:
        step = t.forward_backward(b)
    out["tempscaling"] = {"loss": float(step["loss"]),
                          "temperature": float(step["temperature"])}

    t = build("CoOp", **{"TRAINER.COOP.N_CTX": 2,
                         "TRAINER.COOP.PREC": "fp32",
                         "TRAINER.QUANT_FROZEN_VISION": "w8a8"})
    images, _ = global_batch(t)
    step = t.forward_backward(next(iter(t.train_loader_x)))
    logits, _, _ = t.model_inference(local_rows(images, mesh))
    scales = [float(w.act_scale) for w in t.step_clip_params.modules()
              if isinstance(w, QuantizedWeight) and w.act_scale is not None
              and w.act_scale.ndim == 0]
    out["coop_w8a8"] = {"loss": float(step["loss"]), "act_scales": scales,
                        "logits": gather_data(logits.detach(), mesh)
                        .cpu().numpy()}

    t = build("CoCoOp", **{"TRAINER.COCOOP.N_CTX": 2,
                           "TRAINER.COCOOP.PREC": "fp32",
                           "TRAINER.QUANT_EVAL_TEXT": "w8a8"})
    images, _ = global_batch(t)
    step = t.forward_backward(next(iter(t.train_loader_x)))
    logits, _, _ = t.model_inference(local_rows(images, mesh))
    out["cocoop_w8a8"] = {"loss": float(step["loss"]),
                          "logits": gather_data(logits.detach(), mesh).cpu().numpy()}
    return out


#: the int8 TP checks against one rank, max |diff| of the features (the
#: JAX dry run's bounds, ``__graft_entry__.py``): weight-only int8 sums
#: the same products in another order; static w8a8 also rescales each
#: rank's partial int32 product before the sum
INT8_TP_TOL = 1e-4
W8A8_TP_TOL = 1e-3


@torch.inference_mode()
def tp_tower(mesh: Mesh, device="cuda", cfg=TP_CFG, model=None,
             images: Optional[torch.Tensor] = None,
             dtype=torch.float32) -> dict:
    """The ViT and text towers with heads and MLP hidden features over the
    model axis (``parallel/tp.py``), this data rank's rows, against the
    whole towers on one rank: returns the gathered TP features and the
    unsharded ones (host arrays). Then the JAX dry run's two int8 checks:
    the weight-only int8 image tower, and the static-w8a8 one (scales
    calibrated on the same images, unsharded), each TP against one rank
    within ``INT8_TP_TOL`` / ``W8A8_TP_TOL``; their max |diff| returned
    as ``int8_err`` and ``w8a8_err``."""
    from ..ops import quant as Q
    device = resolve_device(device)
    tp = tower_tp(mesh)
    if tp is None:
        raise RuntimeError(f"tower_tp inactive on {mesh}")
    if model is None:
        model = M.init_clip(M.CLIP(cfg, dtype, device), 2)
    if images is None:
        gen = torch.Generator().manual_seed(3)
        images = torch.randn((8, cfg.image_resolution,
                              cfg.image_resolution, 3),
                             generator=gen).to(device)
    gen = torch.Generator().manual_seed(4)
    toks = torch.randint(1, 400, (images.shape[0], 12), generator=gen)
    toks[:, 0] = cfg.vocab_size - 2
    toks[:, 9] = cfg.vocab_size - 1
    toks[:, 10:] = 0
    toks = toks.to(device)
    out = {}
    for name, fn in (
            ("image", lambda x, tp_: M.encode_image(model, cfg, x,
                                                    dtype=dtype, tp=tp_)),
            ("text", lambda t, tp_: M.encode_text(model, cfg, t,
                                                  dtype=dtype, tp=tp_))):
        x = images if name == "image" else toks
        got = gather_data(fn(local_rows(x, mesh), tp), mesh)
        out[name] = (got.float().cpu().numpy(),
                     fn(x, None).float().cpu().numpy())
    qmodel = Q.quantize_clip_params(model)
    smodel = Q.attach_act_scales(qmodel, Q.calibrate_image_act_scales(
        qmodel, cfg, images))
    for name, m, qmode, tol in (("int8", qmodel, "dequant", INT8_TP_TOL),
                                ("w8a8", smodel, "w8a8", W8A8_TP_TOL)):
        got = gather_data(M.encode_image(m, cfg, local_rows(images, mesh),
                                         dtype=dtype, qmode=qmode, tp=tp),
                          mesh)
        want = M.encode_image(m, cfg, images, dtype=dtype, qmode=qmode)
        err = float((got.float() - want.float()).abs().max())
        if not err <= tol:
            raise AssertionError(f"dryrun: {name} TP tower differs from one "
                                 f"rank: max|diff| {err} > {tol}")
        out[f"{name}_err"] = err
    return out


def dryrun_multichip(device="cuda", root: Optional[str] = None) -> dict:
    """The JAX ``dryrun_multichip`` on this process group: a (world / 2,
    2) mesh (or (world, 1)), one sharded CoOp step and the calibrated eval
    at ViT-Test, held to one rank; the product trainers; with a model
    axis, the TP towers. Returns the numbers it checked."""
    device = resolve_device(device)
    rank, n = world()
    m = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = make_mesh((n // m, m))
    print(f"mesh: {mesh.shape}")
    n_ctx = 2
    cfg, model, ctx, emb, eot, images, labels = setup(
        "ViT-Test", n_cls=m * 4, batch=n // m * 2, n_ctx=n_ctx,
        device=device)
    loss, grad, new_ctx = coop_step(ctx, model, cfg, emb, eot, images,
                                    labels, n_ctx, mesh)
    loss1, grad1, _ = coop_step(ctx, model, cfg, emb, eot, images, labels,
                                n_ctx, None)
    res = {"coop_loss": (float(loss), float(loss1)),
           "coop_grad": (grad.cpu().numpy(), grad1.cpu().numpy())}
    _check("CoOp step loss", *res["coop_loss"])
    _check("CoOp context gradient", *res["coop_grad"])
    print(f"dryrun_multichip({n}): one sharded train step OK, "
          f"loss={float(loss):.4f}")
    probs, conf, acc, ece = calibrated_eval(model, cfg, new_ctx, emb, eot,
                                            images, labels, n_ctx, mesh)
    probs1, _, _, _ = calibrated_eval(model, cfg, new_ctx, emb, eot, images,
                                      labels, n_ctx, None)
    _check("calibrated probabilities", probs, probs1)
    res["eval_probs"] = (probs, probs1)
    print(f"dryrun_multichip eval: sharded inference sweep + DAC fit + "
          f"fused scoring OK (batch={probs.shape[0]}, "
          f"n_cls={probs.shape[1]}, dac_conf_range=[{conf.min():.3f}, "
          f"{conf.max():.3f}]), accuracy={acc * 100:.2f}% "
          f"ece={ece * 100:.2f}%")
    root = root or tempfile.mkdtemp(prefix=f"dryrun_rank{rank}_")
    res["products"] = product_trainers(mesh, device, root)
    for name in ("cocoop", "proda"):
        r = res["products"][name]
        _check(f"{name} loss", *r["loss"])
        for k, (a, b) in r["grads"].items():
            _check(f"{name} gradient {k}", a, b)
    _check("ProDA set_classifier", *res["products"]["proda"]
           ["text_features"])
    print(f"dryrun product trainers on mesh {mesh.shape}: CoCoOp, ProDA, "
          f"TempScaling, CoOp w8a8 frozen tower, CoCoOp w8a8 eval text OK")
    if m > 1:
        res["tp"] = tp_tower(mesh, device)
        for name in ("image", "text"):
            _check(f"TP {name} tower", *res["tp"][name])
        print(f"dryrun TP tower: heads/hidden over 'model' OK (mesh "
              f"{mesh.shape}); int8 TP tower max|diff| vs one rank "
              f"{res['tp']['int8_err']:.2e}, static w8a8 "
              f"{res['tp']['w8a8_err']:.2e}")
    return res


#: fp32 on the CPU: the sharded sums run in another order (the JAX
#: package's bound, tests/test_parallel.py)
RTOL, ATOL = 2e-5, 2e-5


def _check(what: str, got, want, rtol: float = RTOL, atol: float = ATOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.allclose(got, want, rtol=rtol,
                                                  atol=atol):
        diff = (np.abs(got - want).max() if got.shape == want.shape
                else f"shapes {got.shape} vs {want.shape}")
        raise AssertionError(f"dryrun: {what} on the mesh differs from "
                             f"one rank: {diff}")
