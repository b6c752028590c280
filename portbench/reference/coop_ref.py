"""CoOp on the plain reference: prompts, class text features, train steps,
and DAC's class confidences.

CoOp (Zhou et al., "Learning to Prompt for Vision-Language Models",
https://arxiv.org/abs/2109.01134): the prompt of class c is
``[SOS] ctx_1 .. ctx_n [name tokens] . [EOS]``, its n context vectors
shared by every class and the only trained tensor; the loss is the
cross-entropy of ``exp(logit_scale) * cos(image, text)`` logits. The
optimizer is SGD with momentum and weight decay (torch's update) at the
per-epoch learning rate of Dassl's warm-up and cosine schedule.

DAC (the calibration paper's distance-aware calibration): a new class's
confidence is the ratio of ``exp(-mean of its k smallest distances to the
base classes' text features)`` under the tuned and the zero-shot text
features, or 1 where the nearest tuned base distance is below 0.05.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import tokenizer
from .clip_ref import ReferenceCLIP, exact_fp32, normalize


def prompt_rows(ref: ReferenceCLIP, names, n_ctx: int):
    """(frozen embeddings [n, L, D] fp32, eot [n]) of the class prompts
    ``X x n_ctx name.``; L is one past the furthest end-of-text token."""
    tok = tokenizer.default().tokenize(
        [" ".join(["X"] * n_ctx) + " " + n.replace("_", " ") + "."
         for n in names])
    dev = ref.w["logit_scale"].device
    tok = torch.as_tensor(tok, device=dev)
    eot = tok.argmax(dim=-1)
    L = int(eot.max()) + 1
    return ref.token_embedding(tok[:, :L]), eot


def splice(emb: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
    n = ctx.shape[0]
    return torch.cat([emb[:, :1], ctx.expand(emb.shape[0], -1, -1),
                      emb[:, 1 + n:]], dim=1)


@torch.no_grad()
def class_features(ref: ReferenceCLIP, names, ctx: torch.Tensor,
                   chunk: int = 512) -> torch.Tensor:
    """Normalised CoOp text features of ``names`` under context ``ctx``."""
    emb, eot = prompt_rows(ref, names, ctx.shape[0])
    return normalize(torch.cat([
        ref.text_features_embedded(splice(emb[i:i + chunk], ctx.float()),
                                   eot[i:i + chunk])
        for i in range(0, len(names), chunk)]))


@torch.no_grad()
def zeroshot_features(ref: ReferenceCLIP, names,
                      template: str) -> torch.Tensor:
    tok = tokenizer.default().tokenize(
        [template.format(n.replace("_", " ")) for n in names])
    dev = ref.w["logit_scale"].device
    return normalize(ref.text_features(torch.as_tensor(tok, device=dev)))


def lr_at(opts: dict, steps_per_epoch: int, step: int) -> float:
    """Dassl's per-epoch rate: constant or linear warm-up, then cosine
    (the first epoch after warm-up at index 1)."""
    if opts["OPTIM.LR_SCHEDULER"] != "cosine":
        raise ValueError("the reference follows the cosine schedule only")
    base, max_epoch = opts["OPTIM.LR"], opts["OPTIM.MAX_EPOCH"]
    warm = opts["OPTIM.WARMUP_EPOCH"]
    epoch = min(step // max(steps_per_epoch, 1), max_epoch)
    if warm > 0 and epoch < warm:
        if opts["OPTIM.WARMUP_TYPE"] == "constant":
            return opts["OPTIM.WARMUP_CONS_LR"]
        return opts["OPTIM.WARMUP_MIN_LR"] if epoch == 0 \
            else base * epoch / warm
    shift = warm - 1 if warm > 0 else 0
    return base * 0.5 * (1.0 + math.cos(math.pi * (epoch - shift)
                                        / max_epoch))


def train_steps(cfg: dict, weights, names, ctx0: torch.Tensor, images,
                labels, traffic: dict, products: str = "fp32") -> dict:
    """CoOp's first ``len(images)`` steps from context ``ctx0``: each
    step's loss, the first step's gradient, the context after the
    last."""
    opts = traffic["cfg"]
    if opts["OPTIM.NAME"] != "sgd" or opts.get("TRAINER.COOP.CSC") or \
            opts.get("TRAINER.COOP.CLASS_TOKEN_POSITION", "end") != "end":
        raise ValueError("the reference follows SGD and one shared "
                         "context at the end position")
    ref = ReferenceCLIP(cfg, weights, products)
    wd, mom = opts["OPTIM.WEIGHT_DECAY"], opts["OPTIM.MOMENTUM"]
    ctx = ctx0.detach().float().clone()
    buf, losses, grad1 = None, [], None
    with exact_fp32():
        emb, eot = prompt_rows(ref, names, ctx.shape[0])
        for s, (img, lab) in enumerate(zip(images, labels)):
            img_f = normalize(ref.image_features(img))
            c = ctx.clone().requires_grad_(True)
            txt_f = normalize(ref.text_features_embedded(splice(emb, c),
                                                         eot))
            logits = ref.logit_scale() * img_f @ txt_f.T
            loss = F.cross_entropy(logits, lab.long())
            (g,) = torch.autograd.grad(loss, c)
            losses.append(float(loss.detach()))
            if s == 0:
                grad1 = g.detach().clone()
            d = g + wd * ctx
            buf = d if buf is None else mom * buf + d
            ctx = ctx - lr_at(opts, traffic["steps_per_epoch"], s) * buf
    return {"losses": losses, "grad1": grad1, "ctx3": ctx}


def dac_confidence(base_zs, cur_zs, base_tuned, cur_tuned,
                   k: int = 5) -> np.ndarray:
    """Per new class confidence, in float64."""
    def scores(base, cur):
        base = np.asarray(base, np.float64)
        cur = np.asarray(cur, np.float64)
        d = np.sqrt(np.maximum(
            (cur ** 2).sum(-1)[:, None] + (base ** 2).sum(-1)[None, :]
            - 2.0 * cur @ base.T, 0.0))
        top = np.sort(d, axis=1)[:, :k]
        return np.exp(-top.sum(axis=1) / k), top.min(axis=1)

    zs, _ = scores(base_zs, cur_zs)
    fs, fs_min = scores(base_tuned, cur_tuned)
    return np.where(fs_min < 0.05, 1.0, fs / zs)
