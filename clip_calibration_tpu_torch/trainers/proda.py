"""ProDA: prompt distribution learning.

Parity target: reference ``trainers/classification/proda.py``, through
``clip_calibration_tpu/trainers/proda.py``. N_PROMPT contexts with mixed
class-token positions (the first quarter front, the next quarter middle,
the rest end; reference ``proda.py:111-115``); each train step takes a
PROMPT_BS minibatch of them from a per-cycle permutation (reference
``proda.py:146-157``, host state here as in the JAX package). Training
logits are the prompt-mean text features plus a covariance correction
0.5 scale^2 sigma (reference ``proda.py:283-292``), and a diversity
penalty on class-free prompts' features (mean |off-diagonal gram|,
``proda.py:296-302``). Eval averages the text features over all prompts
(``set_classifier``, reference ``proda.py:315-331``).

The three position variants are position maps made once
(``coop.py::build_prompt_assembly``); a step writes each prompt's context
into its variant's rows (an ``index_put``, whose backward is a gather)
after picking the minibatch with ``index_select`` (backward an
``index_add``), so no indexed read with PyTorch's sorting backward is in
the graph. The (class x prompt) fan-out and the N_PROMPT class-free rows
go through ONE text-tower call, at the longer of the two sequence
lengths (the causal mask keeps every row's pooled feature the same);
from 512 rows the tower checkpoints each layer. The covariance
correction is computed on its diagonal and label row only, never as the
[D, n_cls, n_cls] covariance.

On a mesh with a model axis of m > 1 (``parallel/mesh.py``) each model
rank encodes its block of ceil(n_cls / m) classes x P prompt rows, in the
train step, in ``set_classifier`` and in the ``QUANT_EVAL_TEXT`` sweep
(the text tower sees [n_cls / m x P + 32, Lp, D]); ``gather_classes``
restores the class axis, and the loss is computed on it alike on every
model rank. The class-free diversity rows ride in every model rank's
tower call (no extra call or collective, the same values everywhere):
``count_once`` keeps their gradient on model rank 0 only, so the
model-group sum of the partial gradients counts them once and the loss
and its gradient equal the unsharded ones. A class count that m does not
divide is padded with copies of the last class and trimmed after the
gather. The activation-scale calibration of ``QUANT_EVAL_TEXT w8a8``
runs over all classes on every rank (once per classifier; the same
scales as one process).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..engine.registry import TRAINER_REGISTRY
from ..models import clip as M
from ..models.backbone import load_clip_backbone
from ..models.tokenizer import tokenize
from ..ops.preprocess import normalize_images
from ..parallel.mesh import (class_slice, count_once, data_mean,
                             gather_classes)
from .base_learner import VLBaseLearner
from .coop import build_prompt_assembly

# text-tower rows from which the prompt fan-out checkpoints each layer
# (memory, not speed: the same rows as the JAX package's remat)
_REMAT_MIN_TEXT_ROWS = 512


@TRAINER_REGISTRY.register()
class ProDA(VLBaseLearner):

    #: the eval set_classifier sweep re-runs the text tower over
    #: n_cls x n_prompt rows (TRAINER.QUANT_EVAL_TEXT quantizes it)
    text_eval_quant_supported = True

    def check_cfg(self, cfg):
        assert cfg.TRAINER.PRODA.PREC in ("fp16", "fp32", "amp")

    shards_classes = True

    @property
    def compute_dtype(self):
        return (torch.float32 if self.cfg.TRAINER.PRODA.PREC == "fp32"
                else torch.bfloat16)

    @torch.no_grad()
    def build_model(self):
        cfg = self.cfg
        tcfg = cfg.TRAINER.PRODA
        classnames = self.dm.dataset.classnames
        print(f"Loading CLIP (backbone: {cfg.MODEL.BACKBONE.NAME})")
        self.clip_model, self.clip_cfg = load_clip_backbone(
            cfg.MODEL.BACKBONE.NAME,
            "float32" if tcfg.PREC == "fp32" else "bfloat16", self.device)
        dtype = self.compute_dtype

        n_ctx = tcfg.N_CTX
        self.n_prompt = tcfg.N_PROMPT
        self.prompt_bs = tcfg.PROMPT_BS
        self.alpha = tcfg.ALPHA
        assert self.n_prompt % self.prompt_bs == 0
        self.n_iter = self.n_prompt // self.prompt_bs
        ctx_dim = self.clip_cfg.transformer_width

        # the three class-token positions' rows and context position maps
        asms = [build_prompt_assembly(classnames, n_ctx, pos, "",
                                      self.clip_model, dtype)
                for pos in ("front", "middle", "end")]
        self.embedding = torch.stack([a["embedding"] for a in asms])
        self.ctx_pos = torch.stack([a["ctx_pos"] for a in asms])
        self.eot_pos = asms[0]["eot_pos"]
        self.n_cls = len(classnames)
        self.seq_len = max(a["seq_len"] for a in asms)
        self.n_ctx = n_ctx
        print("Initializing a generic context")
        print(f"Number of prompts : {self.n_prompt}")
        print(f"Number of context words (tokens): {n_ctx}")

        # per prompt: a quarter front (0), a quarter middle (1), the rest
        # end (2) (reference proda.py:111-115)
        if self.n_prompt > 1:
            q = self.n_prompt // 4
            pos = [0] * q + [1] * q + [2] * (self.n_prompt - 2 * q)
        else:
            pos = [2] * self.n_prompt
        self.pos = torch.as_tensor(pos, dtype=torch.long, device=self.device)

        # class-free prompts "X X ... X ." for the diversity penalty
        nc_toks = tokenize(" ".join(["X"] * n_ctx) + " .")
        emb_table = self.clip_model.text.token_embedding.detach().float()
        self.nc_embedding = emb_table[torch.as_tensor(
            nc_toks[0], device=self.device)].to(dtype)
        self.nc_eot = int(nc_toks[0].argmax())

        gen = torch.Generator(device=self.device).manual_seed(
            max(cfg.SEED, 0))
        self.register_trainable("prompt_learner", {"ctx": torch.randn(
            (self.n_prompt, n_ctx, ctx_dim), generator=gen,
            device=self.device) * 0.02})

        # host-side prompt-minibatch permutation state
        self._perm_rng = np.random.default_rng(max(cfg.SEED, 0))
        self._perm = None
        self._iter_idx = 0
        self.text_features = None  # set by set_classifier

        self.setup_frozen_vision()

    # -- prompt assembly ----------------------------------------------------
    def _assemble(self, ctx_batch, pos_batch, seq_len: int, cls=None):
        """ctx_batch [P, n_ctx, D], pos_batch [P] -> prompts [n_cls, P,
        seq_len, D], each prompt's context written into its position
        variant's rows; ``cls``: only these classes."""
        emb = self.embedding[pos_batch][:, :, :seq_len]  # [P, n_cls, S, D]
        pos = self.ctx_pos[pos_batch]                    # [P, n_cls, n_ctx]
        if cls is not None:
            emb, pos = emb[:, cls], pos[:, cls]
        P, n_cls, n_ctx = pos.shape
        rows = torch.arange(P, device=emb.device)[:, None, None]
        cls = torch.arange(n_cls, device=emb.device)[None, :, None]
        vals = ctx_batch.to(emb.dtype)[:, None].expand(P, n_cls, n_ctx,
                                                       emb.shape[-1])
        prompts = emb.index_put((rows.expand_as(pos), cls.expand_as(pos),
                                 pos), vals)
        return prompts.transpose(0, 1)

    def _text_features_all(self, ctx_batch, pos_batch, model,
                           extra_rows=None, extra_eots=None,
                           qmode="dequant"):
        """[n_cls, P, E] normalized text features; with ``extra_rows``
        [R, 77, D] (and their host ``extra_eots``) also their normalized
        features [R, E], from the SAME tower call. On a model axis > 1
        this rank encodes its classes; the class axis is gathered."""
        seq_len = self.seq_len
        if extra_rows is not None:
            seq_len = max(seq_len, int(np.max(extra_eots)) + 1)
        cls = None  # this model rank's classes (all without a mesh)
        if self.class_sharded:
            cls = class_slice(self.n_cls, self.mesh).to(self.device)
        prompts = self._assemble(ctx_batch, pos_batch, seq_len, cls)
        n_cls, P = prompts.shape[:2]
        flat = prompts.reshape(n_cls * P, seq_len, -1)
        eot = (self.eot_pos if cls is None
               else self.eot_pos[cls]).repeat_interleave(P)
        if extra_rows is not None:
            flat = torch.cat([flat, extra_rows[:, :seq_len].to(flat.dtype)])
            eot = torch.cat([eot, torch.as_tensor(
                np.asarray(extra_eots), dtype=torch.long,
                device=eot.device)])
        txt = M.normalize(M.encode_text_embedded(
            model, self.clip_cfg, flat, eot, qmode=qmode,
            remat=flat.shape[0] >= _REMAT_MIN_TEXT_ROWS))
        out = gather_classes(txt[:n_cls * P].reshape(n_cls, P, -1),
                             self.mesh, 0, self.n_cls)
        if extra_rows is None:
            return out
        return out, txt[n_cls * P:]

    # -- train --------------------------------------------------------------
    def _loss(self, images, labels, batch_idx):
        ctx = self.model_params("prompt_learner")["ctx"]
        batch_idx = torch.as_tensor(batch_idx, dtype=torch.long,
                                    device=ctx.device)
        ctx_b = ctx.index_select(0, batch_idx)
        pos_b = self.pos[batch_idx]
        labels = labels.long()
        model = self.step_clip_params
        dtype = self.compute_dtype

        x = normalize_images(self.put_batch(images), *self.pixel_stats,
                             dtype=dtype)
        with torch.no_grad():
            img_f = M.normalize(M.encode_image(
                model, self.clip_cfg, x, dtype=dtype,
                qmode=self.vision_qmode_for(x.shape[0]))).float()

        # the class-free diversity rows ride in the fan-out's tower call
        nc = self.nc_embedding[None].expand(self.n_prompt,
                                            *self.nc_embedding.shape)
        nc = torch.cat([nc[:, :1], ctx.to(nc.dtype),
                        nc[:, 1 + self.n_ctx:]], dim=1)
        nc_eots = np.full((self.n_prompt,), self.nc_eot, np.int64)
        tf, nc_f = self._text_features_all(ctx_b, pos_b, model,
                                           extra_rows=nc,
                                           extra_eots=nc_eots)
        # all classes on every data rank: the gradient is summed over the
        # data ranks here, before the gather's and the tower's backward
        tf = self.replicated_text(tf.float())  # [n_cls, P, E]
        # every model rank encodes the class-free rows: count them once
        nc_f = count_once(nc_f, self.mesh).float()
        text_mean = tf.mean(dim=1)             # [n_cls, E]
        scale = torch.exp(self.clip_model.logit_scale.float())
        logits = scale * (img_f @ text_mean.T)

        # covariance correction (reference proda.py:283-292): only the
        # diagonal refined[b, i, i] and the label row refined[b, y_b, :]
        # of refined = einsum("bd,ipd,kpd->bik", img^2, c, c) / (P + 1)
        P = tf.shape[1]
        centered = tf - text_mean[:, None]
        img2 = img_f ** 2
        diag = img2 @ (centered ** 2).sum(dim=1).T / (P + 1)
        cl = centered.index_select(0, labels)  # [B, P, E]
        row = torch.einsum("bpd,kpd->bk", img2[:, None] * cl,
                           centered) / (P + 1)
        row_ll = torch.gather(row, 1, labels[:, None])
        sigma = row_ll + diag - 2 * row
        logits = logits + 0.5 * (scale ** 2) * sigma
        loss_upper = F.cross_entropy(logits, labels)

        # diversity penalty over all prompts (reference proda.py:296-302)
        gram = nc_f @ nc_f.T
        off = 1.0 - torch.eye(self.n_prompt, device=gram.device)
        loss_m = (gram.abs() * off).sum() / off.sum()
        return loss_upper + self.alpha * loss_m

    def _next_prompt_batch(self):
        if self.n_iter <= 1:
            return np.arange(self.n_prompt)
        if self._iter_idx == 0:
            self._perm = self._perm_rng.permutation(self.n_prompt)
        sel = self._perm[self._iter_idx * self.prompt_bs:
                         (self._iter_idx + 1) * self.prompt_bs]
        self._iter_idx = (self._iter_idx + 1) % self.n_iter
        return sel

    def forward_backward(self, batch):
        name = "prompt_learner"
        images, labels = self.parse_batch_train(batch)
        batch_idx = self._next_prompt_batch()
        self.optimizer(name).zero_grad(set_to_none=True)
        loss = self._loss(images, self.put_batch(labels), batch_idx)
        loss.backward()
        self.optimizer_step(name)
        self.text_features = None  # classifier stale
        if self.text_eval_quant:
            self.invalidate_eval_text_quant()  # ctx moved: scales stale
        return {"loss": data_mean(loss.detach(), self.mesh)}

    # -- eval ---------------------------------------------------------------
    @torch.no_grad()
    def set_classifier(self):
        """Text features averaged over all prompts, one prompt's
        [n_cls, S, D] encode at a time (the reference chunks on OOM,
        ``proda.py:318-326``); on the int8 text tower under
        ``TRAINER.QUANT_EVAL_TEXT``."""
        if self.text_eval_quant:
            model, qmode = self.eval_text_clip_params(), \
                self.text_eval_qmode()
        else:
            model, qmode = self.clip_model, "dequant"
        ctx = self.model_params("prompt_learner")["ctx"]
        self.text_features = torch.stack([
            self._text_features_all(ctx[i:i + 1], self.pos[i:i + 1], model,
                                    qmode=qmode)[:, 0]
            for i in range(self.n_prompt)]).mean(dim=0)

    def model_inference(self, images):
        if self.text_features is None:
            self.set_classifier()
        dtype = self.compute_dtype
        x = normalize_images(self.put_batch(images), *self.pixel_stats,
                             dtype=dtype)
        img_n = M.normalize(M.encode_image(
            self.step_clip_params, self.clip_cfg, x, dtype=dtype,
            qmode=self.vision_qmode_for(x.shape[0])))
        scale = torch.exp(self.clip_model.logit_scale.float())
        logits = scale * (img_n.float() @ self.text_features.float().T)
        return logits, img_n, self.text_features

    def load_model(self, directory, epoch=None):
        super().load_model(directory, epoch)
        self.text_features = None
        self.invalidate_eval_text_quant()

    def _text_calibration_prompts(self):
        """Prompt 0's rows over all classes: one representative [n_cls,
        S, D] slice of the sweep (every prompt shares the embedding table
        and the LayerNorm-bounded ranges; agreement held by the tests)."""
        ctx = self.model_params("prompt_learner")["ctx"].detach()
        prompts = self._assemble(ctx[:1], self.pos[:1], self.seq_len)
        return prompts[:, 0], self.eot_pos, self.seq_len
