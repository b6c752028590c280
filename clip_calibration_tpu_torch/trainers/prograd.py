"""ProGrad: prompt tuning with projected gradients.

Parity target: reference ``trainers/classification/prograd.py``, through
``clip_calibration_tpu/trainers/prograd.py``. Two losses: the student's
cross-entropy and a temperature-T distillation term against frozen
zero-shot CLIP logits (``ProGradLoss``, reference ``prograd.py:291-304``),
with gradient surgery (``prograd_backward_and_update``, reference
``prograd.py:371-409``): per parameter tensor, where the CE gradient
conflicts with the KL gradient's direction (negative cosine), its
component along that direction is taken out, g = g_ce - lambda (g_ce .
b_hat) b_hat.

One forward, two backward passes over its graph, as the reference:
``torch.autograd.grad`` of the CE with ``retain_graph=True``, then of the
KL (the JAX package pulls both from one ``jax.vjp``). Every text layer
runs K2 twice a step. The context is ProGrad's: all N_CTX slots learnable
and zero-initialized, the dataset template's phrase in the last slots
(``ctx_init_tail``). The zero-shot teacher is fp32 whatever PREC says,
as the reference's ``.float()``-ed teacher.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..engine.optim import sorted_leaves
from ..engine.registry import TRAINER_REGISTRY
from ..models import clip as M
from ..parallel.mesh import data_mean, reduce_grads
from .base_learner import encode_classnames_zs
from .coop import CoOp
from .templates import CUSTOM_TEMPLATES


def prograd_project(grads_ce, grads_kl, lambda_: float):
    """Per tensor (of matching dicts or sequences), the CE gradient with
    its component along the KL gradient's direction taken out where the
    two conflict."""
    if isinstance(grads_ce, dict):
        return {k: prograd_project(v, grads_kl[k], lambda_)
                for k, v in grads_ce.items()}
    if isinstance(grads_ce, (list, tuple)):
        return [prograd_project(a, b, lambda_)
                for a, b in zip(grads_ce, grads_kl)]
    g_a, g_b = grads_ce, grads_kl
    b_hat = g_b / (torch.linalg.vector_norm(g_b) + 1e-12)
    a_hat = g_a / (torch.linalg.vector_norm(g_a) + 1e-12)
    cos = (a_hat * b_hat).sum()
    projected = g_a - lambda_ * (g_a * b_hat).sum() * b_hat
    return torch.where(cos < 0, projected, g_a)


def prograd_losses(logits: torch.Tensor, tea_logits: torch.Tensor,
                   labels: torch.Tensor, T: float):
    """(cross-entropy, T^2-scaled distillation KL) of the student's
    ``logits`` against the teacher's (reference ``ProGradLoss``)."""
    xe = F.cross_entropy(logits, labels.long())
    tea_prob = torch.softmax(tea_logits / T, dim=-1)
    kl = (-tea_prob * torch.log_softmax(logits / T, dim=-1)
          * T * T).sum(dim=1).mean()
    return xe, kl


@TRAINER_REGISTRY.register()
class ProGrad(CoOp):

    trainer_cfg_key = "PROGRAD"

    def _resolve_ctx_init(self, tcfg) -> str:
        """CTX_INIT truthy means the DATASET's template phrase (reference
        ``prograd.py:88-105``), embedded in the last slots of a full N_CTX
        context (``ctx_init_tail``)."""
        if tcfg.CTX_INIT:
            return (CUSTOM_TEMPLATES[self.cfg.DATASET.NAME]
                    .replace(" {}.", "").replace("_", " "))
        return ""

    def _assembly_extra(self) -> dict:
        return {"ctx_init_tail": True}

    def post_build(self):
        tcfg = self.trainer_cfg()
        self.T = tcfg.T
        self.lambda_ = tcfg.LAMBDA
        assert tcfg.LOSS_NAME == "prograd"
        zs = encode_classnames_zs(self.cfg.MODEL.BACKBONE.NAME,
                                  self.cfg.DATASET.NAME,
                                  self.dm.dataset.classnames,
                                  CUSTOM_TEMPLATES[self.cfg.DATASET.NAME],
                                  precision="fp32", device=self.device)
        self._zs_text = torch.as_tensor(zs, dtype=torch.float32,
                                        device=self.device)

    def _losses(self, images, labels):
        """(CE, KL) of one batch, differentiable in the context."""
        txt_f = self._text_features(self.model_params("prompt_learner")
                                    ["ctx"])
        with torch.no_grad():
            img_f = self._image_features(images)
        img_n = M.normalize(img_f).float()
        logits = M.cosine_logits(img_f, txt_f, self.clip_model.logit_scale,
                                 text_hook=self.replicated_text)
        scale = torch.exp(self.clip_model.logit_scale.float())
        return prograd_losses(logits, scale * (img_n @ self._zs_text.T),
                              labels, self.T)

    def loss_grads(self, images, labels):
        """(CE, CE's gradients, KL's gradients) of one batch, each over
        the trainables in ``sorted_leaves`` order: two backward passes
        through the text tower, each on the global batch's gradient of
        the text features (``replicated_text``). On a mesh both become
        the global batch's before the (nonlinear) projection, as the JAX
        step takes them."""
        params = sorted_leaves(self.model_params("prompt_learner"))
        xe, kl = self._losses(images, labels)
        g_ce = torch.autograd.grad(xe, params, retain_graph=True)
        g_kl = torch.autograd.grad(kl, params)
        return (xe, reduce_grads(g_ce, self.mesh),
                reduce_grads(g_kl, self.mesh))

    def forward_backward(self, batch):
        name = "prompt_learner"
        images, labels = self.parse_batch_train(batch)
        self.optimizer(name).zero_grad(set_to_none=True)
        xe, g_ce, g_kl = self.loss_grads(images, self.put_batch(labels))
        params = sorted_leaves(self.model_params(name))
        for p, g in zip(params, prograd_project(g_ce, g_kl, self.lambda_)):
            p.grad = g
        self.optimizer_step(name)
        self._cached_text_features = None  # ctx changed
        return {"loss": data_mean(xe.detach(), self.mesh)}
