"""KgCoOp: Knowledge-guided Context Optimization.

Parity target: reference ``trainers/classification/kgcoop.py``, through
``clip_calibration_tpu/trainers/kgcoop.py``. CoOp plus a regularizer
pulling the tuned text features toward frozen zero-shot text features of
the hand-crafted per-dataset template:
loss = CE + W * (1 - mean cos(text_tuned, text_zs)) (reference
``kgcoop.py:262-269``). CTX_INIT: True in its configs means init from
"a photo of a" (reference ``kgcoop.py:102-105``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..engine.registry import TRAINER_REGISTRY
from ..models import clip as M
from .base_learner import encode_classnames_zs
from .coop import CoOp
from .templates import CUSTOM_TEMPLATES


@TRAINER_REGISTRY.register()
class KgCoOp(CoOp):

    trainer_cfg_key = "KGCOOP"

    def post_build(self):
        # frozen zero-shot text features (normalized) of the
        # CUSTOM_TEMPLATES prompt (reference kgcoop.py:155-165)
        cfg = self.cfg
        zs = encode_classnames_zs(cfg.MODEL.BACKBONE.NAME, cfg.DATASET.NAME,
                                  self.dm.dataset.classnames,
                                  CUSTOM_TEMPLATES[cfg.DATASET.NAME],
                                  precision=cfg.MODEL.PRECISION,
                                  device=self.device)
        self._zs_text = torch.as_tensor(zs, dtype=torch.float32,
                                        device=self.device)
        self.w = self.trainer_cfg().W

    def _loss(self, images, labels):
        txt_f = self._text_features(self.model_params("prompt_learner")
                                    ["ctx"])
        with torch.no_grad():
            img_f = self._image_features(images)
        logits = M.cosine_logits(img_f, txt_f, self.clip_model.logit_scale,
                                 text_hook=self.replicated_text)
        ce = F.cross_entropy(logits, labels.long())
        # the text-to-text term depends on no image: its gradient is the
        # same on every data rank, the global batch's already
        txt_n = M.normalize(txt_f).float()
        score = 1.0 - (txt_n * self._zs_text).sum(dim=-1).mean()
        return ce + self.w * score
