"""CoCoOp: conditional (instance-conditioned) context optimization.

Parity target: reference ``trainers/classification/cocoop.py``, through
``clip_calibration_tpu/trainers/cocoop.py``. A meta-net MLP (vis_dim ->
vis_dim/16 -> ctx_dim) maps each image's features to a bias added to the
shared context; every image then gets its own n_cls text encodes
(reference ``cocoop.py:156-199``).

The per-image fan-out runs as a Python loop over chunks of
``_CHUNK_TARGET_ROWS // n_cls`` images, each chunk one text-tower call of
about 512 prompt rows (the JAX package's ``lax.map`` over the same
chunks; the last chunk here is ragged where the JAX one pads). From
B * n_cls >= 512 rows each chunk is checkpointed (``torch.utils.checkpoint``,
non-reentrant): its backward recomputes the chunk's text tower, so the
saved activations stay one chunk's. The prompts are concatenations and
the EOT rows gathered, so no indexed read (and no sorting backward) is
in the graph. Under ``TRAINER.QUANT_EVAL_TEXT`` the eval fan-out runs
the int8 text tower (K3 under w8a8); training never does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..engine.registry import TRAINER_REGISTRY
from ..models import clip as M
from ..models.backbone import load_clip_backbone
from ..ops.preprocess import normalize_images
from .base_learner import VLBaseLearner
from .coop import build_prompt_assembly

# prompt rows per text-tower call in the chunked per-image encode
_CHUNK_TARGET_ROWS = 512


def meta_net_forward(p, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ p["w1"].to(x.dtype) + p["b1"].to(x.dtype))
    return h @ p["w2"].to(x.dtype) + p["b2"].to(x.dtype)


def fanout_logits(model, cfg, asm, ctx: torch.Tensor, img_f: torch.Tensor,
                  qmode: str = "dequant"):
    """The CoCoOp fan-out: ctx [B, n_ctx, D] per-image contexts (fp32),
    img_f [B, E] normalized image features -> (logits [B, n_cls] fp32, the
    last image's normalized class text features [n_cls, E])."""
    emb = asm["embedding"][:, :asm["seq_len"]]
    n_ctx = asm["n_ctx"]
    n_cls, L, D = emb.shape
    B = ctx.shape[0]
    chunk = max(1, min(B, _CHUNK_TARGET_ROWS // max(n_cls, 1)))
    scale = torch.exp(model.logit_scale.float())

    def per_chunk(ctx_c, imf_c):
        c = ctx_c.shape[0]
        prompts = torch.cat([
            emb[None, :, :1].expand(c, n_cls, 1, D),
            ctx_c.to(emb.dtype)[:, None].expand(c, n_cls, n_ctx, D),
            emb[None, :, 1 + n_ctx:].expand(c, n_cls, L - 1 - n_ctx, D)],
            dim=2).reshape(c * n_cls, L, D)
        txt = M.encode_text_embedded(model, cfg, prompts,
                                     asm["eot_pos"].repeat(c), qmode=qmode)
        txt_n = M.normalize(txt).reshape(c, n_cls, -1)
        return scale * torch.einsum("cd,cnd->cn", imf_c.float(),
                                    txt_n.float()), txt_n

    # at scale each chunk is checkpointed: the loop's backward would
    # otherwise keep every chunk's text-tower activations, B * n_cls rows'
    # worth, the very spike the chunks bound in the forward
    remat = B * n_cls >= _CHUNK_TARGET_ROWS and torch.is_grad_enabled()
    logits = []
    for i in range(0, B, chunk):
        args = (ctx[i:i + chunk], img_f[i:i + chunk])
        l_c, txt_n = (checkpoint(per_chunk, *args, use_reentrant=False)
                      if remat else per_chunk(*args))
        logits.append(l_c)
    return torch.cat(logits), txt_n[-1]


@TRAINER_REGISTRY.register()
class CoCoOp(VLBaseLearner):

    #: eval re-runs the text tower for every image's class set: the
    #: quantized text fan-out's workload (TRAINER.QUANT_EVAL_TEXT)
    text_eval_quant_supported = True

    def check_cfg(self, cfg):
        assert cfg.TRAINER.COCOOP.PREC in ("fp16", "fp32", "amp")

    @property
    def compute_dtype(self):
        return (torch.float32 if self.cfg.TRAINER.COCOOP.PREC == "fp32"
                else torch.bfloat16)

    @torch.no_grad()
    def build_model(self):
        cfg = self.cfg
        tcfg = cfg.TRAINER.COCOOP
        classnames = self.dm.dataset.classnames
        print(f"Loading CLIP (backbone: {cfg.MODEL.BACKBONE.NAME})")
        self.clip_model, self.clip_cfg = load_clip_backbone(
            cfg.MODEL.BACKBONE.NAME,
            "float32" if tcfg.PREC == "fp32" else "bfloat16", self.device)

        asm = build_prompt_assembly(classnames, tcfg.N_CTX, "end",
                                    tcfg.CTX_INIT, self.clip_model,
                                    self.compute_dtype)
        self.asm = asm
        n_ctx = asm["n_ctx"]
        ctx_dim = self.clip_cfg.transformer_width
        vis_dim = self.clip_cfg.embed_dim
        print(f'Initial context: "{asm["prompt_prefix"]}"')
        print(f"Number of context words (tokens): {n_ctx}")

        gen = torch.Generator(device=self.device).manual_seed(
            max(cfg.SEED, 0))
        if asm["ctx_vectors"] is not None:
            ctx = torch.as_tensor(asm["ctx_vectors"], dtype=torch.float32,
                                  device=self.device)
        else:
            ctx = torch.randn((n_ctx, ctx_dim), generator=gen,
                              device=self.device) * 0.02

        def uniform(shape, fan_in):
            # torch nn.Linear's default init for weights AND biases,
            # U(+-1/sqrt(fan_in)) (the reference meta_net)
            lim = (1.0 / fan_in) ** 0.5
            return (torch.rand(shape, generator=gen, device=self.device)
                    * 2 - 1) * lim

        hid = vis_dim // 16
        self.register_trainable("prompt_learner", {"ctx": ctx, "meta": {
            "w1": uniform((vis_dim, hid), vis_dim),
            "b1": uniform((hid,), vis_dim),
            "w2": uniform((hid, ctx_dim), hid),
            "b2": uniform((ctx_dim,), hid)}})
        self.setup_frozen_vision()

    # -- forward ----------------------------------------------------------
    def _forward(self, images, model, text_qmode="dequant"):
        """(logits [B, n_cls], normalized image features, the last
        image's normalized text features) on ``model``'s towers;
        ``text_qmode`` "w8a8" only at eval over a text-quantized model
        (the train step's prompt gradients flow through the text tower)."""
        dtype = self.compute_dtype
        x = normalize_images(self.put_batch(images), *self.pixel_stats,
                             dtype=dtype)
        with torch.no_grad():
            img_f = M.normalize(M.encode_image(
                model, self.clip_cfg, x, dtype=dtype,
                qmode=self.vision_qmode_for(x.shape[0])))
        p = self.model_params("prompt_learner")
        bias = meta_net_forward(p["meta"], img_f.float())  # [B, D]
        ctx = p["ctx"][None] + bias[:, None]               # [B, n_ctx, D]
        logits, txt_last = fanout_logits(model, self.clip_cfg, self.asm,
                                         ctx, img_f, text_qmode)
        return logits, img_f, txt_last

    def _loss(self, images, labels):
        logits, _, _ = self._forward(images, self.step_clip_params)
        return F.cross_entropy(logits, labels.long())

    def forward_backward(self, batch):
        out = self.loss_step("prompt_learner", batch)
        if self.text_eval_quant:
            self.invalidate_eval_text_quant()  # ctx moved: scales stale
        return out

    def model_inference(self, images):
        if self.text_eval_quant:
            return self._forward(images, self.eval_text_clip_params(),
                                 self.text_eval_qmode())
        return self._forward(images, self.step_clip_params)

    def _text_calibration_prompts(self):
        """The context's prompts over all classes without the meta-net
        bias. Every calibrated site follows a LayerNorm, whose output range
        the small per-image shift barely moves; agreement with the
        full-precision fan-out is held by the tests."""
        asm = self.asm
        emb = asm["embedding"]
        n_ctx = asm["n_ctx"]
        ctx = self.model_params("prompt_learner")["ctx"].detach()
        prompts = torch.cat(
            [emb[:, :1], ctx.to(emb.dtype)[None].expand(
                emb.shape[0], n_ctx, emb.shape[-1]), emb[:, 1 + n_ctx:]],
            dim=1)
        return prompts, asm["eot_pos"], asm["seq_len"]

    def load_model(self, directory, epoch=None):
        super().load_model(directory, epoch)
        self.invalidate_eval_text_quant()  # new ctx: scales stale

    def convert_to_reference_state(self, name, state):
        """Ours -> the reference's ``meta_net.linear{1,2}`` ([out, in]
        Linear weights)."""
        state = dict(state)
        meta = state.pop("meta", None)
        if meta is not None:
            state["meta_net"] = {
                "linear1": {"weight": torch.as_tensor(meta["w1"]).T,
                            "bias": torch.as_tensor(meta["b1"])},
                "linear2": {"weight": torch.as_tensor(meta["w2"]).T,
                            "bias": torch.as_tensor(meta["b2"])},
            }
        return state

    def convert_reference_state(self, name, state):
        """Reference prompt_learner checkpoints hold
        ``meta_net.linear{1,2}.{weight,bias}`` (torch [out, in] weights)."""
        meta = state.get("meta_net")
        if meta is not None:
            state = dict(state)
            del state["meta_net"]
            state["meta"] = {
                "w1": torch.as_tensor(meta["linear1"]["weight"]).T,
                "b1": torch.as_tensor(meta["linear1"]["bias"]),
                "w2": torch.as_tensor(meta["linear2"]["weight"]).T,
                "b2": torch.as_tensor(meta["linear2"]["bias"]),
            }
        return state
