"""Calibrated evaluation: CoOp's inference loop and DAC on new classes.

Set-up builds a CoOp trainer over ``n_classes`` seeded new-class names
with the benchmark's context as its learned one, and makes what the base
run would have left behind, with the port's own functions: zero-shot
text features of the base and the new names (``encode_classnames_zs``),
the tuned base text features (the trainer's ``text_features`` over the
base names' prompt assembly), and the base validation set's image
features and their self-KNN distances (``_run_inference`` and
``get_val_image_knn_dists`` over ``base_val_images`` seeded images). It
then warms what a pass runs on one batch: the inference loop, the DAC
fit, the KNN distances, the calibrated scoring and the evaluator.

A pass is ``test()``'s work without its files, over a test split of
``pass_images`` images (ImageNet's new half: 25,000), so the calibrators
run once per split as a user's evaluation runs them:
``_run_inference`` over the split in batches of ``test_batch`` (staged
one ahead through ``put_batch``; image i is image i modulo a pool of
``image_pool`` seeded images), ``VLCalibration`` with DAC fitted on the
four text-feature sets, ``get_knn_dists`` against the base validation
features, ``_calibrated_probs`` and the evaluator's metrics. Nothing is
cached across passes (``test()``'s ``knndist.npy`` would be). The pass
ends with its metrics on the host. ``eval_images_per_s`` is the images
of the passes of the window over its wall time; the window runs whole
passes until ``--seconds`` have passed. A traced run profiles batches
``trace_batches`` of pass ``trace_pass``: the inference loop.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import flops as FL
from .. import traffic as T
from ..bounds import op_seconds
from . import common


class _Loader:
    """``n`` images in batches of ``batch``, image i being pool image i
    modulo the pool; with a tracer, the slice runs from the ``trace[0]``-th
    batch asked for to the ``trace[1]``-th."""

    def __init__(self, images, labels, batch, n, tracer=None, trace=None):
        self.images, self.labels, self.batch, self.n = (images, labels,
                                                        batch, n)
        self.tracer, self.trace = tracer, trace

    def __iter__(self):
        pool = len(self.images)
        for k, i in enumerate(range(0, self.n, self.batch)):
            if self.tracer is not None:
                if k == self.trace[0]:
                    self.tracer.start()
                elif k == self.trace[1]:
                    self.tracer.stop()
            idx = np.arange(i, min(i + self.batch, self.n)) % pool
            yield {"img": self.images[idx], "label": self.labels[idx],
                   "n_real": len(idx)}


class Driver:
    def __init__(self, run):
        self.run = run
        self.tr = run.traffic

    def setup(self):
        from clip_calibration_tpu_torch.trainers import base_learner as BL
        from clip_calibration_tpu_torch.trainers.calibration import \
            proximity as PX
        from clip_calibration_tpu_torch.trainers.coop import \
            build_prompt_assembly

        run, tr = self.run, self.tr
        model, ccfg, self.weights = common.port_model(run)
        self.new = T.class_names(tr, run.seed, tr["n_classes"])
        self.base = T.class_names(tr, run.seed, tr["n_base_classes"],
                                  "base_names", exclude=self.new)
        with common.backbone(model, ccfg):
            t = self.trainer = common.build_trainer(run, self.new,
                                                    tr["cfg"])
            ctx = t.model_params("prompt_learner")["ctx"]
            self.ctx0 = common.bench_ctx(run, *ctx.shape)
            with torch.no_grad():
                ctx.copy_(self.ctx0)
            zs = {k: BL.encode_classnames_zs(
                run.config["model"], "bench", names,
                template=tr["template"], precision=run.config["precision"],
                device=t.device) for k, names in (("base", self.base),
                                                  ("new", self.new))}
        del model
        asm, t.asm = t.asm, build_prompt_assembly(
            self.base, ctx.shape[0], "end", "", t.clip_model,
            t.compute_dtype)
        t._cached_text_features = None
        base_tuned = BL._host(t.text_features())
        t.asm, t._cached_text_features = asm, None
        res, B = run.config["image_resolution"], tr["test_batch"]
        val_img = T.images(run.seed, tr["base_val_images"], res,
                           run.device, "base_images").cpu().numpy()
        val_lab = T.labels(run.seed, len(val_img), len(self.base), 1)
        _, _, val_f, _ = t._run_inference(
            _Loader(val_img, val_lab, B, len(val_img)))
        k = t.cfg.CALIBRATION.PROCAL.IMAGE_K
        scale = float(torch.exp(t.clip_model.logit_scale.float()))
        self.val_dict = {
            "val_logits": scale * val_f @ base_tuned.T,
            "val_image_features": val_f, "val_text_features": base_tuned,
            "val_labels": val_lab,
            "val_image_knn_dists": PX.get_val_image_knn_dists(
                val_f, k, device=t.device)}
        self.text = {"base_text_features_zs": zs["base"],
                     "current_text_features_zs": zs["new"],
                     "base_text_features_tuned": base_tuned}
        self.images = T.images(run.seed, tr["image_pool"], res,
                               run.device).cpu().numpy()
        self.labels = T.labels(run.seed, tr["image_pool"], len(self.new))
        self.n = tr["pass_images"]
        self.rows = T.sample(run.seed, self.n, tr["check_rows"])
        self.kept = []
        # one batch through everything a pass runs builds and warms it
        self.one_pass(_Loader(self.images, self.labels, B, B))
        self.kept = []
        self.batch_bound_s = op_seconds(
            B * sum(FL.vision_forward(run.config).values()),
            "bfloat16" if run.config["precision"] == "bf16" else "float32")

    def one_pass(self, loader):
        """One calibrated evaluation over ``loader``; returns its host
        seconds spent after inference."""
        from clip_calibration_tpu_torch.trainers.calibration import \
            proximity as PX
        from clip_calibration_tpu_torch.trainers.calibration.vl_calibrator \
            import VLCalibration

        t = self.trainer
        cal = t.cfg.CALIBRATION
        with torch.profiler.record_function("bench.inference"):
            logits, labels, img_f, txt_f = t._run_inference(loader)
        a = time.perf_counter()
        with torch.profiler.record_function("bench.calib_pass"):
            calibrator = VLCalibration(
                t.cfg, cal.BASE_CALIBRATION_MODE,
                cal.BIN.BIN_CALIBRATOR_NAME, cal.DAC.IF_DAC,
                cal.PROCAL.IF_PROCAL, self.val_dict,
                {**self.text, "current_text_features_tuned": txt_f},
                device=t.device)
            calibrator.fit()
            knn = PX.get_knn_dists(self.val_dict["val_image_features"],
                                   img_f, cal.PROCAL.IMAGE_K,
                                   device=t.device)
            prox = PX.proximity_from_dists(knn)
            probs = t._calibrated_probs(calibrator, logits, img_f, txt_f,
                                        prox)
            results = t.evaluator.evaluate(probs, labels, prox)
        b = time.perf_counter()
        n, rows = loader.n, self.rows[self.rows < loader.n]
        ok = len(probs) == len(logits) == n and bool(
            np.isfinite(probs).all()) and all(
            np.isfinite(v) for v in results.values())
        self.kept.append({"logits": logits[rows] if ok else None,
                          "probs": probs[rows] if ok else None,
                          "ok": ok})
        return b - a

    def window(self, seconds: float, tracer) -> dict:
        tr = self.tr
        B = tr["test_batch"]
        self.calib_s, self.traced = [], 0
        passes = 0
        t0 = time.perf_counter()
        while True:
            traced = passes == tr["trace_pass"] and not tracer.done
            loader = _Loader(self.images, self.labels, B, self.n,
                             tracer if traced else None,
                             tr["trace_batches"] if traced else None)
            self.calib_s.append(self.one_pass(loader))
            passes += 1
            if traced:
                tracer.stop()  # a no-op unless the pass ended inside it
                a, b = tr["trace_batches"]
                self.traced = min(b, -(-self.n // B)) - a
            if time.perf_counter() - t0 >= seconds and tracer.done:
                break
        wall = time.perf_counter() - t0
        failed = sum(not k["ok"] for k in self.kept)
        return {"metrics": {"eval_images_per_s": passes * self.n / wall},
                "attempted": passes, "failed": failed,
                "notes": {"window_passes": passes, "window_s": wall}}

    def reading(self, tracer):
        from types import SimpleNamespace
        return SimpleNamespace(
            summary=tracer.summary, calls=tracer.real_calls(),
            work_bound_s=self.traced * self.batch_bound_s,
            spans={"calib_pass": self.calib_s}, counters={})

    def release(self):
        del self.trainer
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, products: str):
        """(logits of the checked rows, DAC's class confidences) by the
        reference computed in ``products``."""
        from ..reference import coop_ref
        from ..reference.clip_ref import ReferenceCLIP, normalize
        run, tr = self.run, self.tr
        ref = ReferenceCLIP(run.config, self.weights, products)
        imgs = torch.as_tensor(self.images[self.rows % len(self.images)],
                               device=run.device)
        img = normalize(ref.image_features(imgs))
        tuned = {k: coop_ref.class_features(ref, names, self.ctx0)
                 for k, names in (("base", self.base), ("new", self.new))}
        zs = {k: coop_ref.zeroshot_features(ref, names, tr["template"])
              for k, names in (("base", self.base), ("new", self.new))}
        conf = coop_ref.dac_confidence(
            zs["base"].cpu().numpy(), zs["new"].cpu().numpy(),
            tuned["base"].cpu().numpy(), tuned["new"].cpu().numpy(),
            tr["cfg"]["CALIBRATION.DAC.K"])
        logits = (ref.logit_scale() * img @ tuned["new"].T).double() \
            .cpu().numpy()
        return logits, conf

    def check(self) -> dict:
        return compare(self.kept, *self._reference("fp32"))

    def control(self, products: str = "fp8") -> dict:
        """The numbers of the reference computed in ``products`` put in
        the program's place."""
        logits, conf = self._reference(products)
        chosen = logits.argmax(axis=1)
        probs = softmax(logits * conf[chosen][:, None])
        return compare([{"ok": True, "logits": logits, "probs": probs}],
                       *self._reference("fp32"))


def softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def compare(kept, ref_logits: np.ndarray, conf: np.ndarray) -> dict:
    """The largest gap over every pass's checked rows: of the logits, and
    of the calibrated probabilities from the reference's logits scaled by
    the confidence of the class the program chose."""
    logit_gap = prob_gap = 0.0
    for k in kept:
        if not k["ok"]:
            continue
        chosen = k["probs"].argmax(axis=1)
        want = softmax(ref_logits * conf[chosen][:, None])
        logit_gap = max(logit_gap, float(np.abs(k["logits"]
                                                - ref_logits).max()))
        prob_gap = max(prob_gap, float(np.abs(k["probs"] - want).max()))
    return {"logit_gap": logit_gap, "prob_gap": prob_gap}
