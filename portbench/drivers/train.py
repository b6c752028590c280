"""Prompt training: the trainer's ``forward_backward`` on seeded batches.

Set-up builds the trainer once (the port's model on the run's weights,
``n_classes`` seeded class names, the context both sides start from),
makes ``pool_batches`` distinct host batches of uint8 images and labels,
and drives the first ``checked_steps`` steps through the same call and
feed as the window: the batches staged one ahead through the trainer's
own ``_device_staged`` / ``put_batch``, as ``run_epoch`` stages a
loader's. Those steps build every kernel and warm every shape the window
uses, and are the ones the reference follows: each step's loss, the
first gradient the optimizer received, the context after the last.

The window keeps stepping the same trainer over the pool until its time
is up, then waits for the card. ``train_images_per_s`` is the images of
all steps enqueued in the window over the window's wall time to that
wait's end. Every step's loss is fetched after the window; a step whose
loss is not finite counts as failed.
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from .. import flops as FL
from .. import traffic as T
from ..bounds import op_seconds
from . import common


class Driver:
    def __init__(self, run):
        self.run = run
        self.tr = run.traffic

    # -- set-up --------------------------------------------------------------
    def setup(self):
        run, tr = self.run, self.tr
        model, ccfg, self.weights = common.port_model(run)
        self.names = T.class_names(tr, run.seed, tr["n_classes"])
        steps_per_epoch = tr["steps_per_epoch"]
        with common.backbone(model, ccfg):
            self.trainer = common.build_trainer(run, self.names, tr["cfg"],
                                                steps_per_epoch)
        del model
        ctx = self.trainer.model_params("prompt_learner")["ctx"]
        self.ctx0 = common.bench_ctx(run, *ctx.shape)
        with torch.no_grad():
            ctx.copy_(self.ctx0)
        res, B = run.config["image_resolution"], tr["batch"]
        self.images = [T.images(run.seed, B, res, run.device,
                                index=i).cpu().numpy()
                       for i in range(tr["pool_batches"])]
        self.labels = [T.labels(run.seed, B, tr["n_classes"], index=i)
                       for i in range(tr["pool_batches"])]
        self.feed = self.trainer._device_staged(
            {"img": self.images[i], "label": self.labels[i]}
            for i in itertools.cycle(range(tr["pool_batches"])))
        self.losses = []
        self.grad1 = None
        for s in range(tr["checked_steps"]):
            self.losses.append(self.trainer.forward_backward(
                next(self.feed))["loss"])
            if s == 0:
                self.grad1 = ctx.grad.detach().clone()
        self.ctx_checked = ctx.detach().clone()
        seq_len = self.trainer.asm["seq_len"]
        cfg = run.config
        vis, txt = FL.vision_forward(cfg), FL.text_forward(cfg, seq_len)
        grad = FL.text_input_grad(cfg, seq_len)
        dt = "bfloat16" if cfg["precision"] == "bf16" else "float32"
        self.step_bound_s = op_seconds(
            B * sum(vis.values()) + tr["n_classes"]
            * (sum(txt.values()) + sum(grad.values())), dt)

    # -- window --------------------------------------------------------------
    def window(self, seconds: float, tracer) -> dict:
        run, tr = self.run, self.tr
        trace_at = tr["trace_steps"]
        self.enqueue_s, self.traced_steps = [], 0
        steps = 0
        window_losses = []
        t0 = time.perf_counter()
        while True:
            if steps == trace_at[0]:
                tracer.start()
            batch = next(self.feed)
            a = time.perf_counter()
            with torch.profiler.record_function("bench.forward_backward"):
                window_losses.append(
                    self.trainer.forward_backward(batch)["loss"])
            b = time.perf_counter()
            steps += 1
            if tracer.on:
                self.traced_steps += 1
                if steps == trace_at[1]:
                    tracer.stop()
            else:
                # the profiler slows the host: only untraced steps count
                self.enqueue_s.append(b - a)
                if b - t0 >= seconds and tracer.done:
                    break
        common.sync(run)
        wall = time.perf_counter() - t0
        losses = torch.stack(window_losses).float().cpu()
        failed = int((~torch.isfinite(losses)).sum())
        rate = steps * tr["batch"] / wall
        return {"metrics": {"train_images_per_s": rate},
                "attempted": steps, "failed": failed,
                "notes": {"window_steps": steps, "window_s": wall}}

    def reading(self, tracer):
        from types import SimpleNamespace
        return SimpleNamespace(
            summary=tracer.summary, calls=tracer.real_calls(),
            work_bound_s=self.traced_steps * self.step_bound_s,
            spans={"forward_backward": self.enqueue_s}, counters={})

    def release(self):
        self.checked = {
            "losses": [float(v) for v in self.losses],
            "grad1": self.grad1.float(), "ctx3": self.ctx_checked.float()}
        del self.trainer, self.feed
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- check ---------------------------------------------------------------
    def _reference(self, products: str) -> dict:
        from ..reference import coop_ref
        run, tr = self.run, self.tr
        n = tr["checked_steps"]
        return coop_ref.train_steps(
            run.config, self.weights, self.names, self.ctx0,
            [torch.as_tensor(self.images[i], device=run.device)
             for i in range(n)],
            [torch.as_tensor(self.labels[i], device=run.device)
             for i in range(n)], tr, products=products)

    def check(self) -> dict:
        return compare(self.checked, self._reference("fp32"), self.ctx0)

    def control(self, products: str = "fp8") -> dict:
        """The numbers of the reference computed in ``products`` put in
        the program's place."""
        return compare(self._reference(products), self._reference("fp32"),
                       self.ctx0)


def norm_gap(a: torch.Tensor, b: torch.Tensor, floor: float) -> float:
    """|‖a‖ - ‖b‖| over the larger of ‖b‖ and ``floor``."""
    na, nb = float(a.norm()), float(b.norm())
    return abs(na - nb) / max(nb, floor)


def compare(prog: dict, ref: dict, ctx0: torch.Tensor) -> dict:
    """The numbers a train cell is judged by. One trained leaf (the
    context), so the median leaf is the leaf itself."""
    losses = np.array(prog["losses"], np.float64)
    rl = np.array(ref["losses"], np.float64)
    g_ref = ref["grad1"]
    return {
        "loss_gap": float(np.max(np.abs(losses - rl) / np.abs(rl))),
        "grad_gap": norm_gap(prog["grad1"], g_ref, 0.0),
        "change_gap": norm_gap(prog["ctx3"] - ctx0.float(),
                               ref["ctx3"] - ctx0.float(), 0.0),
    }
