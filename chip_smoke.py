#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure ends the run with a non-zero exit:

1. ``env``: torch/CUDA versions and the card (name, power limit).
2. ``build``: compiles every kernel under ``clip_calibration_tpu_torch/csrc``
   (one nvcc per source) into ``build/``.
3. ``main_path``: the port's CLI at full ViT-B/16 width and depth, bf16, on
   the seeded random init (no accuracy claim): ZeroshotCLIP on the base
   classes -> CoOp eval-only on the base classes -> CoOp on the new classes
   with DAC, on the synthetic dataset (100 classes, 16 shots). Asserts finite
   metrics and that every tower layer went through the forward kernel K1.
4. ``train_path``: the same CLI trains CoOp (vit_b16_c16_ep200_batch32.yaml
   cut to 2 epochs: 50 base classes x 16 shots, 25 steps of 32 an epoch),
   tests it on the base classes, then fits TempScaling (golden stage 4's
   swap, ep20_lr5e-2.yaml) on the trained model's base val split. Asserts
   finite losses, metrics and temperature, a changed context, the
   checkpoints, and that every text layer of every train step went
   through the backward kernel K2 (12 launches a step). The CoOp run
   traces its first 5 steps (``TPU.PROFILE_DIR``, a torch.profiler Chrome
   trace): the ``profile`` line lists their top 10 device kernels by total
   time with counts, and fails unless K1 and K2 (12 a step) are in it.
5. ``kernel``: each kernel against its plain PyTorch version on the card at
   every shape and mask the two paths gave it (both record every distinct
   (qkv shape, heads, dtype, mask)), in bf16 and fp32, with its time, the
   plain version's, one PyTorch library call's (a yardstick only; the port
   never calls it) and the least time the card could take (``bound_ms``);
   then correctness at edge shapes the paths do not reach.
6. ``serve_path``: the port's serve CLI at ViT-B/16 (bf16, random init)
   on 84 synthetic images at 224^2 (one full 64-image batch and a 32-row
   bucket) and on one image (the 1-row bucket), in four quantization modes:
   full precision, ``--quantize int8``, ``--quantize w8a8`` calibrating
   and saving static scales, ``--quantize w8a8 --act-scales`` (bit for bit
   the previous run); the CoOp checkpoint of ``train_path`` through
   ``--coop-prompt --quantize w8a8``; an HTTP server over a w8a8
   predictor answering concurrent single images and one JSON batch, held
   to direct ``predict``; one eval-only CoOp stage of the train CLI with
   ``TRAINER.QUANT_FROZEN_VISION w8a8``. Asserts finite outputs, K3
   launched 50 times per w8a8 image forward and K1 in every layer.
7. ``probe_path``: the port's int8 attention probe
   (``probe_int8_attention``) at its default full width (B 256, L 208,
   D 768, H 12), each variant on K4, one row a variant; asserts K4
   launched in every variant.
8. ``kernel int8_matmul``: K3 against its plain version (exact) at every
   (M, K, N) the serve path launched and at edge shapes, with its time,
   the plain version's, ``torch._int_mm``'s and the bound.
9. ``kernel int8_attention``: K4, each variant, against its plain version
   at the probe's shape and at edges (L 77 causal, L 197 unpadded, head
   dim 32, a batch of 1), with its time, the plain version's, SDPA's
   (fp32_scores only) and the bound.
10. ``tower_check``: the full-width ViT-B/16 towers on the card (kernel)
   against the same weights on the CPU (plain version), fp32.
11. ``train_check``: one CoOp loss and context gradient at full ViT-B/16
   width, fp32, on the card (K1 and K2) against the CPU (plain versions)
   with the same weights, context and batch.
12. ``serve_check``: the w8a8 ViT-B/16 vision tower with static scales on
   the card (K3) against the same int8 weights and scales on the CPU (the
   plain version), fp32, by the features' cosine similarity.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Without a card, or without the port's
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import os.path as osp
import re
import shutil
import sys
import time

ROOT = osp.dirname(osp.abspath(__file__))
WORK = osp.join(ROOT, "build", "chip_smoke")

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# FLOP/s by operand type (fp32 outside the tensor cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}

# kernel vs plain version, |diff| <= ATOL + RTOL * |plain|. fp32: the two
# sum in different orders and the kernel uses expf. bf16: the plain
# version (like the JAX code) rounds the normalised P to bf16 before P.V,
# the kernel the unnormalised one, and both round the output to bf16
# (2^-8 relative each).
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-2)}
# K2 vs its plain version, the same rule. fp32: summation order and expf.
# bf16: both round P and ds to bf16 before the products that use them, but
# from fp32 inputs that differ in summation order, so a rounding may flip
# (2^-8 relative) and sum over L terms; then the output's own bf16 rounding
TOL_BWD = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}
# the CoOp context gradient, card vs CPU, fp32: max |diff| / max |CPU|
# (sums in other orders through 12 + 12 layers, forward and backward)
TRAIN_GRAD_RTOL = 1e-3
# the w8a8 vision tower, card vs CPU, fp32, per image: 1 - cos(features).
# The int8 products are exact on both sides, but the float work between
# them (LayerNorm, attention, GELU) sums in other orders (~1e-7 relative),
# and a value on a rounding boundary of an activation quantization then
# moves by a whole int8 step; the seeded random tower amplifies those
# steps (serve_check prints how far 1e-7 relative noise after every
# LayerNorm moves it on the CPU alone: about 1e-4). Hence 1e-3; each w8a8
# product is also held bit for bit to the CPU on the card's own input
SERVE_COS_TOL = 1e-3


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)



def pad_mask(real: int, padded: int, causal: bool, device):
    """The towers' mask: causal or none over the real tokens, padded keys
    masked with finfo.min, padded rows attending to token 0 only."""
    import torch
    neg = torch.finfo(torch.float32).min
    m = torch.zeros((padded, padded), dtype=torch.float32, device=device)
    if causal:
        m[:real, :real] = torch.triu(torch.full((real, real), neg,
                                                device=device), diagonal=1)
    m[:, real:] = neg
    m[real:, :] = neg
    m[real:, 0] = 0.0
    return m


def _compare(kernel, plain, tol, *args):
    """(max |kernel - plain|, within tolerance and finite) on args."""
    import torch
    got = kernel(*args)
    torch.cuda.synchronize()
    want = plain(*args).float()
    diff = (got.float() - want).abs()
    atol, rtol = tol[str(args[0].dtype).split(".")[-1]]
    ok = bool(torch.isfinite(got.float()).all()) and bool(
        (diff <= atol + rtol * want.abs()).all())
    return float(diff.max()), ok


class Recorder:
    """Stands in for a kernel's entry point (``fn(qkv, mask, ..., heads)``)
    and records every distinct (qkv shape, heads, dtype, mask) it is
    called with, and how often: ``calls`` is a list of [shape, heads,
    dtype, mask, count]."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = []
        self._last = (None, None)  # the last call's mask tensor and entry

    def __call__(self, qkv, mask, *args):
        import torch
        key = [tuple(qkv.shape), args[-1], qkv.dtype]
        # the layers of one tower pass share one mask tensor: look it up
        # (one sync) once per pass
        if self._last[0] is not mask or self._last[1][:3] != key:
            entry = next((e for e in self.calls if e[:3] == key
                          and torch.equal(e[3], mask)), None)
            if entry is None:
                entry = key + [mask.clone(), 0]
                self.calls.append(entry)
            self._last = (mask, entry)
        self._last[1][4] += 1
        return self.fn(qkv, mask, *args)

    def count(self) -> int:
        return sum(c[4] for c in self.calls)

    # the wrapped kernel's launch counter, which it also bumps through
    # this stand-in when the stand-in replaces it in its own module
    @property
    def launches(self) -> int:
        return self.fn.launches

    @launches.setter
    def launches(self, value: int):
        self.fn.launches = value


def mask_kind(mask) -> tuple:
    """(kind, real length) of a tower mask: causal and/or pad. Real rows
    have a 0 on the diagonal, padded rows finfo.min."""
    real = int((mask.diagonal() == 0).sum())
    causal = mask.shape[0] > 1 and bool(mask[0, 1] < 0)
    pad = real < mask.shape[0]
    kind = "+".join(k for k, on in (("causal", causal), ("pad", pad)) if on)
    return kind or "none", real


# correctness-only shapes the paths do not reach: (B, real L, padded L,
# D, H, causal)
EDGES = [
    (3, 77, 77, 512, 8, True),       # text, unpadded: ragged tiles
    (2, 257, 257, 1024, 16, False),  # ViT-L/14, unpadded
    (2, 577, 592, 1024, 16, False),  # ViT-L/14@336px, padded
    (4, 17, 32, 64, 4, False),       # head dim 16 (ViT-Test text)
    (2, 50, 50, 256, 8, True),       # head dim 32
]


def check_kernels(device, launched):
    """K1 vs its plain version, timed, at every (qkv shape, heads, mask)
    the paths launched it with, in bf16 and fp32; then correctness only
    at the edges the paths do not reach (ragged L, other head dims, the
    ViT-L sequence lengths)."""
    import torch
    from clip_calibration_tpu_torch.ops.mha_qkv import (mha_qkv,
                                                        mha_qkv_reference)
    from clip_calibration_tpu_torch.tools.profiling import (L2_FLUSH_BYTES,
                                                            time_ms)
    F = torch.nn.functional
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    cases = []
    gen = torch.Generator(device=device).manual_seed(0)
    for (B, L, D3), H, main_dtype, mask, calls in launched:
        kind, real = mask_kind(mask)
        D = D3 // 3
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            qkv = torch.randn((B, L, D3), generator=gen, device=device,
                              dtype=torch.float32).to(dtype)
            err, ok = _compare(mha_qkv, mha_qkv_reference, TOL, qkv, mask, H)
            d = D // H
            q, k, v = qkv.view(B, L, 3, H, d).permute(2, 0, 3, 1, 4)
            elt = qkv.element_size()
            nbytes = qkv.numel() * elt + mask.numel() * 4 + B * L * D * elt
            flops = 4.0 * B * H * L * L * d
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dname] * 1e3
            rec = {
                "qkv": [B, L, D3], "heads": H, "mask": kind,
                "real_len": real, "dtype": dname,
                "main_path_launches": calls if dtype == main_dtype else 0,
                "max_abs_err": err, "atol": TOL[dname][0],
                "rtol": TOL[dname][1], "ok": ok,
                "ms": time_ms(lambda: mha_qkv(qkv, mask, H), flush),
                "plain_ms": time_ms(
                    lambda: mha_qkv_reference(qkv, mask, H), flush),
                "library_ms": time_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask.to(dtype)), flush),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "flops": flops,
            }
            emit("kernel mha_qkv_fwd", **rec)
            if not ok:
                raise AssertionError(
                    f"mha_qkv_fwd disagrees with its plain version: {rec}")
            cases.append(rec)
    del flush

    errors = []
    for B, real, L, D, H, causal in EDGES:
        mask = pad_mask(real, L, causal, device)
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn((B, L, 3 * D), generator=gen, device=device,
                              dtype=torch.float32).to(dtype)
            err, ok = _compare(mha_qkv, mha_qkv_reference, TOL, qkv, mask, H)
            errors.append({"qkv": [B, L, 3 * D], "heads": H,
                           "dtype": str(dtype).split(".")[-1],
                           "max_abs_err": err, "ok": ok})
    emit("kernel mha_qkv_fwd edges", cases=errors)
    if not all(e["ok"] for e in errors):
        raise AssertionError("mha_qkv_fwd disagrees with its plain version "
                             "at an edge shape")
    return cases


def check_towers(device):
    """ViT-B/16 encoders on the card vs the same weights on the CPU."""
    import torch
    from clip_calibration_tpu_torch.models import clip as M
    from clip_calibration_tpu_torch.models.backbone import load_clip_backbone
    from clip_calibration_tpu_torch.models.tokenizer import tokenize
    from clip_calibration_tpu_torch.models.weights import (flat_params,
                                                           params_from_numpy)
    model, cfg = load_clip_backbone("ViT-B/16", "float32", device)
    cpu_model = params_from_numpy(flat_params(model), cfg, torch.float32,
                                  "cpu")
    gen = torch.Generator().manual_seed(1)
    images = torch.randn((2, 224, 224, 3), generator=gen)
    toks = torch.as_tensor(tokenize(["a photo of a dog.",
                                     "a photo of a red swirl pattern."]),
                           dtype=torch.long)
    seq = M.eot_seq_len(toks.numpy())
    out = {}
    with torch.inference_mode():
        for name, fn in (
                ("image", lambda m, dev: M.encode_image(
                    m, cfg, images.to(dev), dtype=torch.float32)),
                ("text", lambda m, dev: M.encode_text(
                    m, cfg, toks.to(dev), dtype=torch.float32,
                    seq_len=seq))):
            got = M.normalize(fn(model, device)).cpu()
            want = M.normalize(fn(cpu_model, "cpu"))
            err = float((got - want).abs().max())
            out[name] = err
            if not (math.isfinite(err) and err <= 1e-3):
                raise AssertionError(
                    f"ViT-B/16 {name} tower on the card differs from the "
                    f"CPU by {err}")
    del model, cpu_model
    emit("tower_check", backbone="ViT-B/16", dtype="float32", atol=1e-3,
         max_abs_err=out)


def parse_result(log_path: str) -> dict:
    text = open(log_path).read()
    block = text[text.rindex("=> result"):]
    return {key: float(re.search(rf"\* {key}: (\d+\.\d+)%", block).group(1))
            for key in ("accuracy", "macro_f1", "ece", "mce", "ace",
                        "piece")}


def _cli_stage(name, args, log):
    """One run of the port's CLI with its console output sent to a file;
    returns (seconds, the log's path)."""
    import torch
    from clip_calibration_tpu_torch import train
    out_dir = args[args.index("--output-dir") + 1]
    t0 = time.perf_counter()
    with open(osp.join(WORK, name + ".console.txt"), "w") as con:
        sys.stdout = con
        try:
            train.main(train.build_parser().parse_args(args))
            torch.cuda.synchronize()
        finally:
            sys.stdout = sys.__stdout__
    return time.perf_counter() - t0, osp.join(out_dir, log)


def _checked_metrics(name, log_path):
    metrics = parse_result(log_path)
    if not all(math.isfinite(v) and 0.0 <= v <= 100.0
               for v in metrics.values()):
        raise AssertionError(f"{name}: bad metrics {metrics}")
    return metrics


def _common_args(seed):
    cfgs = osp.join(ROOT, "configs")
    return (["--root", osp.join(WORK, "data"), "--seed", str(seed),
             "--device", "cuda", "--dataset-config-file",
             osp.join(cfgs, "datasets", "synthetic.yaml")],
            ["--trainer", "CoOp", "--config-file",
             osp.join(cfgs, "trainers", "CoOp",
                      "vit_b16_c16_ep200_batch32.yaml")],
            ["DATASET.NUM_SHOTS", "16", "DATALOADER.TEST.BATCH_SIZE", "32"])


def run_main_path(k1):
    """Stages 1-3 through the port's CLI, K1's entry point recorded by
    ``k1``. Returns K1's launches."""
    import torch
    from clip_calibration_tpu_torch.engine.checkpoint import (
        export_torch_checkpoint)
    from clip_calibration_tpu_torch.models.clip import transformer
    from clip_calibration_tpu_torch.ops.mha_qkv import mha_qkv

    gen = torch.Generator().manual_seed(1)
    export_torch_checkpoint(
        {"ctx": torch.randn((16, 512), generator=gen) * 0.02}, 1,
        osp.join(WORK, "coop_model", "prompt_learner", "model.pth.tar-1"))
    common, coop, opts = _common_args(1)
    coop = coop + ["--model-dir", osp.join(WORK, "coop_model"),
                   "--eval-only", "--load-epoch", "1"]
    stages = [
        ("zsclip_base", "log.txt",
         ["--trainer", "ZeroshotCLIP", "--config-file",
          osp.join(ROOT, "configs", "trainers", "ZeroshotCLIP",
                   "vit_b16.yaml")],
         ["DATASET.SUBSAMPLE_CLASSES", "base"]),
        ("coop_base", "log.txt", coop, ["DATASET.SUBSAMPLE_CLASSES", "base"]),
        ("coop_new_dac", "log_dac.txt",
         coop + ["--calibration-config", json.dumps(
             {"BASE_CALIBRATION_MODE": None, "IF_DAC": True,
              "IF_PROCAL": False})],
         ["DATASET.SUBSAMPLE_CLASSES", "new"]),
    ]
    mha_qkv.launches = 0
    transformer.forwards = 0
    for name, log, args, extra in stages:
        launches0, forwards0 = mha_qkv.launches, transformer.forwards
        seconds, log_path = _cli_stage(
            name, common + args + ["--output-dir",
                                   osp.join(WORK, "out", name)]
            + opts + extra, log)
        emit("main_path", stage=name, seconds=seconds,
             weights="seeded random init (no accuracy claim)",
             tower_forwards=transformer.forwards - forwards0,
             launches=mha_qkv.launches - launches0,
             metrics=_checked_metrics(name, log_path))
    launches, forwards = mha_qkv.launches, transformer.forwards
    # ViT-B/16: 12 layers in each tower, one fused attention per layer
    if launches == 0 or launches != 12 * forwards:
        raise AssertionError(f"mha_qkv_fwd launched {launches} times for "
                             f"{forwards} tower forwards (want 12 each)")
    if k1.count() != launches:
        raise AssertionError("the recorded calls miss kernel launches")
    return launches


#: CoOp train steps that TPU.PROFILE_DIR traces in the train path
PROFILE_STEPS = 5


def step_profile(trace_dir: str) -> dict:
    """The traced CoOp steps' device kernels from the Chrome trace that
    ``TPU.PROFILE_DIR`` wrote: the top 10 by total time with their counts,
    the kernels' summed time, the trace's window and the share of it the
    card spent in kernels. Fails unless K1's and K2's kernels are in the
    trace and K2's two kernels ran 12 times a step (one per text layer)."""
    import glob
    paths = glob.glob(osp.join(trace_dir, "trace_*.json"))
    if len(paths) != 1:
        raise AssertionError(f"want one trace under {trace_dir}: {paths}")
    events = json.load(open(paths[0]))["traceEvents"]
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    kernels = [e for e in timed if e.get("cat") == "kernel"]
    by_name = {}
    for e in kernels:
        entry = by_name.setdefault(e["name"], [0, 0.0])
        entry[0] += 1
        entry[1] += e["dur"]
    window_us = (max(e["ts"] + e["dur"] for e in timed)
                 - min(e["ts"] for e in timed))
    kernel_us = sum(e["dur"] for e in kernels)
    counts = {want: sum(n for name, (n, _) in by_name.items()
                        if want + "<" in name)
              for want in ("mha_qkv_fwd_bf16", "mha_qkv_bwd_dq_bf16",
                           "mha_qkv_bwd_dkdv_bf16")}
    if not counts["mha_qkv_fwd_bf16"] or any(
            counts[k] != 12 * PROFILE_STEPS for k in (
                "mha_qkv_bwd_dq_bf16", "mha_qkv_bwd_dkdv_bf16")):
        raise AssertionError(f"the trace misses the port's kernels: "
                             f"{counts} ({len(by_name)} kernel names)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {"trace": osp.relpath(paths[0], ROOT), "steps": PROFILE_STEPS,
            "window_ms": window_us / 1e3, "kernel_ms": kernel_us / 1e3,
            "kernel_share_of_window": kernel_us / window_us,
            "kernel_launches": len(kernels), "port_kernel_counts": counts,
            "top_kernels": [{"name": name[:120], "count": n,
                             "total_ms": us / 1e3,
                             "share_of_kernel_time": us / kernel_us}
                            for name, (n, us) in top]}


def run_train_path(k1, k2):
    """CoOp training and the TempScaling fit through the port's CLI, K1's
    and K2's entry points recorded by ``k1`` and ``k2``. Returns (K1
    launches, K2 launches)."""
    import torch
    from clip_calibration_tpu_torch.engine.checkpoint import load_checkpoint
    from clip_calibration_tpu_torch.models.clip import transformer
    from clip_calibration_tpu_torch.ops.mha_qkv import mha_qkv, mha_qkv_bwd
    from clip_calibration_tpu_torch.trainers.coop import CoOp

    # seed 2: the stage-2 eval run's cached seed-1 base features stay out
    # of this run's calibration (the ZeroshotCLIP cache is seed 1 always)
    common, coop, opts = _common_args(2)
    train_dir = osp.join(WORK, "out", "coop_train")
    scale_dir = osp.join(WORK, "out", "coop_scaling")
    steps, init_ctx = [0], []
    build_model, forward_backward = CoOp.build_model, CoOp.forward_backward

    def counted_build(self):
        build_model(self)
        init_ctx.append(self.model_params("prompt_learner")["ctx"]
                        .detach().cpu().clone())

    def counted_step(self, batch):
        steps[0] += 1
        return forward_backward(self, batch)

    mha_qkv.launches = mha_qkv_bwd.launches = 0
    k1_before, k2_before = k1.count(), k2.count()
    CoOp.build_model, CoOp.forward_backward = counted_build, counted_step
    try:
        forwards0 = transformer.forwards
        seconds, log_path = _cli_stage(
            "coop_train", common + coop + ["--output-dir", train_dir] + opts
            + ["OPTIM.MAX_EPOCH", "2", "TRAIN.PRINT_FREQ", "1",
               "DATASET.SUBSAMPLE_CLASSES", "base",
               "TPU.PROFILE_DIR", osp.join(WORK, "profile"),
               "TPU.PROFILE_STEPS", str(PROFILE_STEPS)], "log.txt")
        train_launches = (mha_qkv.launches, mha_qkv_bwd.launches)
        text = open(log_path).read()
        losses = [float(x) for x in re.findall(r" loss (\S+) \(", text)]
        if len(losses) != steps[0] or not all(map(math.isfinite, losses)):
            raise AssertionError(f"coop_train: losses {losses} for "
                                 f"{steps[0]} steps")
        ckpt_path = osp.join(train_dir, "prompt_learner", "model.pth.tar-2")
        ctx = load_checkpoint(ckpt_path)["state_dict"]["ctx"]
        ctx_change = float((ctx.float() - init_ctx[0]).abs().max())
        if not ctx_change > 0:
            raise AssertionError("coop_train: the context did not change")
        # ViT-B/16 text tower: 12 layers, each one K2 launch a step
        if steps[0] != 50 or train_launches[1] != 12 * steps[0]:
            raise AssertionError(
                f"coop_train: {steps[0]} steps (want 50) launched "
                f"mha_qkv_bwd {train_launches[1]} times (want 12 each)")
        emit("train_path", stage="coop_train", seconds=seconds,
             weights="seeded random init (no accuracy claim)",
             steps=steps[0], first_loss=losses[0], last_loss=losses[-1],
             ctx_max_abs_change=ctx_change, checkpoint=ckpt_path,
             tower_forwards=transformer.forwards - forwards0,
             launches={"mha_qkv_fwd": train_launches[0],
                       "mha_qkv_bwd": train_launches[1]},
             metrics=_checked_metrics("coop_train", log_path))
        emit("profile", stage="coop_train",
             **step_profile(osp.join(WORK, "profile")))

        seconds, log_path = _cli_stage(
            "tempscaling", common + coop + [
                "--output-dir", scale_dir, "--base-dir", train_dir,
                "--calibration-config", json.dumps({
                    "BASE_CALIBRATION_MODE": "scaling_based",
                    "SCALING_CONFIG": osp.join(
                        ROOT, "configs", "calibration", "TempScaling",
                        "ep20_lr5e-2.yaml"),
                    "IF_DAC": False, "IF_PROCAL": False})] + opts
            + ["CALIBRATION.SCALING.BASE_EPOCH", "2", "TRAIN.PRINT_FREQ", "1",
               "DATASET.SUBSAMPLE_CLASSES", "base"], "log_TempScaling.txt")
        temps = [float(x) for x in re.findall(
            r"temperature (\S+) \(", open(log_path).read())]
        ckpt_path = osp.join(scale_dir, "scale_learner",
                             "model-calibrated.pth.tar-20")
        if not (temps and all(map(math.isfinite, temps))
                and osp.exists(ckpt_path)):
            raise AssertionError(f"tempscaling: temperatures {temps[-3:]}, "
                                 f"checkpoint {osp.exists(ckpt_path)}")
        emit("train_path", stage="tempscaling", seconds=seconds,
             scale_steps=len(temps), temperature=temps[-1],
             checkpoint=ckpt_path,
             launches={"mha_qkv_fwd": mha_qkv.launches - train_launches[0],
                       "mha_qkv_bwd": mha_qkv_bwd.launches
                       - train_launches[1]},
             metrics=_checked_metrics("tempscaling", log_path))
    finally:
        CoOp.build_model, CoOp.forward_backward = build_model, \
            forward_backward
    if (k1.count() - k1_before, k2.count() - k2_before) != (
            mha_qkv.launches, mha_qkv_bwd.launches):
        raise AssertionError("the recorded calls miss kernel launches")
    return mha_qkv.launches, mha_qkv_bwd.launches


def check_kernels_bwd(device, launched):
    """K2 vs its plain version, timed, at every (qkv shape, heads, mask)
    the train path launched it with, in bf16 and fp32, and at the ViT-B/16
    vision shape with its pad mask (a later slice's shape); then
    correctness only at the same edges as K1."""
    import torch
    from clip_calibration_tpu_torch.ops.mha_qkv import (
        mha_qkv_bwd, mha_qkv_bwd_reference)
    from clip_calibration_tpu_torch.tools.profiling import (L2_FLUSH_BYTES,
                                                            time_ms)
    cases = [(shape, H, dtype, mask, calls)
             for shape, H, dtype, mask, calls in launched]
    cases.append(((32, 208, 2304), 12, None, pad_mask(197, 208, False,
                                                      device), 0))
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device).manual_seed(2)
    out = []
    for (B, L, D3), H, main_dtype, mask, calls in cases:
        kind, real = mask_kind(mask)
        D = D3 // 3
        d = D // H
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            qkv = torch.randn((B, L, D3), generator=gen, device=device,
                              dtype=torch.float32).to(dtype)
            g = torch.randn((B, L, D), generator=gen, device=device,
                            dtype=torch.float32).to(dtype)
            err, ok = _compare(mha_qkv_bwd, mha_qkv_bwd_reference, TOL_BWD,
                               qkv, mask, g, H)
            # the library yardstick: SDPA's backward on the same q/k/v,
            # heads split (and the output gradient too) outside the window
            q, k, v = (t.detach().clone().requires_grad_() for t in
                       qkv.view(B, L, 3, H, d).permute(2, 0, 3, 1, 4))
            o = torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask.to(dtype))
            go = g.view(B, L, H, d).transpose(1, 2).contiguous()
            elt = qkv.element_size()
            nbytes = (2 * qkv.numel() + g.numel()) * elt + mask.numel() * 4
            flops = 10.0 * B * H * L * L * d
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dname] * 1e3
            rec = {
                "qkv": [B, L, D3], "heads": H, "mask": kind,
                "real_len": real, "dtype": dname,
                "main_path_launches": calls if dtype == main_dtype else 0,
                "max_abs_err": err, "atol": TOL_BWD[dname][0],
                "rtol": TOL_BWD[dname][1], "ok": ok,
                "ms": time_ms(lambda: mha_qkv_bwd(qkv, mask, g, H), flush),
                "plain_ms": time_ms(
                    lambda: mha_qkv_bwd_reference(qkv, mask, g, H), flush),
                "library_ms": time_ms(lambda: torch.autograd.grad(
                    o, (q, k, v), go, retain_graph=True), flush),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "flops": flops,
            }
            del o
            emit("kernel mha_qkv_bwd", **rec)
            if not ok:
                raise AssertionError(
                    f"mha_qkv_bwd disagrees with its plain version: {rec}")
            out.append(rec)
    del flush

    errors = []
    for B, real, L, D, H, causal in EDGES:
        mask = pad_mask(real, L, causal, device)
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn((B, L, 3 * D), generator=gen, device=device,
                              dtype=torch.float32).to(dtype)
            g = torch.randn((B, L, D), generator=gen, device=device,
                            dtype=torch.float32).to(dtype)
            err, ok = _compare(mha_qkv_bwd, mha_qkv_bwd_reference, TOL_BWD,
                               qkv, mask, g, H)
            errors.append({"qkv": [B, L, 3 * D], "heads": H,
                           "dtype": str(dtype).split(".")[-1],
                           "max_abs_err": err, "ok": ok})
    emit("kernel mha_qkv_bwd edges", cases=errors)
    if not all(e["ok"] for e in errors):
        raise AssertionError("mha_qkv_bwd disagrees with its plain version "
                             "at an edge shape")
    return out


def check_train_step(device):
    """One CoOp loss and context gradient at full ViT-B/16 width, fp32:
    on the card (K1 forward, K2 backward) vs the CPU (plain versions),
    same weights, context, prompts and 8 images."""
    import torch
    import torch.nn.functional as F
    from clip_calibration_tpu_torch.models import clip as M
    from clip_calibration_tpu_torch.models.backbone import load_clip_backbone
    from clip_calibration_tpu_torch.models.weights import (flat_params,
                                                           params_from_numpy)
    from clip_calibration_tpu_torch.trainers.coop import (
        assemble_prompts, build_prompt_assembly)
    model, cfg = load_clip_backbone("ViT-B/16", "float32", device)
    cpu_model = params_from_numpy(flat_params(model), cfg, torch.float32,
                                  "cpu")
    gen = torch.Generator().manual_seed(3)
    images = torch.randn((8, 224, 224, 3), generator=gen)
    labels = torch.randint(0, 10, (8,), generator=gen)
    ctx0 = torch.randn((16, 512), generator=gen) * 0.02
    names = ["red swirl", "green checker", "blue wave", "yellow dot",
             "purple stripe", "orange grid", "cyan blob", "magenta ring",
             "white noise", "dark cross"]
    grads, losses = {}, {}
    for dev, m in ((device, model), ("cpu", cpu_model)):
        asm = build_prompt_assembly(names, 16, "end", "", m, torch.float32)
        ctx = ctx0.to(dev).requires_grad_()
        txt = M.encode_text_embedded(m, cfg, assemble_prompts(ctx, asm),
                                     asm["eot_pos"], seq_len=asm["seq_len"])
        with torch.no_grad():
            img = M.encode_image(m, cfg, images.to(dev), dtype=torch.float32)
        loss = F.cross_entropy(M.cosine_logits(img, txt, m.logit_scale),
                               labels.to(dev))
        loss.backward()
        grads[str(dev)], losses[str(dev)] = ctx.grad.cpu(), float(loss.detach())
    want, got = grads["cpu"], grads[str(device)]
    rel = float((got - want).abs().max() / want.abs().max())
    emit("train_check", backbone="ViT-B/16", dtype="float32",
         loss={"card": losses[str(device)], "cpu": losses["cpu"]},
         grad_max_rel_diff=rel, rtol=TRAIN_GRAD_RTOL)
    if not (math.isfinite(rel) and rel <= TRAIN_GRAD_RTOL
            and float(want.abs().max()) > 0):
        raise AssertionError(f"CoOp ctx gradient on the card differs from "
                             f"the CPU by {rel} (relative)")


class ShapeRecorder:
    """Stands in for ``int8_matmul(x, w)`` and counts its calls by
    (M, K, N): ``calls`` maps the shape to the count."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = {}

    def __call__(self, x, w):
        key = (x.shape[0], x.shape[1], w.shape[1])
        self.calls[key] = self.calls.get(key, 0) + 1
        return self.fn(x, w)

    def count(self) -> int:
        return sum(self.calls.values())

    @property
    def launches(self) -> int:
        return self.fn.launches

    @launches.setter
    def launches(self, value: int):
        self.fn.launches = value


class ForwardCounter:
    """Stands in for ``models.clip.encode_image`` and counts its calls by
    qmode."""

    def __init__(self, fn):
        self.fn = fn
        self.by_qmode = {}

    def __call__(self, *args, **kwargs):
        q = kwargs.get("qmode", "dequant")
        self.by_qmode[q] = self.by_qmode.get(q, 0) + 1
        return self.fn(*args, **kwargs)

    def int8_forwards(self) -> int:
        return sum(n for q, n in self.by_qmode.items() if q != "dequant")


def _serve_images(n_test: int, n_cal: int):
    """224^2 PNGs of the synthetic dataset's classes (its 64^2 renders,
    bicubic-resized): ``n_test`` to serve (test samples), ``n_cal`` to
    calibrate on (train samples), one alone; returns the three dirs."""
    from PIL import Image
    from clip_calibration_tpu_torch.data.datasets.synthetic import _render
    dirs = {}
    for name, count, offset in (("imgs", n_test, 20), ("cal", n_cal, 0),
                                ("one", 1, 23)):
        d = osp.join(WORK, "serve", name)
        os.makedirs(d)
        for i in range(count):
            img = Image.fromarray(_render(i % 50, offset + i // 50))
            img.resize((224, 224), Image.BICUBIC).save(
                osp.join(d, f"img_{i:03d}.png"))
        dirs[name] = d
    return dirs


def _serve_cli(name, args):
    """One in-process run of the port's serve CLI, console to a file;
    returns (seconds, its JSONL rows)."""
    import torch
    from clip_calibration_tpu_torch import serve
    out = osp.join(WORK, "serve", name + ".jsonl")
    t0 = time.perf_counter()
    with open(osp.join(WORK, "serve", name + ".console.txt"), "w") as con:
        sys.stdout = con
        try:
            rc = serve.main(["--device", "cuda",
                             "--backbone", "ViT-B/16",
                             "--batch-size", "64", "--topk", "5",
                             "--out", out, *args])
            torch.cuda.synchronize()
        finally:
            sys.stdout = sys.__stdout__
    if rc != 0:
        raise AssertionError(f"serve CLI {name}: exit {rc}")
    rows = [json.loads(ln) for ln in open(out)]
    if not all(math.isfinite(r["confidence"]) and 0 < r["confidence"] <= 1
               and all(math.isfinite(t["prob"]) for t in r["topk"])
               for r in rows):
        raise AssertionError(f"serve CLI {name}: non-finite output")
    return time.perf_counter() - t0, rows


def _http_round(pred, classnames, images, blobs):
    """serve_http over ``pred``: 8 concurrent single images, then one JSON
    batch of 8; every answer held to a direct ``predict`` of the batch the
    server served it in (recorded by wrapping ``pred.predict``)."""
    import base64
    import threading
    import urllib.request
    from clip_calibration_tpu_torch.config import get_cfg_default
    from clip_calibration_tpu_torch.data.transforms import build_transform
    from clip_calibration_tpu_torch.http_server import serve_http
    served = []
    direct = pred.predict

    def recorded(batch):
        out = direct(batch)
        served.append((batch.copy(), out))
        return out

    pred.predict = recorded
    cfg = get_cfg_default()
    cfg.INPUT.INTERPOLATION = "bicubic"
    cfg.INPUT.SIZE = (224, 224)
    srv = serve_http(":0", pred, classnames,
                     build_transform(cfg, is_train=False), topk=1,
                     max_wait_ms=20.0, backbone="ViT-B/16")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    host, port = srv.server_address[:2]

    def post(body, ctype):
        req = urllib.request.Request(
            f"http://{host}:{port}/predict", data=body,
            headers={"Content-Type": ctype}, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    try:
        answers, errors = {}, []

        def hit(i):
            try:
                answers[i] = post(blobs[i], "image/png")
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(e)

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        body = json.dumps({"images": [base64.b64encode(b).decode()
                                      for b in blobs[8:16]]}).encode()
        batch_rows = post(body, "application/json")["predictions"]
        with urllib.request.urlopen(f"http://{host}:{port}/stats",
                                    timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        pred.predict = direct
    if errors or len(answers) != 8:
        raise AssertionError(f"HTTP requests failed: {errors}")
    # the server's batches, predicted again directly: the same bits
    for batch, out in served:
        again = direct(batch)
        if not np_equal(again["probs"], out["probs"]):
            raise AssertionError("HTTP batch differs from direct predict")

    def expected(img):
        for batch, out in served:
            for j in range(batch.shape[0]):
                if np_equal(batch[j], img):
                    return {"pred": classnames[int(out["preds"][j])],
                            "confidence": round(
                                float(out["confidences"][j]), 6)}
        raise AssertionError("an HTTP image was never served")

    got = [answers[i] for i in range(8)] + batch_rows
    for i, row in enumerate(got):
        if row != expected(images[i]):
            raise AssertionError(f"HTTP answer {i} {row} differs from "
                                 f"direct predict {expected(images[i])}")
    return {"requests": stats["requests"], "batches": stats["batches"],
            "mean_batch": stats["mean_batch"],
            "batch_sizes": [b.shape[0] for b, _ in served],
            "p50_latency_ms": stats["p50_latency_ms"]}


def np_equal(a, b) -> bool:
    import numpy as np
    return a.shape == b.shape and bool(np.array_equal(a, b))


def run_serve_path(k1, k3):
    """The serving slice at ViT-B/16 (see the module docstring), K1's and
    K3's entry points recorded by ``k1`` and ``k3``. Returns (K1
    launches, K3 launches)."""
    import numpy as np
    import torch
    from PIL import Image
    from clip_calibration_tpu_torch import serving
    from clip_calibration_tpu_torch.models import clip as M
    from clip_calibration_tpu_torch.ops.int8_matmul import int8_matmul
    from clip_calibration_tpu_torch.ops.mha_qkv import mha_qkv

    dirs = _serve_images(84, 16)
    from clip_calibration_tpu_torch.data.datasets.synthetic import _classname
    classnames = [_classname(c) for c in range(50)]
    names_file = osp.join(WORK, "serve", "classes.txt")
    with open(names_file, "w") as f:
        f.write("\n".join(classnames) + "\n")
    common = ["--classnames-file", names_file]
    scales = osp.join(WORK, "serve", "act_scales.npz")
    modes = [
        ("full", []),
        ("int8", ["--quantize", "int8"]),
        ("w8a8_calibrate", ["--quantize", "w8a8", "--calibration-images",
                            dirs["cal"]]),
        ("w8a8_act_scales", ["--quantize", "w8a8", "--act-scales", scales]),
    ]
    fwd = ForwardCounter(M.encode_image)
    probs = []
    predict = serving.Predictor.predict

    def recorded(self, images):
        out = predict(self, images)
        probs.append(out["probs"])
        return out

    mha_qkv.launches = int8_matmul.launches = 0
    forwards0 = M.transformer.forwards
    k1_before, k3_before = k1.count(), k3.count()
    M.encode_image, serving.Predictor.predict = fwd, recorded
    results = {}
    try:
        for name, flags in modes:
            extra = (["--save-act-scales", scales]
                     if name == "w8a8_calibrate" else [])
            int8_0, fwd_0 = int8_matmul.launches, fwd.int8_forwards()
            sec, rows = _serve_cli(name, common + flags + extra
                                   + ["--images", dirs["imgs"]])
            sec1, one = _serve_cli(name + "_b1", common + flags
                                   + ["--images", dirs["one"]])
            results[name] = {"rows": rows, "probs": probs[-2],
                             "probs_b1": probs[-1]}
            emit("serve_path", stage=name, seconds=sec, seconds_b1=sec1,
                 images=len(rows), weights="seeded random init (no "
                 "accuracy claim)", int8_image_forwards=fwd.int8_forwards()
                 - fwd_0, launches={"int8_matmul": int8_matmul.launches
                                    - int8_0},
                 first=rows[0], b1=one[0])
        a, b = results["w8a8_calibrate"], results["w8a8_act_scales"]
        if not (np_equal(a["probs"], b["probs"])
                and np_equal(a["probs_b1"], b["probs_b1"])
                and a["rows"] == b["rows"]):
            raise AssertionError("--act-scales run differs from the run "
                                 "that calibrated and saved the scales")
        top1 = [r["pred"] for r in results["full"]["rows"]]
        agree = {m: float(np.mean([r["pred"] == t for r, t in zip(
            results[m]["rows"], top1)])) for m in results}
        emit("serve_path", stage="agreement",
             top1_agreement_with_full_precision=agree,
             w8a8_act_scales_equal_to_calibrate="bit for bit",
             note="random weights: agreement is no accuracy claim")

        int8_0 = int8_matmul.launches
        sec, rows = _serve_cli("coop_prompt_w8a8", common + [
            "--quantize", "w8a8", "--act-scales", scales,
            "--checkpoint-dir", osp.join(WORK, "out", "coop_train"),
            "--coop-prompt", "--epoch", "2", "--images", dirs["imgs"]])
        emit("serve_path", stage="coop_prompt_w8a8", seconds=sec,
             images=len(rows), launches={"int8_matmul":
                                         int8_matmul.launches - int8_0},
             first=rows[0])

        int8_0 = int8_matmul.launches
        t0 = time.perf_counter()
        with open(osp.join(WORK, "serve", "http.console.txt"), "w") as con:
            sys.stdout = con
            try:
                pred = serving.Predictor(
                    "ViT-B/16", classnames, quantize="w8a8",
                    act_scales=scales, batch_size=64, device="cuda")
            finally:
                sys.stdout = sys.__stdout__
        paths = sorted(os.listdir(dirs["imgs"]))[:16]
        blobs = [open(osp.join(dirs["imgs"], p), "rb").read() for p in paths]
        images = [np.asarray(Image.open(osp.join(dirs["imgs"], p))
                             .convert("RGB")) for p in paths]
        http = _http_round(pred, classnames, images, blobs)
        torch.cuda.synchronize()
        emit("serve_path", stage="http", seconds=time.perf_counter() - t0,
             launches={"int8_matmul": int8_matmul.launches - int8_0},
             **http)

        common_t, coop, opts = _common_args(1)
        int8_0, fwd_0 = int8_matmul.launches, fwd.int8_forwards()
        seconds, log_path = _cli_stage(
            "coop_base_w8a8", common_t + coop + [
                "--model-dir", osp.join(WORK, "coop_model"), "--eval-only",
                "--load-epoch", "1", "--output-dir",
                osp.join(WORK, "out", "coop_base_w8a8")] + opts
            + ["DATASET.SUBSAMPLE_CLASSES", "base",
               "TRAINER.QUANT_FROZEN_VISION", "w8a8"], "log.txt")
        emit("serve_path", stage="coop_base_quant_frozen_vision_w8a8",
             seconds=seconds, int8_image_forwards=fwd.int8_forwards() - fwd_0,
             launches={"int8_matmul": int8_matmul.launches - int8_0},
             metrics=_checked_metrics("coop_base_w8a8", log_path))
    finally:
        M.encode_image, serving.Predictor.predict = fwd.fn, predict
    # one fused attention per layer of every tower forward; int8 matmuls
    # per w8a8 image forward: 4 in each block, the patch embedding and the
    # projection (ViT-B/16: 50)
    layers = M.PRESETS["ViT-B/16"].vision_layers
    forwards = M.transformer.forwards - forwards0
    if mha_qkv.launches != layers * forwards or forwards == 0:
        raise AssertionError(f"mha_qkv_fwd launched {mha_qkv.launches} times "
                             f"for {forwards} tower forwards (want "
                             f"{layers} each)")
    w8a8_forwards = fwd.int8_forwards()
    if int8_matmul.launches != (4 * layers + 2) * w8a8_forwards \
            or w8a8_forwards == 0:
        raise AssertionError(
            f"int8_matmul launched {int8_matmul.launches} times for "
            f"{w8a8_forwards} w8a8 image forwards (want {4 * layers + 2} "
            f"each)")
    if (k1.count() - k1_before, k3.count() - k3_before) != (
            mha_qkv.launches, int8_matmul.launches):
        raise AssertionError("the recorded calls miss kernel launches")
    emit("serve_path", stage="totals", tower_forwards=forwards,
         w8a8_image_forwards=w8a8_forwards,
         image_forwards_by_qmode=fwd.by_qmode,
         launches={"mha_qkv_fwd": mha_qkv.launches,
                   "int8_matmul": int8_matmul.launches})
    return mha_qkv.launches, int8_matmul.launches


# correctness and time at shapes the serve path does not reach: (M, K, N)
K3_EDGES = [
    (33, 70, 129),              # every dimension ragged, no vector loads
    (8, 8, 8),                  # smaller than one tile
    (1, 768, 2304),             # M = 1
    (64 * 272, 1024, 3072),     # ViT-L/14 at batch 64: wqkv
    (64 * 272, 1024, 4096),     # ViT-L/14: w_fc
    (64 * 272, 4096, 1024),     # ViT-L/14: w_proj
]


def check_int8_matmul(device, launched):
    """K3 against its plain version (exact) at every (M, K, N) the serve
    path launched and at ``K3_EDGES``: its time, the plain version's,
    ``torch._int_mm``'s (cuBLASLt, a yardstick the port never calls;
    null where its shape rules refuse) and the bound."""
    import torch
    from clip_calibration_tpu_torch.ops.int8_matmul import (
        int8_matmul, int8_matmul_reference)
    from clip_calibration_tpu_torch.tools.profiling import (L2_FLUSH_BYTES,
                                                            time_ms)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device).manual_seed(4)
    cases = [(shape, n) for shape, n in sorted(launched.items())] + \
        [(shape, 0) for shape in K3_EDGES if shape not in launched]
    out = []
    for (M, K, N), calls in cases:
        x = torch.randint(-127, 128, (M, K), generator=gen, device=device,
                          dtype=torch.int32).to(torch.int8)
        w = torch.randint(-127, 128, (K, N), generator=gen, device=device,
                          dtype=torch.int32).to(torch.int8)
        got = int8_matmul(x, w)
        torch.cuda.synchronize()
        want = int8_matmul_reference(x, w)
        exact = bool(torch.equal(got, want))
        err = float((got.double() - want.double()).abs().max())
        try:
            torch._int_mm(x, w)
            library_ms = time_ms(lambda: torch._int_mm(x, w), flush)
        except RuntimeError:
            library_ms = None
        nbytes = M * K + K * N + 4 * M * N
        ops = 2.0 * M * N * K
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_FLOPS["int8"] * 1e3
        rec = {"mkn": [M, K, N], "main_path_launches": calls,
               "exact": exact, "max_abs_err": err,
               "ms": time_ms(lambda: int8_matmul(x, w), flush),
               "plain_ms": time_ms(lambda: int8_matmul_reference(x, w),
                                   flush),
               "library_ms": library_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "ops": ops}
        emit("kernel int8_matmul", **rec)
        if not exact:
            raise AssertionError(
                f"int8_matmul disagrees with its plain version: {rec}")
        out.append(rec)
    del flush
    return out


def check_serve_tower(device):
    """The w8a8 ViT-B/16 vision tower with static scales calibrated on the
    card: features on the card (K3) vs the same int8 weights and scales
    on the CPU (plain version), fp32, 2 images; and each of the tower's
    50 w8a8 products (quantize, K3, rescale) on the CPU from the card's
    own input, bit for bit."""
    import torch
    from clip_calibration_tpu_torch.models import clip as M
    from clip_calibration_tpu_torch.models.backbone import load_clip_backbone
    from clip_calibration_tpu_torch.models.weights import (flat_params,
                                                           params_from_numpy)
    from clip_calibration_tpu_torch.ops import attention
    from clip_calibration_tpu_torch.ops import quant as Q
    model, cfg = load_clip_backbone("ViT-B/16", "float32", device)
    gen = torch.Generator().manual_seed(5)
    images = torch.randn((2, 224, 224, 3), generator=gen)
    products = []

    def recorded(x, w, qmode="dequant"):
        out = Q.qdot(x, w, qmode)
        products.append((x.cpu(), Q.QuantizedWeight(
            w.int8.cpu(), w.scale.cpu(), w.act_scale.cpu()), out.cpu()))
        return out

    with torch.inference_mode():
        qm = Q.quantize_clip_params(model)
        qm = Q.attach_act_scales(qm, Q.calibrate_image_act_scales(
            qm, cfg, images.to(device)))
        cpu = params_from_numpy(flat_params(qm), cfg, torch.float32, "cpu")
        M.qdot = attention.qdot = recorded
        try:
            got = M.normalize(M.encode_image(qm, cfg, images.to(device),
                                             dtype=torch.float32,
                                             qmode="w8a8")).cpu()
        finally:
            M.qdot = attention.qdot = Q.qdot
        want = M.normalize(M.encode_image(cpu, cfg, images,
                                          dtype=torch.float32, qmode="w8a8"))
        equal = sum(bool(torch.equal(Q.qdot(x, w, "w8a8"), out))
                    for x, w, out in products)
        # the tower's sensitivity to float rounding, on the CPU alone: 1e-7
        # relative noise after every LayerNorm (the reason for the
        # tolerance)
        noise = torch.Generator().manual_seed(6)
        layer_norm = attention.layer_norm

        def noisy(*args):
            y = layer_norm(*args)
            return y * (1 + 1e-7 * torch.randn(y.shape, generator=noise))

        M.layer_norm = attention.layer_norm = noisy
        try:
            perturbed = M.normalize(M.encode_image(
                cpu, cfg, images, dtype=torch.float32, qmode="w8a8"))
        finally:
            M.layer_norm = attention.layer_norm = layer_norm
    cos = (got * want).sum(-1)
    worst = float(1.0 - cos.min())
    emit("serve_check", backbone="ViT-B/16", dtype="float32",
         qmode="w8a8 (static scales)", one_minus_cos=[float(1 - c)
                                                      for c in cos],
         tol=SERVE_COS_TOL, products=len(products),
         products_bit_equal_to_cpu=equal,
         cpu_one_minus_cos_under_1e7_layernorm_noise=[
             float(1 - c) for c in (want * perturbed).sum(-1)])
    del model, qm, cpu, products
    if not (math.isfinite(worst) and worst <= SERVE_COS_TOL):
        raise AssertionError(f"w8a8 tower on the card differs from the CPU: "
                             f"1 - cos = {worst}")
    if equal != 50:
        raise AssertionError(f"{50 - equal} of 50 w8a8 products on the card "
                             f"differ from the CPU on the same input")


def run_probe_path():
    """K4's path: the probe's entry point (``probe_int8_attention.run``)
    at its default full-width shape (B 256, L 208, D 768, H 12: 327.3 MB
    read and written a call), every variant on the card, console to a
    file. Returns (K4 launches, the probe's rows)."""
    from clip_calibration_tpu_torch import probe_int8_attention as probe
    from clip_calibration_tpu_torch.ops.int8_attention import (
        VARIANTS, int8_attention)
    int8_attention.launches = 0
    t0 = time.perf_counter()
    with open(osp.join(WORK, "probe.console.txt"), "w") as con:
        sys.stdout = con
        try:
            rows = probe.run(*probe.DEFAULT_SHAPE, "cuda")
        finally:
            sys.stdout = sys.__stdout__
    seconds = time.perf_counter() - t0
    launches = int8_attention.launches
    for row in rows:
        emit("probe_path", **row)
    if ([r["variant"] for r in rows] != list(VARIANTS)
            or any(r["launches"] == 0 for r in rows)
            or sum(r["launches"] for r in rows) != launches):
        raise AssertionError(f"the probe did not launch K4 in every "
                             f"variant: {rows} ({launches} launches)")
    if not all(math.isfinite(r["max_abs_diff_vs_fp32"])
               and 0 < r["max_abs_diff_vs_fp32"] < 1 for r in rows[1:]):
        raise AssertionError(f"probe deltas out of range: {rows}")
    emit("probe_path", stage="totals", seconds=seconds,
         shape=list(probe.DEFAULT_SHAPE), launches=launches)
    return launches, rows


# K4 cases beyond the probe's shape: (B, L, D, H, real length, causal)
K4_EDGES = [
    (4, 77, 512, 8, 77, True),       # L 77, causal (the text tower's)
    (3, 197, 768, 12, 197, False),   # L 197, no padding, no mask
    (2, 208, 384, 12, 197, False),   # head dim 32: 1/sqrt(d) not 2^-k
    (1, 208, 768, 12, 197, False),   # a batch of 1
]


def k4_tolerance(qkv, want, variant):
    """|K4 - its plain version| allowed, per output element (the rule of
    tests/test_torch_int8_attention.py). fp32_scores and int8_qk: 2 bf16
    ulps of max |plain| (the two take sums and exp in other orders, so a
    P may round to the neighbouring bf16, and so may the output).
    int8_qk_pv: 2 sv of the output's column (sv = its max |v| / 127):
    one p on the other side of a rounding boundary of round(p * 127)
    moves the output by at most sv."""
    D = qkv.shape[-1] // 3
    if variant == "int8_qk_pv":
        return 2 * qkv[..., 2 * D:].float().abs().amax(dim=1,
                                                       keepdim=True) / 127
    top = float(want.float().abs().max())
    return 2 * 2.0 ** (math.floor(math.log2(top)) - 7)


def check_int8_attention(device, probe_launches):
    """K4 against its plain version, each variant, at the probe's shape
    (its main-path launches: ``probe_launches`` by variant) and at
    ``K4_EDGES``, with its time, the plain version's, SDPA's with the
    float mask for fp32_scores (no PyTorch call computes the int8
    variants: null) and the bound. The bound's operations: QK^T and P.V,
    2 B H L^2 d each, at the peak of the type each variant uses."""
    import torch
    from clip_calibration_tpu_torch.ops.int8_attention import (
        VARIANTS, int8_attention, int8_attention_reference)
    from clip_calibration_tpu_torch.probe_int8_attention import (
        DEFAULT_SHAPE, PAD_FROM, probe_inputs)
    from clip_calibration_tpu_torch.tools.profiling import (L2_FLUSH_BYTES,
                                                            time_ms)
    F = torch.nn.functional
    neg = torch.finfo(torch.float32).min
    types = {"fp32_scores": ("bfloat16", "bfloat16"),
             "int8_qk": ("int8", "bfloat16"), "int8_qk_pv": ("int8", "int8")}
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    out = []
    cases = [(*DEFAULT_SHAPE, PAD_FROM, False)] + K4_EDGES
    for i, (B, L, D, H, real, causal) in enumerate(cases):
        qkv, _ = probe_inputs(B, L, D, device, seed=i)
        mask = torch.zeros((L, L), dtype=torch.float32, device=device)
        if causal:
            mask = torch.triu(torch.full((L, L), neg, device=device), 1)
        mask[:, real:] = neg
        kind = "+".join(k for k, on in (("causal", causal),
                                        ("pad", real < L)) if on) or "none"
        d = D // H
        q, k, v = qkv.view(B, L, 3, H, d).permute(2, 0, 3, 1, 4)
        nbytes = qkv.numel() * 2 + mask.numel() * 4 + B * L * D * 2
        product_ops = 2.0 * B * H * L * L * d  # QK^T; P.V the same
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        for variant in VARIANTS:
            got = int8_attention(qkv, mask, H, variant)
            torch.cuda.synchronize()
            want = int8_attention_reference(qkv, mask, H, variant)
            diff = (got.float() - want.float()).abs()
            tol = k4_tolerance(qkv, want, variant)
            ok = bool(torch.isfinite(got.float()).all()) and bool(
                (diff <= tol).all())
            t_ops = sum(product_ops / PEAK_FLOPS[t]
                        for t in types[variant]) * 1e3
            library_ms = (time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask.to(qkv.dtype)), flush)
                if variant == "fp32_scores" else None)
            rec = {
                "qkv": [B, L, 3 * D], "heads": H, "mask": kind,
                "real_len": real, "variant": variant, "dtype": "bfloat16",
                "main_path_launches": probe_launches[variant] if i == 0
                else 0,
                "max_abs_err": float(diff.max()),
                "max_err_over_tol": float((diff / tol).max()),
                "tol": ("2 sv of the column" if variant == "int8_qk_pv"
                        else "2 bf16 ulps of max |plain|"), "ok": ok,
                "ms": time_ms(lambda: int8_attention(qkv, mask, H, variant),
                              flush),
                "plain_ms": time_ms(lambda: int8_attention_reference(
                    qkv, mask, H, variant), flush),
                "library_ms": library_ms,
                "library": ("scaled_dot_product_attention, float mask"
                            if library_ms is not None else
                            "null: no PyTorch call computes int8 products "
                            "inside attention"),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "ops": 2 * product_ops,
            }
            emit("kernel int8_attention", **rec)
            if not ok:
                raise AssertionError(
                    f"int8_attention disagrees with its plain version: {rec}")
            out.append(rec)
    del flush
    return out


def _kernel_entry(name, source, replaces, launches, cases, **extra):
    # the top-level numbers: the case the main path launched most often,
    # ties going to the one that moves the most bytes
    main_case = max(cases, key=lambda c: (c["main_path_launches"],
                                          c["bytes"]))
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            **{k: main_case[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")},
            **extra, "cases": cases}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs the card",
              file=sys.stderr)
        return 2
    if not osp.isdir(osp.join(ROOT, "clip_calibration_tpu_torch")):
        print("chip_smoke: clip_calibration_tpu_torch/ is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # plain fp32 references must be full fp32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from clip_calibration_tpu_torch.tools.profiling import nvidia_smi
    device = torch.device("cuda", 0)
    smi = nvidia_smi()
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         nvidia_smi=smi)

    from clip_calibration_tpu_torch.ops import attention, build
    from clip_calibration_tpu_torch.ops import int8_matmul as int8_ops
    from clip_calibration_tpu_torch.ops import mha_qkv as kernels
    seconds = build.build()
    ptxas = {name: [ln.strip() for ln in
                    open(build.log_path(name)).read().splitlines()
                    if "registers" in ln or "spill" in ln]
             for name in build.SOURCES} if seconds else {}
    emit("build", seconds=seconds, kernels=sorted(build.SOURCES),
         ptxas=ptxas)

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(osp.join(WORK, "no_weights"))
    os.environ.update({
        "CC_SYNTH_CLASSES": "100", "CC_SYNTH_TRAIN": "16",
        "CC_SYNTH_VAL": "4", "CC_SYNTH_TEST": "4",
        # an empty weight dir: the seeded random init, printed as such
        "CLIP_CHECKPOINT_DIR": osp.join(WORK, "no_weights"),
    })
    k1 = Recorder(kernels.mha_qkv)
    k2 = Recorder(kernels.mha_qkv_bwd)
    k3 = ShapeRecorder(int8_ops.int8_matmul)
    old_cwd = os.getcwd()
    os.chdir(WORK)  # the ./temp feature caches are cwd-relative
    attention.mha_qkv, kernels.mha_qkv_bwd, int8_ops.int8_matmul = k1, k2, k3
    try:
        k1_main = run_main_path(k1)
        k1_train, k2_train = run_train_path(k1, k2)
        k1_serve, k3_serve = run_serve_path(k1, k3)
        k4_probe, probe_rows = run_probe_path()
    finally:
        attention.mha_qkv, kernels.mha_qkv_bwd, int8_ops.int8_matmul = \
            k1.fn, k2.fn, k3.fn
        os.chdir(old_cwd)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    seconds = {}

    def timed(check, *args):
        t0 = time.perf_counter()
        out = check(*args)
        seconds[check.__name__] = time.perf_counter() - t0
        return out

    cases_fwd = timed(check_kernels, device, k1.calls)
    cases_bwd = timed(check_kernels_bwd, device, k2.calls)
    cases_int8 = timed(check_int8_matmul, device, k3.calls)
    cases_k4 = timed(check_int8_attention, device,
                     {r["variant"]: r["launches"] for r in probe_rows})
    timed(check_towers, device)
    timed(check_train_step, device)
    timed(check_serve_tower, device)
    emit("check_seconds", **seconds)

    print(json.dumps({"kernels": [
        _kernel_entry(
            "mha_qkv_fwd", "clip_calibration_tpu_torch/csrc/mha_qkv_fwd.cu",
            "clip_calibration_tpu/ops/pallas_attention.py:36",
            k1_main + k1_train + k1_serve, cases_fwd,
            launches_by_path={"main_path": k1_main, "train_path": k1_train,
                              "serve_path": k1_serve,
                              "probe_path": 0}),
        _kernel_entry(
            "mha_qkv_bwd", "clip_calibration_tpu_torch/csrc/mha_qkv_bwd.cu",
            "clip_calibration_tpu/ops/pallas_attention.py:94",
            k2_train, cases_bwd,
            launches_by_path={"main_path": 0, "train_path": k2_train,
                              "serve_path": 0,
                              "probe_path": 0}),
        _kernel_entry(
            "int8_matmul", "clip_calibration_tpu_torch/csrc/int8_matmul.cu",
            "clip_calibration_tpu/ops/pallas_int8_matmul.py:35",
            k3_serve, cases_int8,
            launches_by_path={"main_path": 0, "train_path": 0,
                              "serve_path": k3_serve, "probe_path": 0}),
        _kernel_entry(
            "int8_attention",
            "clip_calibration_tpu_torch/csrc/int8_attention.cu",
            "benchmarks/probe_int8_attention.py:69", k4_probe, cases_k4,
            launches_by_path={"main_path": 0, "train_path": 0,
                              "serve_path": 0, "probe_path": k4_probe},
            variants={c["variant"]: {k: c[k] for k in (
                "main_path_launches", "max_abs_err", "ms", "plain_ms",
                "library_ms", "bound_ms", "bound_by")}
                for c in cases_k4 if c["main_path_launches"]}),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
