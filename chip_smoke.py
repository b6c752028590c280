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
   metrics and that every tower layer went through the kernel, and records
   every distinct (qkv shape, heads, dtype, mask) the kernel was given.
4. ``kernel``: each kernel against its plain PyTorch version on the card at
   every shape and mask the main path gave it, in bf16 and fp32, with its
   time, the plain version's, one PyTorch library call's (a yardstick only;
   the port never calls it) and the least time the card could take
   (``bound_ms``); then correctness at edge shapes the main path does not
   reach.
5. ``tower_check``: the full-width ViT-B/16 towers on the card (kernel)
   against the same weights on the CPU (plain version), fp32.

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
import statistics
import subprocess
import sys
import time

ROOT = osp.dirname(osp.abspath(__file__))
WORK = osp.join(ROOT, "build", "chip_smoke")

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# FLOP/s by operand type (fp32 outside the tensor cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# kernel vs plain version, |diff| <= ATOL + RTOL * |plain|. fp32: the two
# sum in different orders and the kernel uses expf. bf16: the plain
# version (like the JAX code) rounds the normalised P to bf16 before P.V,
# the kernel the unnormalised one, and both round the output to bf16
# (2^-8 relative each).
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-2)}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


# written between timed calls: 5x the H100's 50 MB L2, so every timed
# call reads its inputs from device memory, as bound_ms assumes
L2_FLUSH_BYTES = 256 << 20


def time_ms(fn, flush, repeats: int = 25) -> float:
    """Device time of one call with cold inputs: median over ``repeats``
    of the CUDA-event time around one call, each after ``flush`` (a
    tensor larger than L2) is overwritten. A sleep kernel keeps the card
    busy while the host queues the calls, so the host's launch overhead
    is not in the number."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(repeats)]
    torch.cuda._sleep(20_000_000)  # ~10 ms of device time
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


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


def _compare(qkv, mask, heads):
    """(max |kernel - plain|, within tolerance and finite)."""
    import torch
    from clip_calibration_tpu_torch.ops.mha_qkv import (mha_qkv,
                                                        mha_qkv_reference)
    got = mha_qkv(qkv, mask, heads)
    torch.cuda.synchronize()
    want = mha_qkv_reference(qkv, mask, heads).float()
    diff = (got.float() - want).abs()
    atol, rtol = TOL[str(qkv.dtype).split(".")[-1]]
    ok = bool(torch.isfinite(got.float()).all()) and bool(
        (diff <= atol + rtol * want.abs()).all())
    return float(diff.max()), ok


def mask_kind(mask) -> tuple:
    """(kind, real length) of a tower mask: causal and/or pad. Real rows
    have a 0 on the diagonal, padded rows finfo.min."""
    real = int((mask.diagonal() == 0).sum())
    causal = mask.shape[0] > 1 and bool(mask[0, 1] < 0)
    pad = real < mask.shape[0]
    kind = "+".join(k for k, on in (("causal", causal), ("pad", pad)) if on)
    return kind or "none", real


def check_kernels(device, launched):
    """K1 vs its plain version, timed, at every (qkv shape, heads, mask)
    the main path launched it with, in bf16 and fp32; then correctness
    only at the edges the main path does not reach (ragged L, other head
    dims, the ViT-L sequence lengths)."""
    import torch
    from clip_calibration_tpu_torch.ops.mha_qkv import (mha_qkv,
                                                        mha_qkv_reference)
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
            err, ok = _compare(qkv, mask, H)
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

    edges = [  # (B, real L, padded L, D, H, causal)
        (3, 77, 77, 512, 8, True),      # text, unpadded: ragged tiles
        (2, 257, 257, 1024, 16, False),  # ViT-L/14, unpadded
        (2, 577, 592, 1024, 16, False),  # ViT-L/14@336px, padded
        (4, 17, 32, 64, 4, False),       # head dim 16 (ViT-Test text)
        (2, 50, 50, 256, 8, True),       # head dim 32
    ]
    errors = []
    for B, real, L, D, H, causal in edges:
        mask = pad_mask(real, L, causal, device)
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn((B, L, 3 * D), generator=gen, device=device,
                              dtype=torch.float32).to(dtype)
            err, ok = _compare(qkv, mask, H)
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


def run_main_path():
    """Stages 1-3 through the port's CLI. Returns the kernel's launches
    and every distinct call it got: [(qkv shape, heads, dtype, mask,
    calls)]."""
    import torch
    from clip_calibration_tpu_torch import train
    from clip_calibration_tpu_torch.engine.checkpoint import (
        export_torch_checkpoint)
    from clip_calibration_tpu_torch.models.clip import transformer
    from clip_calibration_tpu_torch.ops import attention
    from clip_calibration_tpu_torch.ops.mha_qkv import mha_qkv

    launched = []  # [qkv shape, heads, dtype, mask, calls]
    last = [None, None]  # the last call's mask tensor and its entry

    def recorded(qkv, mask, n_heads):
        key = [tuple(qkv.shape), n_heads, qkv.dtype]
        # the layers of one tower forward share one mask tensor: look it
        # up (one sync) once per forward
        if last[0] is not mask or last[1][:3] != key:
            entry = next((e for e in launched if e[:3] == key
                          and torch.equal(e[3], mask)), None)
            if entry is None:
                entry = key + [mask.clone(), 0]
                launched.append(entry)
            last[:] = [mask, entry]
        last[1][4] += 1
        return mha_qkv(qkv, mask, n_heads)

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(osp.join(WORK, "no_weights"))
    os.environ.update({
        "CC_SYNTH_CLASSES": "100", "CC_SYNTH_TRAIN": "16",
        "CC_SYNTH_VAL": "4", "CC_SYNTH_TEST": "4",
        # an empty weight dir: the seeded random init, printed as such
        "CLIP_CHECKPOINT_DIR": osp.join(WORK, "no_weights"),
    })
    gen = torch.Generator().manual_seed(1)
    export_torch_checkpoint(
        {"ctx": torch.randn((16, 512), generator=gen) * 0.02}, 1,
        osp.join(WORK, "coop_model", "prompt_learner", "model.pth.tar-1"))

    cfgs = osp.join(ROOT, "configs")
    common = ["--root", osp.join(WORK, "data"), "--seed", "1",
              "--device", "cuda", "--dataset-config-file",
              osp.join(cfgs, "datasets", "synthetic.yaml")]
    opts = ["DATASET.NUM_SHOTS", "16", "DATALOADER.TEST.BATCH_SIZE", "32"]
    coop = ["--trainer", "CoOp", "--config-file",
            osp.join(cfgs, "trainers", "CoOp",
                     "vit_b16_c16_ep200_batch32.yaml"),
            "--model-dir", osp.join(WORK, "coop_model"), "--eval-only",
            "--load-epoch", "1"]
    stages = [
        ("zsclip_base", "log.txt",
         ["--trainer", "ZeroshotCLIP", "--config-file",
          osp.join(cfgs, "trainers", "ZeroshotCLIP", "vit_b16.yaml")],
         ["DATASET.SUBSAMPLE_CLASSES", "base"]),
        ("coop_base", "log.txt", coop, ["DATASET.SUBSAMPLE_CLASSES", "base"]),
        ("coop_new_dac", "log_dac.txt",
         coop + ["--calibration-config", json.dumps(
             {"BASE_CALIBRATION_MODE": None, "IF_DAC": True,
              "IF_PROCAL": False})],
         ["DATASET.SUBSAMPLE_CLASSES", "new"]),
    ]

    old_cwd = os.getcwd()
    os.chdir(WORK)  # the ./temp feature caches are cwd-relative
    attention.mha_qkv = recorded
    mha_qkv.launches = 0
    transformer.forwards = 0
    try:
        for name, log, args, extra in stages:
            launches0, forwards0 = mha_qkv.launches, transformer.forwards
            out_dir = osp.join(WORK, "out", name)
            t0 = time.perf_counter()
            # the CLI's console output goes to a file, its log as usual
            with open(osp.join(WORK, name + ".console.txt"), "w") as con:
                sys.stdout = con
                train.main(train.build_parser().parse_args(
                    common + args + ["--output-dir", out_dir] + opts
                    + extra))
                torch.cuda.synchronize()
                sys.stdout = sys.__stdout__
            seconds = time.perf_counter() - t0
            metrics = parse_result(osp.join(out_dir, log))
            if not all(math.isfinite(v) and 0.0 <= v <= 100.0
                       for v in metrics.values()):
                raise AssertionError(f"{name}: bad metrics {metrics}")
            emit("main_path", stage=name, seconds=seconds,
                 weights="seeded random init (no accuracy claim)",
                 tower_forwards=transformer.forwards - forwards0,
                 launches=mha_qkv.launches - launches0, metrics=metrics)
    finally:
        attention.mha_qkv = mha_qkv
        sys.stdout = sys.__stdout__
        os.chdir(old_cwd)
    launches, forwards = mha_qkv.launches, transformer.forwards
    # ViT-B/16: 12 layers in each tower, one fused attention per layer
    if launches == 0 or launches != 12 * forwards:
        raise AssertionError(f"mha_qkv_fwd launched {launches} times for "
                             f"{forwards} tower forwards (want 12 each)")
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    if sum(c[-1] for c in launched) != launches:
        raise AssertionError("the recorded calls miss kernel launches")
    return launches, launched


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
    device = torch.device("cuda", 0)
    smi = nvidia_smi()
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         nvidia_smi=smi)

    from clip_calibration_tpu_torch.ops import build
    seconds = build.build()
    ptxas = [ln.strip() for name in build.SOURCES
             for ln in open(build.log_path(name)).read().splitlines()
             if "registers" in ln or "spill" in ln] if seconds else []
    emit("build", seconds=seconds, kernels=sorted(build.SOURCES),
         ptxas=ptxas)

    launches, launched = run_main_path()
    cases = check_kernels(device, launched)
    check_towers(device)

    # the top-level numbers: the case the main path launched most often
    main_case = max(cases, key=lambda c: c["main_path_launches"])
    print(json.dumps({"kernels": [{
        "name": "mha_qkv_fwd", "route": "cuda",
        "source": "clip_calibration_tpu_torch/csrc/mha_qkv_fwd.cu",
        "replaces": "clip_calibration_tpu/ops/pallas_attention.py:36",
        "launches": launches,
        **{k: main_case[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")},
        "cases": cases,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
