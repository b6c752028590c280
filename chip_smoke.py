#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure ends the run with a non-zero exit:

1. ``env``: torch/CUDA versions and the card (name, power limit).
2. ``build``: compiles every kernel under ``clip_calibration_tpu_torch/csrc``
   (one nvcc per source) into ``build/``; per kernel instance its
   registers and spilled bytes (ptxas), and the count of tensor-core
   products (``HMMA``) in the fp32 instances' SASS (``cuobjdump``). Fails
   if an fp32 instance, or any instance of K2 or K3, spills, or an fp32
   instance holds an ``HMMA``.
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
   time with counts, and fails unless K1 and K2 (12 a step: its fused
   kernel at the text tower's L 32) are in it, or if PyTorch's sorting
   ``indexing_backward_kernel`` is (the context assembly's backward is a
   gather).
5. ``fp32_path``: the same CLI at ``MODEL.PRECISION fp32``, the
   golden-parity precision (tests/test_golden_e2e.py): golden stage 1
   (ZeroshotCLIP on the base classes), then CoOp trained for one epoch of
   7 steps of 32 (5 shots of the 50 base classes) and tested. Asserts
   finite metrics and losses, that every tower layer went through the fp32
   K1 and every train step's 12 text layers through the fp32 K2.
5b. ``prompt_path``: the same CLI trains the prompt trainers at their
   published ViT-B/16 configs (bf16, seeded random init): VPT, MaPLe and
   PromptSRC (batch 4, 1 shot of the 50 base classes: 2 epochs of 12
   steps, PromptSRC's Gaussian aggregation at the end), KgCoOp,
   CLIP-Adapter and TaskRes (16 shots, one epoch: 25, 25 and 3 steps),
   each tested on the base classes; then the VPT model on the new classes
   with DAC, and ParameterizedTempScaling (ep5_lr5e-2.yaml) on
   ``train_path``'s CoOp model. Asserts finite losses and metrics,
   changed trainables, K1 in every layer of every tower forward, and K2
   12 times a step in each tower whose prompts train: the vision tower at
   [4, 208, 2304] (route ``tiled``), the text tower for MaPLe, PromptSRC
   and KgCoOp. The fixed text features of VPT, TaskRes and PromptSRC's
   teacher are encoded in fp32 on the bf16 tower: fp32 K1 launches.
5c. ``fanout_path``: the same CLI at ViT-B/16 (bf16, seeded random init)
   runs the text fan-out trainers at their published configs, cut in
   epochs and shots only: CoCoOp (``vit_b16_c4_ep10_batch1.yaml``, 1 shot
   of the 50 base classes: 50 steps of one image, each 50 prompt rows
   through the text tower) trained and tested on the base classes, then
   eval-only on them under ``TRAINER.QUANT_EVAL_TEXT w8a8`` (K3 on the text
   tower) and on the new classes with DAC; ProGrad
   (``vit_b16_c16_ep100_batch32.yaml``, 16 shots, one epoch of 25 steps: two
   backward passes a step, an fp32 zero-shot teacher); ProDA
   (``vit_b16_c16_ep100_batch4.yaml``, 1 shot: 12 steps, each one tower call
   over 50 x 4 prompt rows and 32 class-free rows) tested with a w8a8
   ``set_classifier``; ZeroshotCLIP and 3 CoOp steps on RN50 (the
   ModifiedResNet image tower, ``rn50`` configs, 2 shots). Asserts finite
   losses and metrics, changed trainables, K1 in every tower layer, K2 in
   every text layer of every backward pass (bf16), K3 49 times a w8a8
   text forward and nowhere else; each stage's line lists K1, K2 (with its
   route) and K3 (with its route) launches by shape.
6. ``kernel``: each kernel against its plain PyTorch version on the card at
   every shape and mask the paths gave it (each records every distinct
   (qkv shape, heads, dtype, mask)), in bf16 and fp32, with its time, the
   plain version's, one PyTorch library call's (a yardstick only; the port
   never calls it) and the least time the card could take (``bound_ms``);
   then correctness at edge shapes the paths do not reach (for K2 also
   both sides of its bf16 route switch, L 1, 16, 64 and 65, at head dims
   16, 32 and 64). Each K2 case names its ``route`` (``fused_L64`` or
   ``tiled``).
7. ``serve_path``: the port's serve CLI at ViT-B/16 (bf16, random init)
   on 84 synthetic images at 224^2 (one full 64-image batch and a 32-row
   bucket) and on one image (the 1-row bucket), in four quantization modes:
   full precision, ``--quantize int8``, ``--quantize w8a8`` calibrating
   and saving static scales, ``--quantize w8a8 --act-scales`` (bit for bit
   the previous run); the CoOp checkpoint of ``train_path`` through
   ``--coop-prompt --quantize w8a8``; an HTTP server over a w8a8
   predictor answering concurrent single images and one JSON batch, held
   to direct ``predict``; one eval-only CoOp stage of the train CLI with
   ``TRAINER.QUANT_FROZEN_VISION w8a8``. Asserts finite outputs, K3
   launched 50 times per w8a8 image forward (one count a product, the
   rescale in its epilogue or, where K is split, in a second kernel),
   every launch with the weight's K-major copy, and K1 in every layer.
7b. ``mesh_path``: multi-process runs (``parallel/``). (a) The port's CLI
   with ``TPU.DISTRIBUTED True`` at one rank, NCCL on the card: golden
   stage 1 (its ``=> result`` block byte for byte main_path's) and 3 CoOp
   steps; one NCCL ``all_reduce`` on the card. (b) Two ranks sharing the
   card over gloo (this script again, ``--mesh-worker``): a probe of
   gloo's ``all_reduce`` / ``all_gather`` / ``broadcast`` on CUDA tensors,
   then at ViT-B/16 (bf16, seeded random init) data-parallel CoOp and
   ProGrad steps (ProGrad: two backward passes) at batch 32 on mesh (2, 1),
   the text features' gradient summed over the data ranks before the text
   tower's backward (CoOp again at fp32: the fp32 K1 and K2, a tight
   tolerance), CoCoOp and ProDA class-sharded steps on
   (1, 2) at their published configs (ProDA's classifier then on the w8a8
   text tower), a tensor-parallel Predictor on (1, 2) (its ``predict``
   probabilities and its tower's features), and the int8 and w8a8 TP
   Predictors on (1, 2) (static scales calibrated on 32 images; 64 images
   and the 1-row bucket; K3 at each rank's TP shapes, 50 launches a w8a8
   forward); each held to the same work on one rank (``MESH_*``
   tolerances). Each rank sets the kernels' launch counters to 0 after
   the probe and holds them to its recorded calls at the end. Fails if
   either rank fails or launches none of K1, K2 and K3. (c) The serve CLI
   with ``--http 127.0.0.1:0 --mesh 1,2 --quantize w8a8`` on two ranks
   sharing the card over gloo (``--serve-worker``): concurrent single
   images and one JSON batch held to a one-rank w8a8 Predictor, then
   SIGTERM to rank 0; both ranks must exit 0. The ranks' calls by shape
   join the kernel checks (K1 at the TP shape [B, 208, 1152] with 6 heads
   and at the class-sharded text shapes; K3 at the TP shapes [13312, 768,
   1152], [13312, 384, 768], [13312, 768, 1536] and [13312, 1536, 768]).
8. ``probe_path``: the port's int8 attention probe
   (``probe_int8_attention``) at its default full width (B 256, L 208,
   D 768, H 12), each variant on K4, one row a variant; asserts K4
   launched in every variant.
9. ``kernel int8_matmul``: K3 against its plain version (exact, with and
   without the K-major weight copy) at every (M, K, N) the serve path
   launched (with its ``route``: ``rescaled`` or ``split_k``) and at edge
   shapes; its rescaled epilogue bit for bit against the plain rescale of
   the plain product (per-row and 0-d scales, bf16 and fp32 out); the
   int32 time, the plain version's, ``torch._int_mm``'s and the bound;
   the rescaled bf16 time beside the int32 kernel plus the PyTorch
   rescale, the plain versions and its bound.
10. ``kernel int8_attention``: K4, each variant, against its plain version
   at the probe's shape and at edges (L 77 causal, L 197 unpadded, head
   dim 32, batches of 1 and 2, L 1024), with its time, the plain version's, SDPA's
   (fp32_scores only) and the bound.
10b. ``kernel layer_norm``: the LayerNorm kernels (forward: y, mean, rstd;
   backward: dx, alone and under autograd) against their plain versions
   within ``LN_TOL``, bf16 and fp32, at the bigG and L/14 row shapes
   [8704, 1664], [16000, 1280], [27200, 1024], at [32, 768] and at every
   [rows, width, dtype] the main path launched, each with its time, the
   plain version's, PyTorch's own ``native_layer_norm`` and its backward's
   (a yardstick the port never calls) and the bound (bytes), and with a
   backward that drops its xh * mean(g' xh) term shown to fail
   ``LN_TOL``; then correctness at the port's other widths, ragged row
   counts, widths 8 to 2048 and ln_post's strided rows, each call's
   launches counted, and the refusal of a width off the vector loads, one
   over 2048 and float16. Before the checks the ``layer_norm_paths`` line
   gives each path's launches of both kernels, counted from 0 by a stand-in
   for each launcher (the mesh ranks' from their kernels' counters), and
   fails where a path that runs a tower on the card launched no forward,
   or one that trains no backward.
11. ``tower_check``: the full-width ViT-B/16 towers on the card (kernel)
   against the same weights on the CPU (plain version), fp32.
12. ``train_check``: one CoOp loss and context gradient at full ViT-B/16
   width, fp32, on the card (K1 and K2) against the CPU (plain versions)
   with the same weights, context and batch; ``prompt_check``: the same
   for one VPT loss and its shallow and deep vision prompts' gradient
   (8 tokens, depth 12, batch 4: K2 at L 205 padded to 208);
   ``fanout_check``: CoCoOp's context and meta-net gradients over 11
   images x 50 classes (two checkpointed chunks: K1 runs again in the
   backward) and ProGrad's two gradients (the second backward pass over
   the retained graph) and its projection, card against CPU.
13. ``serve_check``: the w8a8 ViT-B/16 vision tower with static scales on
   the card (K3) against the same int8 weights and scales on the CPU (the
   plain version), fp32, by the features' cosine similarity.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Without a card, or without the port's
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import base64
import json
import math
import os
import os.path as osp
import re
import shutil
import sys
import time
import urllib.request

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


def by_shape(calls):
    """A recorder's calls merged over dtypes: [(qkv shape, heads, mask,
    {dtype name: count}), ...], in first-seen order."""
    import torch
    out = []
    for shape, heads, dtype, mask, count in calls:
        entry = next((e for e in out if e[:2] == (shape, heads)
                      and torch.equal(e[2], mask)), None)
        if entry is None:
            entry = (shape, heads, mask, {})
            out.append(entry)
        name = str(dtype).split(".")[-1]
        entry[3][name] = entry[3].get(name, 0) + count
    return out


# correctness-only shapes the paths do not reach: (B, real L, padded L,
# D, H, causal)
EDGES = [
    (3, 77, 77, 512, 8, True),       # text, unpadded: ragged tiles
    (2, 257, 257, 1024, 16, False),  # ViT-L/14, unpadded
    (2, 577, 592, 1024, 16, False),  # ViT-L/14@336px, padded
    (4, 17, 32, 64, 4, False),       # head dim 16 (ViT-Test text)
    (2, 50, 50, 256, 8, True),       # head dim 32
]
# K1 only: batch 1 at a long sequence (the launcher splits the queries
# into one-warp blocks to fill the card)
K1_EDGES = EDGES + [(1, 1024, 1024, 1024, 16, False)]
# K1 bf16 only, at head dim 104 (OpenCLIP ViT-bigG/14's vision tower, 16
# heads of 104; K2 and the fp32 K1 are not compiled for it): timed at the
# tower's batch-32 shape unpadded and as the tower pads it, then edges: one
# head, two warps a block (L <= 32), ragged causal tiles, batch 1 at a
# long sequence (one-warp blocks)
K1_D104_TIMED = [(32, 257, 257, 1664, 16, False),
                 (32, 257, 272, 1664, 16, False)]
K1_D104_EDGES = [(2, 257, 272, 1664, 16, False), (1, 17, 32, 104, 1, False),
                 (4, 20, 32, 416, 4, False), (3, 77, 77, 208, 2, True),
                 (1, 1024, 1024, 1664, 16, False)]
# K2 only: both sides of its bf16 route switch (one fused kernel at L <=
# 64, the dq and dk/dv kernels above), at head dims 16, 32 and 64
K2_EDGES = EDGES + [(3, L, L, 4 * d, 4, True) for L in (1, 16, 64, 65)
                    for d in (16, 32, 64)]


def check_kernels(device, launched):
    """K1 vs its plain version, timed, at every (qkv shape, heads, mask)
    the paths launched it with, in bf16 and fp32, and in bf16 at
    ViT-bigG/14's vision shapes (head dim 104); then correctness only at
    the edges the paths do not reach (ragged L, other head dims, the ViT-L
    sequence lengths, head dim 104 in bf16), and the refusal of head dim
    104 by the fp32 K1 and by K2."""
    import torch
    from clip_calibration_tpu_torch.ops.mha_qkv import (mha_qkv,
                                                        mha_qkv_bwd,
                                                        mha_qkv_reference)
    from clip_calibration_tpu_torch.tools.profiling import (L2_FLUSH_BYTES,
                                                            time_ms)
    F = torch.nn.functional
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    cases = []
    gen = torch.Generator(device=device).manual_seed(0)
    timed_cases = [(shape, H, mask, calls, (torch.bfloat16, torch.float32))
                   for shape, H, mask, calls in by_shape(launched)]
    timed_cases += [((B, L, 3 * D), H, pad_mask(real, L, causal, device), {},
                     (torch.bfloat16,))
                    for B, real, L, D, H, causal in K1_D104_TIMED]
    for (B, L, D3), H, mask, calls, dtypes in timed_cases:
        kind, real = mask_kind(mask)
        D = D3 // 3
        for dtype in dtypes:
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
                "main_path_launches": calls.get(dname, 0),
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
    edges = [(e, (torch.bfloat16, torch.float32)) for e in K1_EDGES]
    edges += [(e, (torch.bfloat16,)) for e in K1_D104_EDGES]
    for (B, real, L, D, H, causal), dtypes in edges:
        mask = pad_mask(real, L, causal, device)
        for dtype in dtypes:
            qkv = torch.randn((B, L, 3 * D), generator=gen, device=device,
                              dtype=torch.float32).to(dtype)
            err, ok = _compare(mha_qkv, mha_qkv_reference, TOL, qkv, mask, H)
            errors.append({"qkv": [B, L, 3 * D], "heads": H,
                           "dtype": str(dtype).split(".")[-1],
                           "max_abs_err": err, "ok": ok})
    # what is not compiled at head dim 104 raises by name, never falls back
    refused = []
    qkv = torch.zeros((1, 16, 3 * 208), device=device)
    mask = torch.zeros((16, 16), device=device)
    for kernel, dtype, call in (
            ("K1", torch.float32, lambda t: mha_qkv(t, mask, 2)),
            ("K2", torch.bfloat16, lambda t: mha_qkv_bwd(
                t, mask, t[..., :208].contiguous(), 2))):
        try:
            call(qkv.to(dtype))
            said = None
        except ValueError as e:
            said = str(e)
        ok = said is not None and all(
            w in said for w in ("104", kernel, str(dtype)[6:]))
        refused.append({"kernel": kernel, "dtype": str(dtype)[6:],
                        "head_dim": 104, "error": said, "ok": ok})
    emit("kernel mha_qkv_fwd edges", cases=errors, refused=refused)
    if not all(e["ok"] for e in errors + refused):
        raise AssertionError("mha_qkv_fwd disagrees with its plain version "
                             "at an edge shape, or head dim 104 ran where "
                             "no kernel is compiled for it")
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
    trace and K2 ran 12 times a step (one per text layer), and if
    PyTorch's sorting ``indexing_backward_kernel`` is in it."""
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
              for want in ("mha_qkv_fwd_bf16", "mha_qkv_bwd_fused_bf16",
                           "mha_qkv_bwd_dq_bf16", "mha_qkv_bwd_dkdv_bf16")}
    # one K2 launch per text layer and step: the fused kernel (L <= 64),
    # or the dq and dk/dv pair
    k2 = counts["mha_qkv_bwd_fused_bf16"] + counts["mha_qkv_bwd_dq_bf16"]
    if (not counts["mha_qkv_fwd_bf16"] or k2 != 12 * PROFILE_STEPS
            or counts["mha_qkv_bwd_dq_bf16"]
            != counts["mha_qkv_bwd_dkdv_bf16"]):
        raise AssertionError(f"the trace misses the port's kernels: "
                             f"{counts} ({len(by_name)} kernel names)")
    # the context assembly's backward is a gather, not PyTorch's sorting
    # scatter (trainers/coop.py::assemble_prompts)
    sorting = [n for n in by_name if "indexing_backward_kernel" in n]
    if sorting:
        raise AssertionError(f"the traced steps ran {sorting}")
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


#: fp32_path: CoOp shots a base class (50 x 5 = 250 images: 7 steps of 32)
FP32_SHOTS = 5


def run_fp32_path(k1, k2):
    """Golden stage 1 and a short CoOp training through the port's CLI at
    ``MODEL.PRECISION fp32``, K1's and K2's entry points recorded by ``k1``
    and ``k2``. Returns (K1 launches, K2 launches), all fp32."""
    import torch
    from clip_calibration_tpu_torch.models import clip as M
    from clip_calibration_tpu_torch.models.clip import transformer
    from clip_calibration_tpu_torch.ops.mha_qkv import mha_qkv, mha_qkv_bwd
    from clip_calibration_tpu_torch.trainers.coop import CoOp

    # seed 1: CoOp's test reads the ZeroshotCLIP base cache of seed 1; 5
    # shots keep both stages' caches apart from the bf16 paths' (16 shots)
    common, coop, opts = _common_args(1)
    # CoOp's towers follow TRAINER.COOP.PREC (as the golden run sets it,
    # tests/fixtures/golden_e2e/coop_fp32.yaml),
    # ZeroshotCLIP's MODEL.PRECISION
    fp32 = ["MODEL.PRECISION", "fp32", "TRAINER.COOP.PREC", "fp32",
            "DATASET.NUM_SHOTS", str(FP32_SHOTS),
            "DATASET.SUBSAMPLE_CLASSES", "base", "TRAIN.PRINT_FREQ", "1"]
    stages = [
        ("fp32_zsclip_base", ["--trainer", "ZeroshotCLIP", "--config-file",
                              osp.join(ROOT, "configs", "trainers",
                                       "ZeroshotCLIP", "vit_b16.yaml")], []),
        ("fp32_coop_train", coop, ["OPTIM.MAX_EPOCH", "1"]),
    ]
    steps = [0]
    forward_backward = CoOp.forward_backward

    def counted_step(self, batch):
        steps[0] += 1
        return forward_backward(self, batch)

    def fp32_count(rec):
        return sum(c[4] for c in rec.calls if c[2] == torch.float32)

    mha_qkv.launches = mha_qkv_bwd.launches = 0
    k1_before, k2_before = k1.count(), k2.count()
    k1_fp32, k2_fp32 = fp32_count(k1), fp32_count(k2)
    forwards0 = transformer.forwards
    CoOp.forward_backward = counted_step
    try:
        for name, args, extra in stages:
            launches0 = (mha_qkv.launches, mha_qkv_bwd.launches)
            fwd0, steps0 = transformer.forwards, steps[0]
            seconds, log_path = _cli_stage(
                name, common + args + ["--output-dir",
                                       osp.join(WORK, "out", name)]
                + opts + fp32 + extra, "log.txt")
            losses = [float(x) for x in re.findall(
                r" loss (\S+) \(", open(log_path).read())]
            if len(losses) != steps[0] - steps0 or not all(
                    map(math.isfinite, losses)):
                raise AssertionError(f"{name}: losses {losses} for "
                                     f"{steps[0] - steps0} steps")
            emit("fp32_path", stage=name, seconds=seconds,
                 precision="fp32",
                 weights="seeded random init (no accuracy claim)",
                 steps=steps[0] - steps0, losses=losses,
                 tower_forwards=transformer.forwards - fwd0,
                 launches={"mha_qkv_fwd": mha_qkv.launches - launches0[0],
                           "mha_qkv_bwd": mha_qkv_bwd.launches
                           - launches0[1]},
                 metrics=_checked_metrics(name, log_path))
    finally:
        CoOp.forward_backward = forward_backward
    launches = (mha_qkv.launches, mha_qkv_bwd.launches)
    forwards = transformer.forwards - forwards0
    # every launch recorded, and every one of them fp32
    if ((k1.count() - k1_before, k2.count() - k2_before) != launches
            or (fp32_count(k1) - k1_fp32, fp32_count(k2) - k2_fp32)
            != launches):
        raise AssertionError("fp32_path: a kernel launch was not fp32 or "
                             "was not recorded")
    # ViT-B/16: 12 layers in each tower; 12 text layers backward a step
    layers = M.PRESETS["ViT-B/16"]
    if launches[0] == 0 or launches[0] != layers.vision_layers * forwards:
        raise AssertionError(f"fp32_path: mha_qkv_fwd launched "
                             f"{launches[0]} times for {forwards} tower "
                             f"forwards (want {layers.vision_layers} each)")
    steps_want = 50 * FP32_SHOTS // 32
    if (steps[0] != steps_want
            or launches[1] != layers.transformer_layers * steps[0]):
        raise AssertionError(f"fp32_path: {steps[0]} steps (want "
                             f"{steps_want}) launched mha_qkv_bwd "
                             f"{launches[1]} times (want "
                             f"{layers.transformer_layers} each)")
    return launches


#: prompt_path: the vision-prompt trainers' shots a base class (50 x 1 =
#: 50 images: 12 steps of 4 an epoch); the others train on the 16 shots
#: of the main path (its ZeroshotCLIP base cache)
PROMPT_SHOTS = {"VPT": 1, "MaPLe": 1, "PromptSRC": 1, "KgCoOp": 16,
                "CLIP_Adapter": 16, "TaskRes": 16}
#: (trainer, published ViT-B/16 config, epochs, registered slot, towers
#: whose prompts train: each runs K2 in its 12 layers every step)
PROMPT_TRAINERS = [
    ("VPT", "VPT/vit_b16_c2_ep5_batch4_4.yaml", 2, "vpt_prompts",
     ("vision",)),
    ("MaPLe", "MaPLe/vit_b16_c2_ep5_batch4.yaml", 2, "prompt_learner",
     ("vision", "text")),
    ("PromptSRC", "PromptSRC/vit_b16_c4_ep50_batch4.yaml", 2,
     "prompt_learner", ("vision", "text")),
    ("KgCoOp", "KgCoOp/vit_b16_c16_ep200_batch32.yaml", 1, "prompt_learner",
     ("text",)),
    ("CLIP_Adapter", "CLIP_Adapter/vit_b16_c4_ep200_batch32.yaml", 1,
     "adapter", ()),
    ("TaskRes", "TaskRes/vit_b16_c16_ep200_batch256.yaml", 1,
     "taskres_learner", ()),
]
#: the ViT-B/16 vision tower's padded length at batch 4 with the prompt
#: tokens of all three vision-prompt configs (197 + 8, 2 or 4 real rows)
VISION_K2_SHAPE = (4, 208, 2304)


def _by_shape_dtype(rec) -> dict:
    """A recorder's launch counts by (qkv shape, dtype name)."""
    out = {}
    for shape, _, dtype, _, count in rec.calls:
        key = (shape, str(dtype).split(".")[-1])
        out[key] = out.get(key, 0) + count
    return out


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def run_prompt_path(k1, k2):
    """The prompt trainers through the port's CLI at ViT-B/16 (bf16,
    seeded random init; see the module docstring), K1's and K2's entry
    points recorded by ``k1`` and ``k2``. Returns the path's launches by
    kernel instance: {"mha_qkv_fwd": bf16, "mha_qkv_fwd_f32": fp32,
    "mha_qkv_bwd": bf16, "mha_qkv_bwd_f32": fp32}."""
    import torch
    from clip_calibration_tpu_torch.engine.checkpoint import load_checkpoint
    from clip_calibration_tpu_torch.models import clip as M
    from clip_calibration_tpu_torch.ops.mha_qkv import (bwd_route, mha_qkv,
                                                        mha_qkv_bwd)
    from clip_calibration_tpu_torch.trainers.base_learner import (
        VLBaseLearner)

    common, _, _ = _common_args(1)
    cfgs = osp.join(ROOT, "configs", "trainers")
    layers = M.PRESETS["ViT-B/16"].vision_layers
    steps, initial = [0], {}
    loss_step, register = VLBaseLearner.loss_step, \
        VLBaseLearner.register_trainable

    def counted_step(self, name, batch):
        steps[0] += 1
        return loss_step(self, name, batch)

    def recorded_register(self, name, params):
        initial[name] = {k: v.detach().float().cpu().clone()
                         for k, v in params.items()}
        return register(self, name, params)

    def stage(name, args, log):
        """One CLI run; (seconds, log path, steps, tower forwards, K1
        and K2 launches by (shape, dtype))."""
        s0, f0 = steps[0], M.transformer.forwards
        c1, c2 = _by_shape_dtype(k1), _by_shape_dtype(k2)
        seconds, log_path = _cli_stage(name, common + args, log)
        return (seconds, log_path, steps[0] - s0,
                M.transformer.forwards - f0,
                _delta(_by_shape_dtype(k1), c1),
                _delta(_by_shape_dtype(k2), c2))

    def check_k1(name, forwards, k1d):
        n = sum(k1d.values())
        # ViT-B/16: 12 layers in each tower, one fused attention each
        if n == 0 or n != layers * forwards:
            raise AssertionError(f"{name}: mha_qkv_fwd launched {n} "
                                 f"times for {forwards} tower forwards")

    mha_qkv.launches = mha_qkv_bwd.launches = 0
    k1_before, k2_before = _by_shape_dtype(k1), _by_shape_dtype(k2)
    VLBaseLearner.loss_step = counted_step
    VLBaseLearner.register_trainable = recorded_register
    try:
        seconds, log_path, _, fwd, k1d, _ = stage(
            "prompt_zsclip_base",
            ["--trainer", "ZeroshotCLIP", "--config-file",
             osp.join(cfgs, "ZeroshotCLIP", "vit_b16.yaml"),
             "--output-dir", osp.join(WORK, "out", "prompt_zsclip_base"),
             "DATASET.NUM_SHOTS", "1", "DATASET.SUBSAMPLE_CLASSES", "base"],
            "log.txt")
        check_k1("prompt_zsclip_base", fwd, k1d)
        emit("prompt_path", stage="prompt_zsclip_base", seconds=seconds,
             tower_forwards=fwd,
             metrics=_checked_metrics("prompt_zsclip_base", log_path))

        for trainer, config, epochs, slot, towers in PROMPT_TRAINERS:
            out_dir = osp.join(WORK, "out", "prompt_" + trainer)
            initial.clear()
            seconds, log_path, n, fwd, k1d, k2d = stage(
                "prompt_" + trainer,
                ["--trainer", trainer, "--config-file",
                 osp.join(cfgs, config), "--output-dir", out_dir,
                 "DATASET.NUM_SHOTS", str(PROMPT_SHOTS[trainer]),
                 "DATASET.SUBSAMPLE_CLASSES", "base",
                 "OPTIM.MAX_EPOCH", str(epochs), "TRAIN.PRINT_FREQ", "1"],
                "log.txt")
            text = open(log_path).read()
            losses = [float(x) for x in re.findall(r" loss (\S+) \(", text)]
            if n == 0 or len(losses) != n or not all(
                    map(math.isfinite, losses)):
                raise AssertionError(f"{trainer}: losses {losses} for {n} "
                                     f"steps")
            ckpt = load_checkpoint(osp.join(
                out_dir, slot, f"model.pth.tar-{epochs}"))["state_dict"]
            change = max(float((ckpt[k].float() - v).abs().max())
                         for k, v in initial[slot].items())
            if not change > 0:
                raise AssertionError(f"{trainer}: the trainables did not "
                                     f"change")
            check_k1(trainer, fwd, k1d)
            vision = sum(c for (shape, dt), c in k2d.items()
                         if shape == VISION_K2_SHAPE and dt == "bfloat16")
            total = sum(k2d.values())
            want_vision = layers * n if "vision" in towers else 0
            if (vision != want_vision
                    or total != layers * n * len(towers)
                    or (vision and bwd_route(VISION_K2_SHAPE[1],
                                             torch.bfloat16) != "tiled")):
                raise AssertionError(
                    f"{trainer}: {n} steps launched mha_qkv_bwd {k2d} "
                    f"(want {layers} a step in each of {towers}, the "
                    f"vision ones at {list(VISION_K2_SHAPE)}, route tiled)")
            emit("prompt_path", stage="prompt_" + trainer,
                 config=config, seconds=seconds,
                 weights="seeded random init (no accuracy claim)",
                 steps=n, first_loss=losses[0], last_loss=losses[-1],
                 max_abs_change=change, tower_forwards=fwd,
                 launches={"mha_qkv_fwd": {f"{list(s)} {d}": c
                                           for (s, d), c in k1d.items()},
                           "mha_qkv_bwd": {f"{list(s)} {d}": c
                                           for (s, d), c in k2d.items()}},
                 k2_vision_launches=vision,
                 metrics=_checked_metrics(trainer, log_path))

        # the base-trained VPT on the new classes, with DAC
        seconds, log_path, n, fwd, k1d, k2d = stage(
            "prompt_vpt_new_dac",
            ["--trainer", "VPT", "--config-file",
             osp.join(cfgs, PROMPT_TRAINERS[0][1]),
             "--output-dir", osp.join(WORK, "out", "prompt_vpt_new"),
             "--model-dir", osp.join(WORK, "out", "prompt_VPT"),
             "--eval-only", "--load-epoch", str(PROMPT_TRAINERS[0][2]),
             "--calibration-config", json.dumps(
                 {"BASE_CALIBRATION_MODE": None, "IF_DAC": True,
                  "IF_PROCAL": False}),
             "DATASET.NUM_SHOTS", str(PROMPT_SHOTS["VPT"]),
             "DATASET.SUBSAMPLE_CLASSES", "new"], "log_dac.txt")
        check_k1("prompt_vpt_new_dac", fwd, k1d)
        if k2d or n:
            raise AssertionError(f"prompt_vpt_new_dac: an eval ran {n} "
                                 f"steps and K2 {k2d}")
        emit("prompt_path", stage="prompt_vpt_new_dac", seconds=seconds,
             tower_forwards=fwd,
             metrics=_checked_metrics("prompt_vpt_new_dac", log_path))

        # ParameterizedTempScaling on the CoOp model train_path trained
        scale_dir = osp.join(WORK, "out", "coop_pts")
        c2 = _by_shape_dtype(k2)
        common2, coop2, opts2 = _common_args(2)  # train_path's seed
        seconds, log_path = _cli_stage(
            "prompt_pts", common2 + coop2 + [
                "--output-dir", scale_dir, "--base-dir",
                osp.join(WORK, "out", "coop_train"),
                "--calibration-config", json.dumps({
                    "BASE_CALIBRATION_MODE": "scaling_based",
                    "SCALING_CONFIG": osp.join(
                        ROOT, "configs", "calibration",
                        "ParameterizedTempScaling", "ep5_lr5e-2.yaml"),
                    "IF_DAC": False, "IF_PROCAL": False})]
            + opts2 + ["CALIBRATION.SCALING.BASE_EPOCH", "2",
                       "TRAIN.PRINT_FREQ", "1",
                       "DATASET.SUBSAMPLE_CLASSES", "base"],
            "log_ParameterizedTempScaling.txt")
        losses = [float(x) for x in re.findall(
            r" loss (\S+) \(", open(log_path).read())]
        state = load_checkpoint(osp.join(
            scale_dir, "scale_learner",
            "model-calibrated.pth.tar-5"))["state_dict"]
        s0 = float(state["s0"])
        if not (losses and all(map(math.isfinite, losses))
                and math.isfinite(s0) and abs(s0 - 4.6052) > 1e-6
                and _by_shape_dtype(k2) == c2):
            raise AssertionError(f"prompt_pts: losses {losses[-3:]}, s0 "
                                 f"{s0}")
        emit("prompt_path", stage="prompt_pts", seconds=seconds,
             scale_steps=len(losses), last_loss=losses[-1], s0=s0,
             metrics=_checked_metrics("prompt_pts", log_path))
    finally:
        VLBaseLearner.loss_step = loss_step
        VLBaseLearner.register_trainable = register
    k1d = _delta(_by_shape_dtype(k1), k1_before)
    k2d = _delta(_by_shape_dtype(k2), k2_before)
    if (sum(k1d.values()), sum(k2d.values())) != (mha_qkv.launches,
                                                  mha_qkv_bwd.launches):
        raise AssertionError("prompt_path: the recorded calls miss kernel "
                             "launches")

    def of(d, dtype):
        return sum(c for (_, dt), c in d.items() if dt == dtype)

    return {"mha_qkv_fwd": of(k1d, "bfloat16"),
            "mha_qkv_fwd_f32": of(k1d, "float32"),
            "mha_qkv_bwd": of(k2d, "bfloat16"),
            "mha_qkv_bwd_f32": of(k2d, "float32")}


#: fanout_path's stages: (name, trainer, published config, shots, classes,
#: flags, opts, log, backward passes a train step through the text tower:
#: ProGrad's two, 0 for an eval; each runs K2 in every text layer)
FANOUT_STAGES = [
    ("fanout_cocoop_train", "CoCoOp", "CoCoOp/vit_b16_c4_ep10_batch1.yaml",
     1, "base", [], ["OPTIM.MAX_EPOCH", "1"], "log.txt", 1),
    ("fanout_cocoop_base_w8a8", "CoCoOp",
     "CoCoOp/vit_b16_c4_ep10_batch1.yaml", 1, "base",
     ["--model-dir", "fanout_cocoop_train", "--eval-only", "--load-epoch",
      "1"], ["TRAINER.QUANT_EVAL_TEXT", "w8a8"], "log.txt", 0),
    ("fanout_cocoop_new_dac", "CoCoOp", "CoCoOp/vit_b16_c4_ep10_batch1.yaml",
     1, "new", ["--model-dir", "fanout_cocoop_train", "--eval-only",
                "--load-epoch", "1", "--calibration-config", json.dumps(
                    {"BASE_CALIBRATION_MODE": None, "IF_DAC": True,
                     "IF_PROCAL": False})], [], "log_dac.txt", 0),
    ("fanout_prograd", "ProGrad", "ProGrad/vit_b16_c16_ep100_batch32.yaml",
     16, "base", [], ["OPTIM.MAX_EPOCH", "1"], "log.txt", 2),
    ("fanout_proda", "ProDA", "ProDA/vit_b16_c16_ep100_batch4.yaml", 1,
     "base", [], ["OPTIM.MAX_EPOCH", "1", "TRAINER.QUANT_EVAL_TEXT", "w8a8"],
     "log.txt", 1),
    ("fanout_rn50_zsclip", "ZeroshotCLIP", "ZeroshotCLIP/rn50.yaml", 2,
     "base", [], [], "log.txt", 0),
    ("fanout_rn50_coop", "CoOp", "CoOp/rn50_c16_ep200_batch32.yaml", 2,
     "base", [], ["OPTIM.MAX_EPOCH", "1"], "log.txt", 1),
]
#: int8 products of one w8a8 text-tower forward (ViT-B/16 and RN50 text: 4
#: in each of 12 blocks and the text projection)
TEXT_W8A8_PRODUCTS = 4 * 12 + 1


def _by_mkn(rec) -> dict:
    """The K3 recorder's launch counts by ((M, K, N), route)."""
    return {(mkn, route): n for mkn, routes in rec.calls.items()
            for route, n in routes.items()}


def run_fanout_path(k1, k2, k3):
    """The text fan-out trainers and the ResNet tower through the port's
    CLI (see the module docstring), K1's, K2's and K3's entry points
    recorded by ``k1``, ``k2`` and ``k3``. Returns the path's launches by
    kernel instance."""
    import torch
    from clip_calibration_tpu_torch.engine.checkpoint import (flatten_params,
                                                              load_checkpoint)
    from clip_calibration_tpu_torch.models import clip as M
    from clip_calibration_tpu_torch.ops.int8_matmul import int8_matmul
    from clip_calibration_tpu_torch.ops.mha_qkv import (bwd_route, mha_qkv,
                                                        mha_qkv_bwd)
    from clip_calibration_tpu_torch.trainers.base_learner import (
        VLBaseLearner)
    from clip_calibration_tpu_torch.trainers.cocoop import CoCoOp
    from clip_calibration_tpu_torch.trainers.coop import CoOp
    from clip_calibration_tpu_torch.trainers.proda import ProDA
    from clip_calibration_tpu_torch.trainers.prograd import ProGrad

    common, _, _ = _common_args(1)
    cfgs = osp.join(ROOT, "configs", "trainers")
    layers = M.PRESETS["ViT-B/16"].transformer_layers
    steps, initial = [0], {}
    classes = (CoOp, CoCoOp, ProGrad, ProDA)
    steppers = {cls: cls.__dict__["forward_backward"] for cls in classes}
    register = VLBaseLearner.register_trainable
    text = ForwardCounter(M.encode_text_embedded)

    def counting(fn):
        def step(self, batch):
            steps[0] += 1
            return fn(self, batch)
        return step

    def recorded_register(self, name, params):
        initial[name] = {k: v.detach().float().cpu().clone()
                         for k, v in flatten_params(params).items()}
        return register(self, name, params)

    def out_dir(name):
        return osp.join(WORK, "out", name)

    def fmt(d):
        return {f"{list(s)} {dt}": c for (s, dt), c in d.items()}

    mha_qkv.launches = mha_qkv_bwd.launches = int8_matmul.launches = 0
    before = (_by_shape_dtype(k1), _by_shape_dtype(k2), _by_mkn(k3))
    for cls in classes:
        cls.forward_backward = counting(steppers[cls])
    VLBaseLearner.register_trainable = recorded_register
    M.encode_text_embedded = text
    try:
        for (name, trainer, config, shots, subsample, flags, opts, log,
             passes) in FANOUT_STAGES:
            flags = [out_dir(f) if f.startswith("fanout_") else f
                     for f in flags]
            initial.clear()
            s0, f0 = steps[0], M.transformer.forwards
            w0 = text.by_qmode.get("w8a8", 0)
            c1, c2, c3 = (_by_shape_dtype(k1), _by_shape_dtype(k2),
                          _by_mkn(k3))
            seconds, log_path = _cli_stage(name, common + [
                "--trainer", trainer, "--config-file",
                osp.join(cfgs, config), "--output-dir", out_dir(name)]
                + flags + ["DATASET.NUM_SHOTS", str(shots),
                           "DATASET.SUBSAMPLE_CLASSES", subsample,
                           "DATALOADER.TEST.BATCH_SIZE", "32",
                           "TRAIN.PRINT_FREQ", "1"] + opts, log)
            n, fwd = steps[0] - s0, M.transformer.forwards - f0
            w8a8 = text.by_qmode.get("w8a8", 0) - w0
            k1d = _delta(_by_shape_dtype(k1), c1)
            k2d = _delta(_by_shape_dtype(k2), c2)
            k3d = _delta(_by_mkn(k3), c3)
            n1, n2, n3 = (sum(d.values()) for d in (k1d, k2d, k3d))
            losses = [float(x) for x in re.findall(
                r" loss (\S+) \(", open(log_path).read())]
            fields = {}
            if passes:
                slot = "prompt_learner"
                ckpt = load_checkpoint(osp.join(
                    out_dir(name), slot, "model.pth.tar-1"))["state_dict"]
                change = max(float((v.float() - initial[slot][k]).abs().max())
                             for k, v in flatten_params(ckpt).items())
                if not (n and len(losses) == n
                        and all(map(math.isfinite, losses)) and change > 0):
                    raise AssertionError(f"{name}: losses {losses} for {n} "
                                         f"steps, change {change}")
                fields = {"steps": n, "first_loss": losses[0],
                          "last_loss": losses[-1], "max_abs_change": change}
            elif n or n2:
                raise AssertionError(f"{name}: an eval ran {n} steps and K2 "
                                     f"{k2d}")
            # every tower layer through K1 (RN50's image tower has none);
            # K2 a text layer per backward pass, bf16; K3 every int8
            # product of every w8a8 text forward, nowhere else
            if n1 == 0 or n1 != layers * fwd:
                raise AssertionError(f"{name}: mha_qkv_fwd launched {n1} "
                                     f"times for {fwd} tower forwards")
            if n2 != layers * passes * n or any(dt != "bfloat16"
                                                for _, dt in k2d):
                raise AssertionError(f"{name}: {n} steps launched "
                                     f"mha_qkv_bwd {k2d} (want "
                                     f"{layers * passes} a step, bf16)")
            if n3 != TEXT_W8A8_PRODUCTS * w8a8 or (
                    "QUANT_EVAL_TEXT" in " ".join(opts)) != (w8a8 > 0):
                raise AssertionError(f"{name}: int8_matmul launched {n3} "
                                     f"times for {w8a8} w8a8 text forwards")
            emit("fanout_path", stage=name, trainer=trainer, config=config,
                 seconds=seconds,
                 weights="seeded random init (no accuracy claim)",
                 tower_forwards=fwd, w8a8_text_forwards=w8a8, **fields,
                 launches={
                     "mha_qkv_fwd": fmt(k1d),
                     "mha_qkv_bwd": {f"{list(s)} {dt} "
                                     f"{bwd_route(s[1], torch.bfloat16)}": c
                                     for (s, dt), c in k2d.items()},
                     "int8_matmul": {f"{list(mkn)} {route}": c
                                     for (mkn, route), c in k3d.items()}},
                 metrics=_checked_metrics(name, log_path))
    finally:
        for cls in classes:
            cls.forward_backward = steppers[cls]
        VLBaseLearner.register_trainable = register
        M.encode_text_embedded = text.fn
    k1d = _delta(_by_shape_dtype(k1), before[0])
    k2d = _delta(_by_shape_dtype(k2), before[1])
    k3n = sum(_delta(_by_mkn(k3), before[2]).values())
    if (sum(k1d.values()), sum(k2d.values()), k3n) != (
            mha_qkv.launches, mha_qkv_bwd.launches, int8_matmul.launches):
        raise AssertionError("fanout_path: the recorded calls miss kernel "
                             "launches")

    def of(d, dtype):
        return sum(c for (_, dt), c in d.items() if dt == dtype)

    return {"mha_qkv_fwd": of(k1d, "bfloat16"),
            "mha_qkv_fwd_f32": of(k1d, "float32"),
            "mha_qkv_bwd": of(k2d, "bfloat16"),
            "mha_qkv_bwd_f32": of(k2d, "float32"), "int8_matmul": k3n}


# ---------------------------------------------------------------------------
# mesh_path: multi-process runs (parallel/mesh.py, parallel/tp.py)
# ---------------------------------------------------------------------------

#: mesh_path's two ranks share the one card over gloo, bf16, ViT-B/16. Each
#: check holds the mesh's numbers to the same work on one rank (every rank
#: recomputes it without a mesh). The two differ in summation order (the
#: mesh sums partial gradients over the ranks, TP sums two partial
#: products in bf16) and in the row counts each matmul runs at (cuBLAS may
#: pick another algorithm, so a bf16 output may round 1 ulp, 2^-8
#: relative, apart), through 12 layers each way: loss |diff| / |one rank|
MESH_LOSS_RTOL = 1e-2
#: every trainable's gradient of a data-parallel step (CoOp, ProGrad):
#: max |diff| / max |one rank|. The text features' fp32 gradient is
#: summed over the data ranks before the text tower's bf16 backward
#: (``parallel/mesh.py::reduce_data_grad``, the JAX mesh step's order),
#: which leaves the cuBLAS row-count roundings of the image features
MESH_GRAD_RTOL = 1e-2
#: the class-sharded steps (CoCoOp, ProDA on (1, 2)): each model rank's
#: bf16 text backward sums its classes' part of the context gradient
#: before the fp32 sum over the ranks (measured on an H100: 2.4e-3 to
#: 1.03e-2)
MESH_CLASS_GRAD_RTOL = 5e-2
#: the same DP CoOp step at fp32 (the golden-parity precision, TF32 off):
#: the sums alone differ in order, so loss and gradient hold tightly
MESH_FP32_LOSS_RTOL = 1e-5
MESH_FP32_GRAD_RTOL = 1e-4
#: features (the TP vision tower; the w8a8 class-sharded classifier),
#: per row: 1 - cos(mesh, one rank); SERVE_COS_TOL's bound, whose w8a8
#: rounding-boundary steps the bf16 ulps above can also trigger
MESH_COS_TOL = 1e-3
#: the TP Predictors' probabilities (fp32 scores of bf16 features over 50
#: classes), full precision, int8 and w8a8, and the answers of HTTP over
#: two ranks: max |diff| against one rank's. Measured on an H100: 1.5e-4
#: (full), 1.6e-4 (int8), 4.6e-4 (w8a8: each rank rescales its partial
#: product of wo and w_proj to bf16 before the sum, and an activation
#: moved across an int8 rounding boundary of a static scale moves by a
#: whole int8 step). The top-1 class must agree on every row whose
#: one-rank top-2 margin exceeds twice this bound
MESH_PROBS_ATOL = 2e-3


def k3_per_w8a8_forward() -> int:
    """int8 products per w8a8 ViT-B/16 image forward: 4 in each block, the
    patch embedding and the projection (50)."""
    from clip_calibration_tpu_torch.models.clip import PRESETS
    return 4 * PRESETS["ViT-B/16"].vision_layers + 2


def _probs_check(what, p_tp, p_one) -> dict:
    """A mesh Predictor's probabilities against one rank's: within
    ``MESH_PROBS_ATOL``, and the same top-1 class on every row whose
    one-rank top-2 margin exceeds twice it."""
    import numpy as np
    atol = MESH_PROBS_ATOL
    top2 = np.sort(p_one, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * atol
    agree = p_tp.argmax(1) == p_one.argmax(1)
    rec = {"probs_max_abs_diff": float(np.abs(p_tp - p_one).max()),
           "probs_atol": atol,
           # the scale a wrong row or class order would move them by
           "one_rank_top1_prob_mean": float(p_one.max(1).mean()),
           "top1_agreement": float(agree.mean()),
           "top1_clear_rows": int(clear.sum()),
           "top1_clear_agreement": float(agree[clear].mean())
           if clear.any() else None}
    if not (p_tp.shape == p_one.shape and np.isfinite(p_tp).all()
            and rec["probs_max_abs_diff"] <= atol
            and bool(agree[clear].all())):
        raise AssertionError(f"mesh_path {what}: {rec}")
    return rec


def _mask_key(mask) -> list:
    """A tower mask as [kind, real length, padded length]; must be the
    ``pad_mask`` of those (the parent rebuilds it from them)."""
    kind, real = mask_kind(mask)
    L = mask.shape[0]
    if not bool((mask == pad_mask(real, L, "causal" in kind,
                                  mask.device)).all()):
        raise AssertionError(f"an unexpected mask of kind {kind}")
    return [kind, real, L]


def _cos_gap(a, b) -> float:
    import torch
    return float((1 - torch.nn.functional.cosine_similarity(
        a.float(), b.float(), dim=-1)).max())


def _mesh_trainer(name, config, shots, mesh_shape, out_dir, device,
                  opts=()):
    """A trainer of the port at its published ViT-B/16 config (bf16,
    seeded random init) on the synthetic base classes, on a mesh."""
    from clip_calibration_tpu_torch.config import get_cfg_default
    from clip_calibration_tpu_torch.data.base import set_random_seed
    from clip_calibration_tpu_torch.engine.registry import TRAINER_REGISTRY
    import clip_calibration_tpu_torch.data.datasets  # noqa: F401
    import clip_calibration_tpu_torch.evaluators.vl_evaluator  # noqa: F401
    import clip_calibration_tpu_torch.trainers  # noqa: F401
    cfg = get_cfg_default()
    cfg.merge_from_file(osp.join(ROOT, "configs", "datasets",
                                 "synthetic.yaml"))
    cfg.merge_from_file(osp.join(ROOT, "configs", "trainers", config))
    cfg.merge_from_list(["DATASET.ROOT", osp.join(WORK, "data"),
                         "DATASET.NUM_SHOTS", shots,
                         "DATASET.SUBSAMPLE_CLASSES", "base", "SEED", 1,
                         "OUTPUT_DIR", out_dir, "TRAINER.NAME", name,
                         "TEST.EVALUATOR", "VLClassification",
                         "TPU.MESH_SHAPE", tuple(mesh_shape), *opts])
    cfg.freeze()
    set_random_seed(1)
    return TRAINER_REGISTRY.get(name)(cfg, device=device)


def _gloo_probe(device) -> dict:
    """all_reduce, all_gather and broadcast on CUDA tensors over gloo, the
    three collectives the port uses, in both dtypes; each result held to
    the expected values."""
    import torch
    import torch.distributed as dist
    rank = dist.get_rank()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        t = torch.full((1024,), 1.0 + rank, dtype=dtype, device=device)
        dist.all_reduce(t)
        parts = [torch.empty(8, dtype=dtype, device=device)
                 for _ in range(2)]
        dist.all_gather(parts, torch.full((8,), float(rank), dtype=dtype,
                                          device=device))
        b = torch.full((8,), float(rank), dtype=dtype, device=device)
        dist.broadcast(b, src=1)
        ok = (bool((t == 3).all()) and bool((parts[0] == 0).all())
              and bool((parts[1] == 1).all()) and bool((b == 1).all()))
        out[str(dtype).split(".")[-1]] = ok
    if not all(out.values()):
        raise AssertionError(f"gloo collectives on CUDA tensors: {out}")
    return out


def _step_check(name, trainer, images, labels, *extra,
                loss_rtol=MESH_LOSS_RTOL, grad_rtol=MESH_GRAD_RTOL) -> dict:
    from clip_calibration_tpu_torch.parallel import dryrun as D
    r = D.trainer_step_check(trainer, images, labels, *extra)
    (lm, l1), grads = r["loss"], r["grads"]
    # a leaf whose gradient is zero on one rank (a dead ReLU of CoCoOp's
    # meta-net) must be zero on the mesh too
    rec = {"loss": [lm, l1], "loss_rel": abs(lm - l1) / abs(l1),
           "grad_rel": {k: float(abs(a - b).max() / max(abs(b).max(),
                                                        1e-30))
                        for k, (a, b) in grads.items()}}
    rec["ok"] = bool(math.isfinite(lm) and rec["loss_rel"] <= loss_rtol
                     and all(math.isfinite(v) and v <= grad_rtol
                             for v in rec["grad_rel"].values()))
    if not rec["ok"]:
        raise AssertionError(f"mesh_path {name}: {rec}")
    return rec


def mesh_worker(rank: int, port: int, out_path: str,
                device_type: str = "cuda") -> None:
    """One of mesh_path's two ranks (``chip_smoke.py --mesh-worker RANK
    PORT OUT``): gloo on the shared card, the dry run's pieces at ViT-B/16
    (bf16, seeded random init), each held to one rank; writes its results
    and its kernels' launches by shape to ``out_path`` as JSON."""
    import numpy as np
    import torch
    from clip_calibration_tpu_torch.data.datasets.synthetic import _classname
    from clip_calibration_tpu_torch.models import clip as M
    from clip_calibration_tpu_torch.parallel import dryrun as D
    from clip_calibration_tpu_torch.parallel.mesh import (
        initialize_distributed, make_mesh)
    from clip_calibration_tpu_torch.serving import Predictor
    os.environ.update(CC_COORD_ADDR=f"localhost:{port}", CC_NUM_PROCS="2",
                      CC_PROC_ID=str(rank))
    initialize_distributed(backend="gloo", device=device_type)
    device = (torch.device("cuda", torch.cuda.current_device())
              if device_type == "cuda" else torch.device("cpu"))
    work = osp.join(WORK, "mesh", f"rank{rank}")
    os.makedirs(work, exist_ok=True)
    os.chdir(work)  # this rank's ./temp caches
    res = {"rank": rank, "backend": torch.distributed.get_backend(),
           "world": torch.distributed.get_world_size()}
    seconds = {}
    t0 = time.perf_counter()
    res["gloo_cuda_collectives"] = _gloo_probe(device)
    k1, k2, k3 = _rank_kernels()
    rng = np.random.default_rng(5)

    def batch(n, n_cls):
        images = torch.as_tensor(rng.integers(0, 256, (n, 224, 224, 3),
                                              dtype=np.uint8), device=device)
        return images, rng.integers(0, n_cls, n)

    # (check, trainer, published config, shots, mesh, opts, tolerances)
    coop = "CoOp/vit_b16_c16_ep200_batch32.yaml"
    fp32 = {"loss_rtol": MESH_FP32_LOSS_RTOL,
            "grad_rtol": MESH_FP32_GRAD_RTOL}
    sharded = {"grad_rtol": MESH_CLASS_GRAD_RTOL}
    checks = [
        ("CoOp", "CoOp", coop, 16, (2, 1), [], {}),
        # two backward passes through the text tower, each summed over
        # the data ranks at the text features
        ("ProGrad", "ProGrad", "ProGrad/vit_b16_c16_ep100_batch32.yaml",
         16, (2, 1), [], {}),
        ("CoOp_fp32", "CoOp", coop, 16, (2, 1),
         ["MODEL.PRECISION", "fp32", "TRAINER.COOP.PREC", "fp32"], fp32),
        ("CoCoOp", "CoCoOp", "CoCoOp/vit_b16_c4_ep10_batch1.yaml", 1,
         (1, 2), [], sharded),
        ("ProDA", "ProDA", "ProDA/vit_b16_c16_ep100_batch4.yaml", 1, (1, 2),
         ["TRAINER.QUANT_EVAL_TEXT", "w8a8"], sharded),
    ]
    try:
        for name, trainer, config, shots, shape, opts, tol in checks:
            t1 = time.perf_counter()
            t = _mesh_trainer(trainer, config, shots, shape,
                              osp.join(work, "out_" + name), device, opts)
            images, labels = batch(t.cfg.DATALOADER.TRAIN_X.BATCH_SIZE,
                                   t.num_classes)
            extra = (np.arange(t.prompt_bs),) if name == "ProDA" else ()
            rec = _step_check(name, t, images, labels, *extra, **tol)
            rec["mesh"] = list(shape)
            rec["batch"] = int(images.shape[0])
            if name == "ProDA":
                # the eval sweep on the int8 text tower (K3), classes over
                # the model ranks, against one rank
                with torch.no_grad():
                    t.set_classifier()
                    mesh_tf = t.text_features.clone()
                    with D.one_rank(t):
                        t.set_classifier()
                    rec["classifier_cos_gap"] = _cos_gap(mesh_tf,
                                                         t.text_features)
                if not rec["classifier_cos_gap"] <= MESH_COS_TOL:
                    raise AssertionError(f"mesh_path ProDA classifier: "
                                         f"{rec}")
            res[name] = rec
            seconds[name] = time.perf_counter() - t1
            del t
        # a TP Predictor encode, mesh (1, 2): heads and hidden features
        # over the two ranks (K1 at [B, 208, 1152], 6 heads)
        t1 = time.perf_counter()
        mesh = make_mesh((1, 2))
        names = [_classname(c) for c in range(50)]
        tp = Predictor("ViT-B/16", names, batch_size=32, mesh=mesh,
                       device=device)
        one = Predictor("ViT-B/16", names, batch_size=32, device=device)
        images, _ = batch(32, 50)
        p_tp = tp.predict(images.cpu().numpy())["probs"]
        p_one = one.predict(images.cpu().numpy())["probs"]
        with torch.inference_mode():
            x = tp._preprocess(images)
            f_tp = M.encode_image(tp.model, tp.cfg, x, dtype=tp.dtype,
                                  tp=tp.tp)
            f_one = M.encode_image(one.model, one.cfg, x, dtype=one.dtype)
        rec = {"mesh": [1, 2], "batch": 32,
               "feature_cos_gap": _cos_gap(f_tp, f_one),
               **_probs_check("TP Predictor", p_tp, p_one)}
        if not rec["feature_cos_gap"] <= MESH_COS_TOL:
            raise AssertionError(f"mesh_path TP Predictor: {rec}")
        res["tp_predictor"] = rec
        seconds["tp_predictor"] = time.perf_counter() - t1
        # the int8 and w8a8 TP Predictors on (1, 2): each rank's int8
        # columns of wqkv and w_fc and rows of wo and w_proj (K3 at the TP
        # shapes, the 1-row bucket on dynamic scales with the MAX over
        # the ranks), static scales calibrated unsharded on 32 images
        cal, _ = batch(32, 50)
        images, _ = batch(64, 50)
        host = images.cpu().numpy()
        for quantize in ("int8", "w8a8"):
            t1 = time.perf_counter()
            kw = ({"calibration_images": cal.cpu().numpy()}
                  if quantize == "w8a8" else {})
            tpq = Predictor("ViT-B/16", names, batch_size=64, mesh=mesh,
                            quantize=quantize, device=device, **kw)
            oneq = Predictor("ViT-B/16", names, batch_size=64,
                             quantize=quantize, device=device, **kw)
            k3_0 = k3.count()
            p_tp = [tpq.predict(x)["probs"] for x in (host, host[:1])]
            k3_tp = k3.count() - k3_0
            p_one = [oneq.predict(x)["probs"] for x in (host, host[:1])]
            # two image forwards (64 rows, 1 row), 50 products each
            want = 2 * k3_per_w8a8_forward() if quantize == "w8a8" else 0
            rec = {"mesh": [1, 2], "batch": 64, "k3_launches": k3_tp,
                   **_probs_check(f"TP {quantize} Predictor",
                                  np.concatenate(p_tp),
                                  np.concatenate(p_one))}
            if k3_tp != want:
                raise AssertionError(f"mesh_path TP {quantize} Predictor: "
                                     f"K3 launched {k3_tp} times, not "
                                     f"{want}")
            res[f"tp_predictor_{quantize}"] = rec
            seconds[f"tp_predictor_{quantize}"] = time.perf_counter() - t1
            del tpq, oneq
        if device_type == "cuda":
            torch.cuda.synchronize()
    finally:
        _remove_kernels(k1, k2, k3)
    res["seconds"] = {**seconds, "total": time.perf_counter() - t0}
    res.update(_rank_launches(rank, k1, k2, k3))
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    with open(out_path, "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


def _rank_kernels():
    """Stand-ins that record K1's, K2's and K3's calls in a rank process,
    installed with the wrappers' own launch counters set to 0 (held to the
    stand-ins' counts by ``_rank_launches``); the LayerNorm kernels'
    counters set to 0 too."""
    from clip_calibration_tpu_torch.ops import attention
    from clip_calibration_tpu_torch.ops import int8_matmul as int8_ops
    from clip_calibration_tpu_torch.ops import layer_norm as ln_ops
    from clip_calibration_tpu_torch.ops import mha_qkv as kernels
    ln_ops.layer_norm.launches = ln_ops.layer_norm_bwd.launches = 0
    k1 = Recorder(kernels.mha_qkv)
    k2 = Recorder(kernels.mha_qkv_bwd)
    k3 = ShapeRecorder(int8_ops.kernel_product)
    attention.mha_qkv, kernels.mha_qkv_bwd, int8_ops.kernel_product = \
        k1, k2, k3
    kernels.mha_qkv.launches = k2.fn.launches = \
        int8_ops.int8_matmul.launches = 0
    return k1, k2, k3


def _remove_kernels(k1, k2, k3) -> None:
    from clip_calibration_tpu_torch.ops import attention
    from clip_calibration_tpu_torch.ops import int8_matmul as int8_ops
    from clip_calibration_tpu_torch.ops import mha_qkv as kernels
    attention.mha_qkv, kernels.mha_qkv_bwd, int8_ops.kernel_product = \
        k1.fn, k2.fn, k3.fn


def _rank_launches(rank, k1, k2, k3) -> dict:
    """The kernels' own counters, which must equal the recorded calls, and
    the calls by shape (JSON): K1 and K2 as [qkv shape, heads, dtype,
    mask key, count], K3 as [(M, K, N), route, count]; the LayerNorm
    kernels' launches (their counters alone)."""
    from clip_calibration_tpu_torch.ops import layer_norm as ln_ops
    from clip_calibration_tpu_torch.ops.int8_matmul import int8_matmul
    counters = {"mha_qkv": k1.fn.launches, "mha_qkv_bwd": k2.fn.launches,
                "int8_matmul": int8_matmul.launches}
    recorded = {"mha_qkv": k1.count(), "mha_qkv_bwd": k2.count(),
                "int8_matmul": k3.count()}
    if recorded != counters:
        raise AssertionError(f"rank {rank}: the recorded calls {recorded} "
                             f"are not the kernels' launches {counters}")
    return {
        "counters": counters,
        "k1": [[list(s), h, str(dt).split(".")[-1], _mask_key(m), n]
               for s, h, dt, m, n in k1.calls],
        "k2": [[list(s), h, str(dt).split(".")[-1], _mask_key(m), n]
               for s, h, dt, m, n in k2.calls],
        "k3": [[list(mkn), route, n] for mkn, routes in k3.calls.items()
               for route, n in routes.items()],
        "k3_without_kmajor": k3.without_kmajor,
        "layer_norm": {"layer_norm_fwd": ln_ops.layer_norm.launches,
                       "layer_norm_bwd": ln_ops.layer_norm_bwd.launches}}


def serve_worker(rank: int, port: int, out_path: str, argv,
                 device_type: str = "cuda") -> None:
    """One rank of mesh_path (c) (``chip_smoke.py --serve-worker RANK PORT
    OUT ARGS...``): joins a gloo group of two ranks sharing the card, then
    runs the port's serve CLI with ARGS (``--http ... --mesh 1,2``) over
    it: rank 0 serves until SIGTERM, rank 1 follows. Writes the CLI's exit
    code and the kernels' launches by shape to ``out_path`` as JSON."""
    import torch
    from clip_calibration_tpu_torch import serve
    from clip_calibration_tpu_torch.parallel.mesh import initialize_distributed
    os.environ.update(CC_COORD_ADDR=f"localhost:{port}", CC_NUM_PROCS="2",
                      CC_PROC_ID=str(rank))
    initialize_distributed(backend="gloo", device=device_type)
    # joined already (NCCL, serve's default on a card, refuses two ranks on
    # one device): the CLI serves over this group
    os.environ.pop("CC_COORD_ADDR")
    k1, k2, k3 = _rank_kernels()
    try:
        rc = serve.main(list(argv))
        if device_type == "cuda":
            torch.cuda.synchronize()
    finally:
        _remove_kernels(k1, k2, k3)
    res = {"rank": rank, "rc": rc, **_rank_launches(rank, k1, k2, k3)}
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    with open(out_path, "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_mesh_path(k1, k2, k3):
    """(a) The port's CLI with ``TPU.DISTRIBUTED True`` at one rank, NCCL
    on the card: golden stage 1 (its ``=> result`` block must equal
    main_path's) and 3 CoOp steps. (b) Two ranks sharing the card over
    gloo (``mesh_worker``): DP CoOp and ProGrad steps at batch 32 on mesh
    (2, 1), CoCoOp and ProDA class-sharded steps on (1, 2) at their published
    configs (ProDA's classifier on the w8a8 text tower), the full, int8
    and w8a8 TP Predictors on (1, 2), each held to one rank. (c) HTTP
    over the two ranks (``run_mesh_http``). A failure in either rank
    fails the phase. The ranks' K1/K2/K3 calls join ``k1``/``k2``/``k3``
    for the kernel checks. Returns the path's launches by kernel
    instance."""
    import subprocess
    import torch
    import torch.distributed as dist
    from clip_calibration_tpu_torch.ops.int8_matmul import int8_matmul
    from clip_calibration_tpu_torch.ops.mha_qkv import mha_qkv, mha_qkv_bwd
    from clip_calibration_tpu_torch.trainers.coop import CoOp

    common, coop, opts = _common_args(1)
    dist_env = {"CC_COORD_ADDR": f"localhost:{_free_port()}",
                "CC_NUM_PROCS": "1", "CC_PROC_ID": "0"}
    stages = [
        ("mesh_zsclip_base", ["--trainer", "ZeroshotCLIP", "--config-file",
                              osp.join(ROOT, "configs", "trainers",
                                       "ZeroshotCLIP", "vit_b16.yaml")],
         ["DATASET.SUBSAMPLE_CLASSES", "base"]),
        # 2 shots of the 50 base classes: 3 steps of 32
        ("mesh_coop_train", coop,
         ["DATASET.NUM_SHOTS", "2", "DATASET.SUBSAMPLE_CLASSES", "base",
          "OPTIM.MAX_EPOCH", "1", "TEST.NO_TEST", "True",
          "TRAIN.PRINT_FREQ", "1"]),
    ]
    steps = [0]
    forward_backward = CoOp.forward_backward

    def counted_step(self, batch):
        steps[0] += 1
        return forward_backward(self, batch)

    mha_qkv.launches = mha_qkv_bwd.launches = int8_matmul.launches = 0
    before = (k1.count(), k2.count(), k3.count())
    CoOp.forward_backward = counted_step
    try:
        for name, args, extra in stages:
            os.environ.update(dist_env)
            dist_env["CC_COORD_ADDR"] = f"localhost:{_free_port()}"
            seconds, log_path = _cli_stage(
                name, common + args + ["--output-dir",
                                       osp.join(WORK, "out", name)]
                + opts + extra + ["TPU.DISTRIBUTED", "True"],
                "log.txt")
            backend = dist.get_backend()
            world = dist.get_world_size()
            # NCCL on the card at one rank: one all_reduce through it
            t = torch.ones(4, device="cuda")
            dist.all_reduce(t)
            torch.cuda.synchronize()
            dist.destroy_process_group()
            if (backend, world) != ("nccl", 1) or not bool((t == 1).all()):
                raise AssertionError(f"{name}: backend {backend}, world "
                                     f"{world}, all_reduce {t.tolist()}")
            rec = {"stage": name, "seconds": seconds, "backend": backend,
                   "world": world}
            if name == "mesh_zsclip_base":
                block = _result_block(log_path)
                want = _result_block(osp.join(WORK, "out", "zsclip_base",
                                              "log.txt"))
                if block != want:
                    raise AssertionError(f"{name}: result block\n{block}\n"
                                         f"differs from main_path's\n{want}")
                rec["result_equals_main_path"] = True
                rec["metrics"] = _checked_metrics(name, log_path)
            else:
                losses = [float(x) for x in re.findall(
                    r" loss (\S+) \(", open(log_path).read())]
                if steps[0] != 3 or len(losses) != 3 or not all(
                        map(math.isfinite, losses)):
                    raise AssertionError(f"{name}: {steps[0]} steps, "
                                         f"losses {losses}")
                rec.update(steps=steps[0], losses=losses)
            emit("mesh_path", **rec)
    finally:
        CoOp.forward_backward = forward_backward
        for key in ("CC_COORD_ADDR", "CC_NUM_PROCS", "CC_PROC_ID"):
            os.environ.pop(key, None)
        if dist.is_initialized():
            dist.destroy_process_group()
    one_rank = {"mha_qkv_fwd": mha_qkv.launches,
                "mha_qkv_bwd": mha_qkv_bwd.launches}
    if (k1.count() - before[0], k2.count() - before[1]) != (
            mha_qkv.launches, mha_qkv_bwd.launches) or mha_qkv_bwd.launches \
            != 12 * 3:
        raise AssertionError(f"mesh_path one rank: launches {one_rank}")

    # (b): the kernels were built by the build phase; the ranks load them
    port = _free_port()
    outs = [osp.join(WORK, "mesh", f"rank{r}.json") for r in range(2)]
    os.makedirs(osp.join(WORK, "mesh"), exist_ok=True)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, osp.abspath(__file__), "--mesh-worker", str(r),
         str(port), outs[r]], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=900)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        with open(osp.join(WORK, "mesh", f"rank{r}.log"), "w") as f:
            f.write(log)
        if p.returncode != 0:
            raise AssertionError(f"mesh_path rank {r} failed (exit "
                                 f"{p.returncode}):\n{log[-6000:]}")
    ranks = [json.load(open(o)) for o in outs]
    launches = dict.fromkeys(("mha_qkv_fwd", "mha_qkv_fwd_f32",
                              "mha_qkv_bwd", "mha_qkv_bwd_f32",
                              "int8_matmul", "layer_norm_fwd",
                              "layer_norm_bwd"), 0)
    for res in ranks:
        n1, n2 = ({dt: sum(c[4] for c in res[k] if c[2] == dt)
                   for dt in ("bfloat16", "float32")} for k in ("k1", "k2"))
        n3 = res["counters"]["int8_matmul"]
        if not (all(n1.values()) and all(n2.values()) and n3) \
                or res["k3_without_kmajor"] \
                or (sum(n1.values()), sum(n2.values())) != (
                    res["counters"]["mha_qkv"],
                    res["counters"]["mha_qkv_bwd"]):
            raise AssertionError(f"mesh_path rank {res['rank']}: launches "
                                 f"K1 {n1}, K2 {n2}, K3 {n3}, counted "
                                 f"{res['counters']}")
        # the counters' launches, split by dtype as the calls were
        launches["mha_qkv_fwd"] += n1["bfloat16"]
        launches["mha_qkv_fwd_f32"] += n1["float32"]
        launches["mha_qkv_bwd"] += n2["bfloat16"]
        launches["mha_qkv_bwd_f32"] += n2["float32"]
        launches["int8_matmul"] += n3
        for kernel, n in res["layer_norm"].items():
            launches[kernel] += n
        emit("mesh_path", stage="two_ranks_gloo", rank=res["rank"],
             backend=res["backend"], world=res["world"],
             weights="seeded random init (no accuracy claim)",
             gloo_cuda_collectives=res["gloo_cuda_collectives"],
             tolerances={"loss_rtol": MESH_LOSS_RTOL,
                         "grad_rtol": MESH_GRAD_RTOL,
                         "class_grad_rtol": MESH_CLASS_GRAD_RTOL,
                         "fp32_loss_rtol": MESH_FP32_LOSS_RTOL,
                         "fp32_grad_rtol": MESH_FP32_GRAD_RTOL,
                         "cos_tol": MESH_COS_TOL,
                         "probs_atol": MESH_PROBS_ATOL},
             **{k: res[k] for k in ("CoOp", "ProGrad", "CoOp_fp32",
                                    "CoCoOp", "ProDA",
                                    "tp_predictor", "tp_predictor_int8",
                                    "tp_predictor_w8a8", "seconds",
                                    "counters", "layer_norm")},
             launches={
                 "mha_qkv_fwd": {f"{s} {h} heads {dt} {m[0]}": n
                                 for s, h, dt, m, n in res["k1"]},
                 "mha_qkv_bwd": {f"{s} {h} heads {dt} {m[0]}": n
                                 for s, h, dt, m, n in res["k2"]},
                 "int8_matmul": {f"{mkn} {route}": n
                                 for mkn, route, n in res["k3"]}})
        _join_calls(res, k1, k2, k3)
    emit("mesh_path", stage="two_ranks_total",
         seconds=time.perf_counter() - t0, launches=launches)
    http = run_mesh_http(k1, k2, k3)
    launches["mha_qkv_fwd"] += one_rank["mha_qkv_fwd"] + http["mha_qkv_fwd"]
    launches["mha_qkv_bwd"] += one_rank["mha_qkv_bwd"]
    launches["int8_matmul"] += http["int8_matmul"]
    for kernel in ("layer_norm_fwd", "layer_norm_bwd"):
        launches[kernel] += http[kernel]
    return launches


def _join_calls(res, k1, k2, k3, device="cuda") -> None:
    """A rank's K1/K2/K3 calls by shape (``_rank_launches``) join ``k1``,
    ``k2`` and ``k3`` for the kernel checks (masks rebuilt on
    ``device``)."""
    import torch
    dev = torch.device(device)
    for rec, calls in ((k1, res["k1"]), (k2, res["k2"])):
        for shape, heads, dt, (kind, real, L), n in calls:
            mask = pad_mask(real, L, "causal" in kind, dev)
            dtype = getattr(torch, dt)
            entry = next((e for e in rec.calls if e[:3] == [
                tuple(shape), heads, dtype] and torch.equal(e[3], mask)),
                None)
            if entry is None:
                rec.calls.append([tuple(shape), heads, dtype, mask, n])
            else:
                entry[4] += n
    for mkn, route, n in res["k3"]:
        routes = k3.calls.setdefault(tuple(mkn), {})
        routes[route] = routes.get(route, 0) + n


#: mesh_path (c): seconds for the two serving ranks to come up (predictor
#: build, static scales loaded, two warm-up batches), and, after SIGTERM to
#: rank 0, for both to exit
MESH_HTTP_START_S = 300
MESH_HTTP_EXIT_S = 60


def run_mesh_http(k1, k2, k3, device="cuda") -> dict:
    """(c) The port's serve CLI with ``--http 127.0.0.1:0 --mesh 1,2
    --quantize w8a8`` (the static scales ``serve_path`` saved) on two ranks
    sharing the card over gloo (``serve_worker``): rank 0 serves, rank 1
    joins each batch. 8 concurrent single images, then one JSON batch of
    8; each answer held to a one-rank w8a8 Predictor in this process on
    the image inside a batch (static scales) or alone (the 1-row bucket),
    within ``MESH_PROBS_ATOL``. Then SIGTERM to rank 0: both ranks
    must exit 0 within ``MESH_HTTP_EXIT_S``. Each rank's K3 launches are
    50 per image forward and its K1 launches 12 (and 12 for the class
    prompts' text encode); their calls join the kernel checks. Returns the ranks' K1 (bf16), K3 and LayerNorm launches."""
    import signal
    import subprocess
    import numpy as np
    from PIL import Image
    from clip_calibration_tpu_torch.data.datasets.synthetic import _classname
    from clip_calibration_tpu_torch.models.clip import PRESETS
    from clip_calibration_tpu_torch.serving import Predictor
    d = osp.join(WORK, "mesh", "http")
    os.makedirs(d, exist_ok=True)
    names_file = osp.join(WORK, "serve", "classes.txt")
    scales = osp.join(WORK, "serve", "act_scales.npz")
    argv = ["--device", device, "--backbone", "ViT-B/16",
            "--classnames-file", names_file, "--quantize", "w8a8",
            "--act-scales", scales, "--batch-size", "64",
            "--max-wait-ms", "20", "--http", "127.0.0.1:0", "--mesh", "1,2"]
    port = _free_port()
    outs = [osp.join(d, f"rank{r}.json") for r in range(2)]
    logs = [osp.join(d, f"rank{r}.log") for r in range(2)]
    t0 = time.perf_counter()
    files = [open(log, "w") for log in logs]
    procs = [subprocess.Popen(
        [sys.executable, osp.abspath(__file__), "--serve-worker", str(r),
         str(port), outs[r], *argv], stdout=files[r],
        stderr=subprocess.STDOUT) for r in range(2)]
    try:
        url = _serving_url(procs, logs, MESH_HTTP_START_S)
        start_s = time.perf_counter() - t0
        imgs = osp.join(WORK, "serve", "imgs")
        paths = [osp.join(imgs, p) for p in sorted(os.listdir(imgs))[:16]]
        blobs = [open(p, "rb").read() for p in paths]
        answers = _concurrent_posts(url, blobs[:8])
        batch_rows = _post(url, json.dumps({"images": [
            base64.b64encode(b).decode() for b in blobs[8:]]}).encode(),
            "application/json")["predictions"]
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        t1 = time.perf_counter()
        procs[0].send_signal(signal.SIGTERM)
        for p in procs:
            p.wait(timeout=MESH_HTTP_EXIT_S)
        exit_s = time.perf_counter() - t1
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    if [p.returncode for p in procs] != [0, 0]:
        raise AssertionError("mesh_path http: exit codes "
                             f"{[p.returncode for p in procs]}\n" + "\n".join(
                                 open(log).read()[-4000:] for log in logs))
    ranks = [json.load(open(o)) for o in outs]
    # the answers against one rank: the image inside a batch (static
    # scales) or alone (the 1-row bucket's dynamic ones)
    with open(osp.join(d, "one_rank.console.txt"), "w") as con:
        sys.stdout = con
        try:
            one = Predictor("ViT-B/16", [_classname(c) for c in range(50)],
                            quantize="w8a8", act_scales=scales,
                            batch_size=64, device=device)
        finally:
            sys.stdout = sys.__stdout__
    images = np.stack([np.asarray(Image.open(p).convert("RGB"))
                       for p in paths])
    refs = [one.predict(images)] + [one.predict(images[i:i + 1])
                                    for i in range(16)]
    gaps = []
    for i, row in enumerate([answers[i] for i in range(8)] + batch_rows):
        ref, j = min([(refs[0], i), (refs[1 + i], 0)], key=lambda c: abs(
            row["confidence"] - float(c[0]["confidences"][c[1]])))
        gap = abs(row["confidence"] - float(ref["confidences"][j]))
        top2 = np.sort(ref["probs"][j])[-2:]
        if gap > MESH_PROBS_ATOL or (
                top2[1] - top2[0] > 2 * MESH_PROBS_ATOL
                and row["pred"] != one.classnames[int(ref["preds"][j])]):
            raise AssertionError(f"mesh_path http: answer {i} {row} "
                                 f"differs from one rank's")
        gaps.append(gap)
    launches = {"mha_qkv_fwd": 0, "int8_matmul": 0, "layer_norm_fwd": 0,
                "layer_norm_bwd": 0}
    cfg = PRESETS["ViT-B/16"]
    per_forward = k3_per_w8a8_forward()
    for res in ranks:
        c = res["counters"]
        forwards = c["int8_matmul"] // per_forward
        # K1: every image forward's layers, and the class prompts' text
        # encode once
        if not (forwards and c["int8_matmul"] == per_forward * forwards
                and c["mha_qkv"] == cfg.vision_layers * forwards
                + cfg.transformer_layers
                and c["mha_qkv_bwd"] == 0
                and c == ranks[0]["counters"]) or res["k3_without_kmajor"]:
            raise AssertionError(f"mesh_path http rank {res['rank']}: "
                                 f"launches {c}")
        launches["mha_qkv_fwd"] += c["mha_qkv"]
        launches["int8_matmul"] += c["int8_matmul"]
        for kernel, n in res["layer_norm"].items():
            launches[kernel] += n
        _join_calls(res, k1, k2, k3, device)
    emit("mesh_path", stage="http_two_ranks", command="serve " + " ".join(
        argv[2:]), weights="seeded random init (no accuracy claim)",
         start_seconds=start_s, exit_seconds=exit_s,
         exit_codes=[p.returncode for p in procs],
         requests=stats["requests"], batches=stats["batches"],
         mean_batch=stats["mean_batch"],
         confidence_max_abs_diff=max(gaps),
         probs_atol=MESH_PROBS_ATOL,
         launches_per_rank={r["rank"]: r["counters"] for r in ranks},
         int8_matmul_by_shape={f"{mkn} {route}": n
                               for mkn, route, n in ranks[0]["k3"]})
    return launches


def _serving_url(procs, logs, limit: float) -> str:
    """The ``serving on http://...`` URL rank 0 prints, waited for at most
    ``limit`` seconds (a rank that exits first fails the phase)."""
    deadline = time.monotonic() + limit
    while time.monotonic() < deadline:
        for line in open(logs[0]).read().splitlines():
            if line.startswith("serving on http://"):
                return line.split()[2]
        if any(p.poll() is not None for p in procs):
            break
        time.sleep(0.5)
    raise AssertionError("mesh_path http: no server\n" + "\n".join(
        open(log).read()[-4000:] for log in logs))


def _post(url, body, ctype):
    req = urllib.request.Request(url + "/predict", data=body,
                                 headers={"Content-Type": ctype},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _concurrent_posts(url, blobs) -> dict:
    """One POST of each PNG in ``blobs``, all at once; their answers by
    index."""
    import threading
    answers, errors = {}, []

    def hit(i):
        try:
            answers[i] = _post(url, blobs[i], "image/png")
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)

    threads = [threading.Thread(target=hit, args=(i,))
               for i in range(len(blobs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    if errors or len(answers) != len(blobs):
        raise AssertionError(f"HTTP requests failed: {errors}")
    return answers


def _result_block(log_path: str) -> str:
    text = open(log_path).read()
    m = re.search(r"=> result\n(\*.*\n)+", text)
    if m is None:
        raise AssertionError(f"no result block in {log_path}")
    return m.group(0)


def check_kernels_bwd(device, launched):
    """K2 vs its plain version, timed, at every (qkv shape, heads, mask)
    the train paths launched it with, in bf16 and fp32, and at the
    ViT-B/16 vision shape at batch 32 with its pad mask (no path launches
    it: a yardstick kept from earlier runs); then correctness only at the
    same edges as K1."""
    import torch
    from clip_calibration_tpu_torch.ops.mha_qkv import (
        bwd_route, mha_qkv_bwd, mha_qkv_bwd_reference)
    from clip_calibration_tpu_torch.tools.profiling import (L2_FLUSH_BYTES,
                                                            time_ms)
    cases = by_shape(launched)
    vision = ((32, 208, 2304), 12, pad_mask(197, 208, False, device))
    if not any(c[:2] == vision[:2] and torch.equal(c[2], vision[2])
               for c in cases):
        cases.append(vision + ({},))
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device).manual_seed(2)
    out = []
    for (B, L, D3), H, mask, calls in cases:
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
                "route": bwd_route(L, dtype),
                "main_path_launches": calls.get(dname, 0),
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
    for B, real, L, D, H, causal in K2_EDGES:
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
                           "route": bwd_route(L, dtype),
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


def check_prompt_step(device):
    """One VPT loss and vision-prompt gradient at full ViT-B/16 width,
    fp32 (the published VPT prompts: 8 tokens, depth 12, batch 4): on
    the card (K1 forward, K2 backward at L 205 padded to 208) vs the CPU
    (plain versions), same weights, prompts, text features and images."""
    import torch
    import torch.nn.functional as F
    from clip_calibration_tpu_torch.models import clip as M
    from clip_calibration_tpu_torch.models.backbone import load_clip_backbone
    from clip_calibration_tpu_torch.models.tokenizer import tokenize
    from clip_calibration_tpu_torch.models.weights import (flat_params,
                                                           params_from_numpy)
    model, cfg = load_clip_backbone("ViT-B/16", "float32", device)
    cpu_model = params_from_numpy(flat_params(model), cfg, torch.float32,
                                  "cpu")
    gen = torch.Generator().manual_seed(4)
    images = torch.randn((4, 224, 224, 3), generator=gen)
    labels = torch.randint(0, 10, (4,), generator=gen)
    shallow0 = torch.randn((8, 768), generator=gen) * 0.02
    deep0 = torch.randn((11, 8, 768), generator=gen) * 0.02
    toks = torch.as_tensor(tokenize(
        ["a photo of a " + n + "." for n in (
            "red swirl", "green checker", "blue wave", "yellow dot",
            "purple stripe", "orange grid", "cyan blob", "magenta ring",
            "white noise", "dark cross")]), dtype=torch.long)
    grads, losses = {}, {}
    for dev, m in ((device, model), ("cpu", cpu_model)):
        with torch.no_grad():
            txt = M.encode_text(m, cfg, toks.to(dev), dtype=torch.float32,
                                seq_len=M.eot_seq_len(toks.numpy()))
        shallow = shallow0.to(dev).requires_grad_()
        deep = deep0.to(dev).requires_grad_()
        img = M.encode_image(m, cfg, images.to(dev), dtype=torch.float32,
                             shallow_prompts=shallow, deep_prompts=deep,
                             deep_prompt_depth=12)
        loss = F.cross_entropy(M.cosine_logits(img, txt, m.logit_scale),
                               labels.to(dev))
        loss.backward()
        grads[str(dev)] = (shallow.grad.cpu(), deep.grad.cpu())
        losses[str(dev)] = float(loss.detach())
    rel = {}
    for i, name in enumerate(("shallow", "deep")):
        want, got = grads["cpu"][i], grads[str(device)][i]
        rel[name] = float((got - want).abs().max() / want.abs().max())
        if not (math.isfinite(rel[name]) and rel[name] <= TRAIN_GRAD_RTOL
                and float(want.abs().max()) > 0):
            raise AssertionError(f"VPT {name} prompt gradient on the card "
                                 f"differs from the CPU by {rel[name]} "
                                 f"(relative)")
    emit("prompt_check", backbone="ViT-B/16", dtype="float32",
         loss={"card": losses[str(device)], "cpu": losses["cpu"]},
         grad_max_rel_diff=rel, rtol=TRAIN_GRAD_RTOL)


def check_fanout_step(device):
    """The fan-out trainers' gradients at full ViT-B/16 width, fp32, on the
    card (K1, K2) against the CPU (plain versions), same weights, inputs
    and trainables: CoCoOp's context and meta-net over 11 images x 50
    classes (550 text rows, so two checkpointed chunks of 10 and 1 images:
    K1 runs again in the backward), and ProGrad's two gradients (the
    second backward pass over the retained graph) and its projection,
    against the KL gradient and against its opposite (a conflict: the
    projecting branch)."""
    import torch
    import torch.nn.functional as F
    from clip_calibration_tpu_torch.data.datasets.synthetic import _classname
    from clip_calibration_tpu_torch.models import clip as M
    from clip_calibration_tpu_torch.models.backbone import load_clip_backbone
    from clip_calibration_tpu_torch.models.tokenizer import tokenize
    from clip_calibration_tpu_torch.models.weights import (flat_params,
                                                           params_from_numpy)
    from clip_calibration_tpu_torch.ops.mha_qkv import mha_qkv, mha_qkv_bwd
    from clip_calibration_tpu_torch.trainers import cocoop
    from clip_calibration_tpu_torch.trainers.coop import (
        assemble_prompts, build_prompt_assembly)
    from clip_calibration_tpu_torch.trainers.prograd import (prograd_losses,
                                                             prograd_project)
    model, cfg = load_clip_backbone("ViT-B/16", "float32", device)
    cpu_model = params_from_numpy(flat_params(model), cfg, torch.float32,
                                  "cpu")
    gen = torch.Generator().manual_seed(7)
    names = [_classname(c) for c in range(50)]
    labels = torch.randint(0, 50, (11,), generator=gen)
    hid, width = cfg.embed_dim // 16, cfg.transformer_width
    res = cfg.image_resolution
    images = torch.randn((11, res, res, 3), generator=gen)

    def uniform(shape, fan_in):
        return (torch.rand(shape, generator=gen) * 2 - 1) * fan_in ** -0.5

    init = {"ctx": torch.randn((4, width), generator=gen) * 0.02,
            "w1": uniform((cfg.embed_dim, hid), cfg.embed_dim),
            "b1": uniform((hid,), cfg.embed_dim),
            "w2": uniform((hid, width), hid), "b2": uniform((width,), hid)}
    images8 = torch.randn((8, res, res, 3), generator=gen)
    labels8 = torch.randint(0, 10, (8,), generator=gen)
    ctx16 = torch.randn((16, width), generator=gen) * 0.02
    toks = torch.as_tensor(tokenize([f"a photo of a {n} pattern."
                                     for n in names[:10]]), dtype=torch.long)
    chunks, out = [], {}
    real = cocoop.checkpoint

    def counted(fn, *args, **kwargs):
        chunks.append(args[0].shape[0])
        return real(fn, *args, **kwargs)

    cocoop.checkpoint = counted
    try:
        for dev, m in ((device, model), ("cpu", cpu_model)):
            l0 = (mha_qkv.launches, mha_qkv_bwd.launches)
            asm = build_prompt_assembly(names, 4, "end", "", m,
                                        torch.float32)
            p = {k: v.to(dev).requires_grad_() for k, v in init.items()}
            with torch.no_grad():
                img_f = M.normalize(M.encode_image(
                    m, cfg, images.to(dev), dtype=torch.float32))
            ctx = p["ctx"][None] + cocoop.meta_net_forward(p, img_f)[:, None]
            logits, _ = cocoop.fanout_logits(m, cfg, asm, ctx, img_f)
            loss = F.cross_entropy(logits, labels.to(dev))
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            cocoop_launches = (mha_qkv.launches - l0[0],
                               mha_qkv_bwd.launches - l0[1])

            asm = build_prompt_assembly(names[:10], 16, "end", "", m,
                                        torch.float32)
            ctx = ctx16.to(dev).requires_grad_()
            with torch.no_grad():
                img = M.encode_image(m, cfg, images8.to(dev),
                                     dtype=torch.float32)
                zs = M.normalize(M.encode_text(
                    m, cfg, toks.to(dev), dtype=torch.float32,
                    seq_len=M.eot_seq_len(toks.numpy()))).float()
            txt = M.encode_text_embedded(m, cfg, assemble_prompts(ctx, asm),
                                         asm["eot_pos"],
                                         seq_len=asm["seq_len"])
            scale = torch.exp(m.logit_scale.float())
            xe, kl = prograd_losses(
                M.cosine_logits(img, txt, m.logit_scale),
                scale * (M.normalize(img).float() @ zs.T), labels8.to(dev),
                1.0)
            g_ce, = torch.autograd.grad(xe, [ctx], retain_graph=True)
            g_kl, = torch.autograd.grad(kl, [ctx])
            proj, = prograd_project([g_ce], [g_kl], 1.0)
            # the projecting branch too: against the opposite KL direction
            proj_conflict, = prograd_project([g_ce], [-g_kl], 1.0)
            cos = float((M.normalize(g_ce.flatten()) *
                         M.normalize(g_kl.flatten())).sum())
            out[str(dev)] = {
                "cocoop_loss": float(loss.detach()),
                "prograd_losses": [float(xe.detach()), float(kl.detach())],
                "prograd_cos": cos, "cocoop_launches": cocoop_launches,
                "grads": {**{"cocoop_" + k: g.cpu()
                             for k, g in grads.items()},
                          "prograd_ce": g_ce.cpu(), "prograd_kl": g_kl.cpu(),
                          "prograd_projected": proj.cpu(),
                          "prograd_projected_conflict": proj_conflict.cpu()}}
    finally:
        cocoop.checkpoint = real
    card, cpu = out[str(device)], out["cpu"]
    rel = {k: float((card["grads"][k] - w).abs().max() / w.abs().max())
           for k, w in cpu["grads"].items()}
    emit("fanout_check", backbone="ViT-B/16", dtype="float32",
         cocoop_rows=11 * 50, checkpointed_chunks_of_images=chunks,
         cocoop_card_launches={"mha_qkv_fwd": card["cocoop_launches"][0],
                               "mha_qkv_bwd": card["cocoop_launches"][1]},
         loss={"card": card["cocoop_loss"], "cpu": cpu["cocoop_loss"]},
         prograd_losses={"card": card["prograd_losses"],
                         "cpu": cpu["prograd_losses"]},
         prograd_cos={"card": card["prograd_cos"], "cpu": cpu["prograd_cos"]},
         grad_max_rel_diff=rel, rtol=TRAIN_GRAD_RTOL)
    bad = [k for k, r in rel.items() if not (
        math.isfinite(r) and r <= TRAIN_GRAD_RTOL
        and float(cpu["grads"][k].abs().max()) > 0)]
    # the two checkpointed chunks ran on each device; on the card K1 ran in
    # every text layer of each chunk twice (forward and recompute) and in
    # the vision tower once, K2 in every text layer of each chunk
    n = cfg.transformer_layers
    if (bad or chunks != [10, 1, 10, 1] or card["cocoop_launches"]
            != (cfg.vision_layers + 2 * 2 * n, 2 * n)):
        raise AssertionError(f"fanout_check: gradients {bad} differ beyond "
                             f"{TRAIN_GRAD_RTOL} ({rel}); chunks {chunks}; "
                             f"launches {card['cocoop_launches']}")


class ShapeRecorder:
    """Stands in for ``ops/int8_matmul.py::kernel_product``, through which
    every K3 launch goes, and counts its calls by (M, K, N) and route:
    ``calls`` maps the shape to {route: count}; ``without_kmajor`` counts
    the calls that brought no K-major weight copy."""

    def __init__(self, fn):
        from clip_calibration_tpu_torch.ops.int8_matmul import k3_route
        self.fn = fn
        self.route = k3_route
        self.calls = {}
        self.without_kmajor = 0

    def __call__(self, x, w, w_t=None, xs=None, *args, **kwargs):
        M, K = x.shape
        N = w.shape[1]
        routes = self.calls.setdefault((M, K, N), {})
        route = self.route(M, N, K, xs is not None)
        routes[route] = routes.get(route, 0) + 1
        self.without_kmajor += w_t is None
        return self.fn(x, w, w_t, xs, *args, **kwargs)

    def count(self) -> int:
        return sum(sum(r.values()) for r in self.calls.values())


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
    import threading
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
    url = f"http://{host}:{port}"
    try:
        answers = _concurrent_posts(url, blobs[:8])
        body = json.dumps({"images": [base64.b64encode(b).decode()
                                      for b in blobs[8:16]]}).encode()
        batch_rows = _post(url, body, "application/json")["predictions"]
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        pred.predict = direct
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
    if k3.without_kmajor:
        raise AssertionError(f"{k3.without_kmajor} K3 launches brought no "
                             f"K-major weight copy (qdot passes kmajor)")
    emit("serve_path", stage="totals", tower_forwards=forwards,
         w8a8_image_forwards=w8a8_forwards,
         image_forwards_by_qmode=fwd.by_qmode,
         launches={"mha_qkv_fwd": mha_qkv.launches,
                   "int8_matmul": int8_matmul.launches})
    return mha_qkv.launches, int8_matmul.launches


# correctness and time at shapes the serve path does not reach: (M, K, N)
K3_EDGES = [
    (33, 70, 129),              # every dimension ragged, K padded to 16
    (8, 8, 8),                  # smaller than one tile
    (1, 768, 2304),             # M = 1 (split K)
    (1, 3072, 768),             # M = 1, long K (split K)
    (64 * 272, 1024, 3072),     # ViT-L/14 at batch 64: wqkv
    (64 * 272, 1024, 4096),     # ViT-L/14: w_fc
    (64 * 272, 4096, 1024),     # ViT-L/14: w_proj
]


def check_int8_matmul(device, launched):
    """K3 at every (M, K, N) the serve path launched (and the routes it
    took there: every serve-path product is rescaled) and at
    ``K3_EDGES``: the int32 product exact against its plain version, with
    the weight's K-major copy and without it; the rescaled epilogue bit
    for bit against the plain rescale of the plain product, at per-row and
    0-d scales, to bf16 and fp32. Times: the int32 product (the K-major
    copy made before the timer), its plain version, ``torch._int_mm``
    (cuBLASLt, a yardstick the port never calls; null where its shape
    rules refuse) and the bound; the rescaled bf16 product, the kernel's
    int32 product followed by the PyTorch rescale (``unfused_ms``), the
    plain versions of both, and its bound."""
    import torch
    from clip_calibration_tpu_torch.ops.int8_matmul import (
        int8_matmul, int8_matmul_reference, k3_route, rescale_reference,
        rescaled_int8_matmul)
    from clip_calibration_tpu_torch.tools.profiling import (L2_FLUSH_BYTES,
                                                            time_ms)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device).manual_seed(4)
    cases = [(shape, r) for shape, r in sorted(launched.items())] + \
        [(shape, {}) for shape in K3_EDGES if shape not in launched]
    out = []
    for (M, K, N), routes in cases:
        x = torch.randint(-127, 128, (M, K), generator=gen, device=device,
                          dtype=torch.int32).to(torch.int8)
        w = torch.randint(-127, 128, (K, N), generator=gen, device=device,
                          dtype=torch.int32).to(torch.int8)
        w_t = w.t().contiguous()
        # activation-like scales: per row [M, 1] and one static value
        xs = {"per_row": (torch.rand((M, 1), generator=gen, device=device)
                          + 0.5) / 127,
              "static": torch.tensor(0.75 / 127, device=device)}
        ws = torch.rand((1, N), generator=gen, device=device) / 127
        want = int8_matmul_reference(x, w)
        got = int8_matmul(x, w, w_t)
        exact = bool(torch.equal(got, want)) and bool(
            torch.equal(int8_matmul(x, w), want))
        err = float((got.double() - want.double()).abs().max())
        bit_equal = {}
        for kind, scale in xs.items():
            for dtype in (torch.bfloat16, torch.float32):
                r = rescaled_int8_matmul(x, scale, w, ws, dtype, w_t)
                bit_equal[f"{kind}_{str(dtype)[6:]}"] = bool(torch.equal(
                    r, rescale_reference(want, scale, ws, dtype)))
        torch.cuda.synchronize()
        try:
            torch._int_mm(x, w)
            library_ms = time_ms(lambda: torch._int_mm(x, w), flush)
        except RuntimeError:
            library_ms = None
        xr = xs["per_row"]
        nbytes = M * K + K * N + 4 * M * N
        r_bytes = M * K + K * N + 2 * M * N + 4 * (M + N)
        ops = 2.0 * M * N * K
        t_ops = ops / PEAK_FLOPS["int8"] * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        rec = {"mkn": [M, K, N], "main_path_launches": sum(routes.values()),
               "route": routes or {k3_route(M, N, K, False): 0},
               "exact": exact, "max_abs_err": err,
               "rescaled_bit_equal": bit_equal,
               "ms": time_ms(lambda: int8_matmul(x, w, w_t), flush),
               "plain_ms": time_ms(lambda: int8_matmul_reference(x, w),
                                   flush),
               "library_ms": library_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "ops": ops,
               "rescaled_bf16": {
                   "ms": time_ms(lambda: rescaled_int8_matmul(
                       x, xr, w, ws, torch.bfloat16, w_t), flush),
                   "unfused_ms": time_ms(lambda: rescale_reference(
                       int8_matmul(x, w, w_t), xr, ws, torch.bfloat16),
                       flush),
                   "plain_ms": time_ms(lambda: rescale_reference(
                       int8_matmul_reference(x, w), xr, ws, torch.bfloat16),
                       flush),
                   "bound_ms": max(r_bytes / PEAK_BYTES_PER_S * 1e3, t_ops),
                   "bytes": r_bytes}}
        emit("kernel int8_matmul", **rec)
        if not (exact and all(bit_equal.values())):
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

    def recorded(x, w, qmode="dequant", row_amax=None):
        out = Q.qdot(x, w, qmode, row_amax)
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
    (2, 208, 768, 12, 197, False),   # B H = 24 < 132 SMs: queries split
    (1, 1024, 768, 12, 1000, False),  # L at the kernel's 1024 limit
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
                "bytes_ms": t_bytes, "ops_ms": t_ops,
            }
            emit("kernel int8_attention", **rec)
            if not ok:
                raise AssertionError(
                    f"int8_attention disagrees with its plain version: {rec}")
            out.append(rec)
    del flush
    return out


# the LayerNorm kernels' timed shapes, [rows, width], besides those the main
# path launched: bigG's vision rows (32 x 272) and text rows (500 x 32), the
# L/14 eval batch's vision rows (100 x 272), and a B/16 ln_post ([32,
# 768]); then correctness only at every other width the port runs, ragged
# row counts and the narrowest and widest rows
LN_TIMED = [(8704, 1664), (16000, 1280), (27200, 1024), (32, 768)]
LN_EDGES = [(5, 64), (333, 512), (7, 640), (130, 768), (3, 8), (9, 16),
            (17, 136), (65, 2048), (1, 1280)]
# the LayerNorm kernels vs their plain versions, |diff| <= ATOL * max|plain|
# + RTOL * |plain| (y and dx). Both compute in fp32 from the same inputs
# and differ only in the order of their sums, about 1e-6 of a row's scale
# (under ATOL); y and dx are then rounded once to x's dtype, and in bf16
# one such rounding may flip: one bf16 step, at most 2^-7 of the value
# (RTOL 8e-3). A backward that drops its xh * mean(g' xh) term, about
# rstd / sqrt(D) of the gradient, is outside them (``check_layer_norm``
# plants it at every timed shape).
LN_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 8e-3)}
# the kernels' fp32 mean and rstd against the plain version's: the same
# fp32 sums in another order, |diff| <= ATOL + RTOL * |plain|
LN_STATS_TOL = (1e-5, 1e-5)


def ln_within(got, want, dtype_name: str):
    """(max |got - want|, within ``LN_TOL`` and finite) for a LayerNorm
    output ``got`` against its plain version ``want``."""
    import torch
    atol, rtol = LN_TOL[dtype_name]
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    bound = atol * float(want.abs().max()) + rtol * want.abs()
    return float(diff.max()), bool(torch.isfinite(got).all()) and bool(
        (diff <= bound).all())


def ln_dropped_term(x, scale, mean, rstd, g):
    """The backward without its xh * mean(g' xh) term, rounded to x's
    dtype: a planted fault that ``LN_TOL`` must reject."""
    gs = g.float() * scale.float()
    return (rstd * (gs - gs.mean(dim=-1, keepdim=True))).to(x.dtype)


class LayerNormRecorder:
    """Stands in for one LayerNorm launcher of ``ops/layer_norm.py``
    (``_forward`` or ``layer_norm_bwd``, called as ``fn(x, ...)``) and
    counts the launches it makes by [rows, width, dtype name] under the
    path named by ``path``: ``calls[path][(rows, width, dtype)]``. A launch
    is a step of ``counter.launches``, the kernel's own counter, so CPU
    calls (the plain versions) are not counted."""

    def __init__(self, fn, counter):
        self.fn, self.counter = fn, counter
        self.path = None
        self.calls = {}

    def __call__(self, x, *args):
        before = self.counter.launches
        out = self.fn(x, *args)
        if self.counter.launches != before:
            key = (x.numel() // x.shape[-1], x.shape[-1],
                   str(x.dtype).split(".")[-1])
            by_shape = self.calls.setdefault(self.path, {})
            by_shape[key] = by_shape.get(key, 0) + 1
        return out

    def count(self, path=None) -> int:
        return sum(n for p, by_shape in self.calls.items()
                   if path in (None, p) for n in by_shape.values())

    # the backward's launcher bumps its counter through this stand-in
    # when the stand-in replaces it in its own module
    @property
    def launches(self) -> int:
        return self.fn.launches

    @launches.setter
    def launches(self, value: int):
        self.fn.launches = value


LN_KERNELS = ("layer_norm_fwd", "layer_norm_bwd")
#: the paths that run a tower on the card (every path but the probe's),
#: and those that also train through one
LN_FWD_PATHS = ("main_path", "train_path", "fp32_path", "prompt_path",
                "fanout_path", "serve_path", "mesh_path")
LN_BWD_PATHS = ("train_path", "fp32_path", "prompt_path", "fanout_path",
                "mesh_path")


def check_layer_norm_paths(ln_fwd, ln_bwd, mesh) -> dict:
    """The LayerNorm kernels' launches by path: the stand-ins' counts in
    this process, each path's from 0, held to the kernels' own counters;
    ``mesh_path`` adds its rank processes' counters (``mesh``, from
    ``run_mesh_path``), which count launches but not shapes. Fails where
    a path that runs a tower on the card launched no forward kernel, or one
    that trains no backward kernel: its LayerNorms left the kernels.
    Returns {path: {kernel: launches}}."""
    from clip_calibration_tpu_torch.ops import layer_norm as ln_ops
    counted = (ln_fwd.count(), ln_bwd.count())
    counters = (ln_ops.layer_norm.launches, ln_ops.layer_norm_bwd.launches)
    paths = ("main_path", "train_path", "fp32_path", "prompt_path",
             "fanout_path", "serve_path", "probe_path", "mesh_path")
    by_path = {p: {"layer_norm_fwd": ln_fwd.count(p),
                   "layer_norm_bwd": ln_bwd.count(p)} for p in paths}
    ranks = {k: mesh[k] for k in LN_KERNELS}
    for k in LN_KERNELS:
        by_path["mesh_path"][k] += ranks[k]
    missing = ([(p, "layer_norm_fwd") for p in LN_FWD_PATHS
                if not by_path[p]["layer_norm_fwd"]]
               + [(p, "layer_norm_bwd") for p in LN_BWD_PATHS
                  if not by_path[p]["layer_norm_bwd"]]
               + [("mesh ranks", k) for k in LN_KERNELS if not ranks[k]])
    emit("layer_norm_paths", launches_by_path=by_path,
         mesh_ranks=ranks, counted_here=counted, counters_here=counters,
         main_path_by_shape={f"[{r}, {d}] {dt}": n for (r, d, dt), n in
                             ln_fwd.calls.get("main_path", {}).items()},
         missing=missing)
    if counted != counters or missing:
        raise AssertionError(f"LayerNorm launches: counted {counted}, the "
                             f"kernels' counters {counters}; paths whose "
                             f"LayerNorms left the kernels: {missing}")
    return by_path


def check_layer_norm(device, main_calls):
    """The LayerNorm kernels against their plain versions, forward (y,
    mean and rstd) and backward (dx from the same statistics), in bf16 and
    fp32: timed at ``LN_TIMED`` in both dtypes and at every [rows, width,
    dtype] in ``main_calls`` (the main path's forward launches) beside the
    plain versions, PyTorch's own LayerNorm (``native_layer_norm`` and its
    backward: a yardstick the port never calls) and the bound, with a
    backward that drops a term shown to fail ``LN_TOL``; correct at
    ``LN_EDGES`` and on a strided view; the launches each call made
    counted; widths the kernel does not take refused by name."""
    import torch
    from clip_calibration_tpu_torch.ops.layer_norm import (
        _forward, layer_norm, layer_norm_bwd, layer_norm_bwd_reference,
        layer_norm_reference)
    from clip_calibration_tpu_torch.tools.profiling import (L2_FLUSH_BYTES,
                                                            time_ms)
    aten = torch.ops.aten
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device).manual_seed(7)

    def inputs(shape, dtype):
        D = shape[-1]
        # a residual stream: rows off zero, and the scale near 1
        x = (3 * torch.randn(shape, generator=gen, device=device)
             + torch.randn(shape[:-1] + (1,), generator=gen,
                           device=device)).to(dtype)
        g = torch.randn(x.shape, generator=gen, device=device).to(dtype)
        scale = 1 + 0.1 * torch.randn(D, generator=gen, device=device)
        bias = 0.1 * torch.randn(D, generator=gen, device=device)
        return x, g, scale, bias

    def compare(x, g, scale, bias):
        """(max |err| of y, mean, rstd and dx, all within tolerance and
        finite, the launches counted): the forward kernel alone and under
        autograd, the backward kernel from the plain statistics and under
        autograd from its own."""
        dname = str(x.dtype)[6:]
        f0, b0 = layer_norm.launches, layer_norm_bwd.launches
        got, kmean, krstd = _forward(x, scale, bias, 1e-5)
        y, mean, rstd = layer_norm_reference(x, scale, bias)
        dx = layer_norm_bwd(x, scale, mean, rstd, g)
        xg = x.detach().requires_grad_()
        got_dx, = torch.autograd.grad(layer_norm(xg, scale, bias), xg, g)
        torch.cuda.synchronize()
        counted = (layer_norm.launches - f0, layer_norm_bwd.launches - b0)
        want_dx = layer_norm_bwd_reference(x, scale, mean, rstd, g)
        errs, ok = {}, counted == (2, 2)
        for name, a, b in (("y", got, y), ("dx", dx, want_dx),
                           ("dx_autograd", got_dx, want_dx)):
            errs[name], within = ln_within(a, b, dname)
            ok = ok and within
        atol, rtol = LN_STATS_TOL
        for name, a, b in (("mean", kmean, mean), ("rstd", krstd, rstd)):
            diff = (a - b).abs()
            errs[name] = float(diff.max())
            ok = ok and bool(torch.isfinite(a).all()) and bool(
                (diff <= atol + rtol * b.abs()).all())
        return errs, ok, counted

    timed_cases = [(rows, D, dtype) for rows, D in LN_TIMED
                   for dtype in (torch.bfloat16, torch.float32)]
    timed_cases += [(rows, D, getattr(torch, dname))
                    for rows, D, dname in main_calls
                    if (rows, D) not in LN_TIMED]
    cases = []
    for rows, D, dtype in timed_cases:
        dname = str(dtype)[6:]
        x, g, scale, bias = inputs((rows, D), dtype)
        errs, ok, counted = compare(x, g, scale, bias)
        _, mean, rstd = layer_norm_reference(x, scale, bias)
        planted, caught = ln_within(
            ln_dropped_term(x, scale, mean, rstd, g),
            layer_norm_bwd_reference(x, scale, mean, rstd, g), dname)
        elt = x.element_size()
        fwd_bytes = 2 * rows * D * elt + 2 * D * 4 + 8 * rows
        bwd_bytes = 3 * rows * D * elt + D * 4 + 8 * rows
        w, b = scale.to(dtype), bias.to(dtype)
        _, lmean, lrstd = aten.native_layer_norm(x, [D], w, b, 1e-5)
        rec = {
            "rows": rows, "width": D, "dtype": dname,
            "main_path_launches": main_calls.get((rows, D, dname), 0),
            "launches_counted": counted,
            "max_abs_err": errs["y"], "max_abs_err_bwd": errs["dx"],
            "max_abs_err_stats": [errs["mean"], errs["rstd"]],
            "max_abs_err_bwd_autograd": errs["dx_autograd"],
            "atol_of_max": LN_TOL[dname][0], "rtol": LN_TOL[dname][1],
            "planted_term_drop": {"max_abs_err": planted,
                                  "rejected": not caught},
            "ok": ok and not caught,
            "ms": time_ms(lambda: layer_norm(x, scale, bias), flush),
            "plain_ms": time_ms(
                lambda: layer_norm_reference(x, scale, bias), flush),
            "library_ms": time_ms(
                lambda: aten.native_layer_norm(x, [D], w, b, 1e-5), flush),
            "bound_ms": fwd_bytes / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "bytes": fwd_bytes,
            "bwd": {
                "ms": time_ms(lambda: layer_norm_bwd(
                    x, scale, mean, rstd, g), flush),
                "plain_ms": time_ms(lambda: layer_norm_bwd_reference(
                    x, scale, mean, rstd, g), flush),
                "library_ms": time_ms(
                    lambda: aten.native_layer_norm_backward(
                        g, x, [D], lmean, lrstd, w, b,
                        [True, False, False]), flush),
                "bound_ms": bwd_bytes / PEAK_BYTES_PER_S * 1e3,
                "bytes": bwd_bytes},
        }
        emit("kernel layer_norm", **rec)
        if not rec["ok"]:
            raise AssertionError(
                f"layer_norm disagrees with its plain version, or its "
                f"tolerance let a dropped term through: {rec}")
        cases.append(rec)
    del flush

    errors = []
    for shape in LN_EDGES + [(3, 77, 512)]:
        for dtype in (torch.bfloat16, torch.float32):
            x, g, scale, bias = inputs(shape, dtype)
            if len(shape) == 3:  # ln_post's rows: x[:, 0] of [B, L, D]
                x, g = x[:, 0], g[:, 0]
            errs, ok, counted = compare(x, g, scale, bias)
            errors.append({"shape": list(x.shape),
                           "strided": not x.is_contiguous(),
                           "dtype": str(dtype)[6:], **errs,
                           "launches_counted": counted, "ok": ok})
    refused = []
    for D, dtype in ((12, torch.bfloat16), (2056, torch.float32),
                     (64, torch.float16)):
        x = torch.zeros((4, D), dtype=dtype, device=device)
        try:
            layer_norm(x, torch.ones(D, device=device),
                       torch.zeros(D, device=device))
            said = None
        except (ValueError, TypeError) as e:
            said = str(e)
        refused.append({"width": D, "dtype": str(dtype)[6:], "error": said,
                        "ok": said is not None and (
                            str(D) in said or "float16" in said)})
    emit("kernel layer_norm edges", cases=errors, refused=refused)
    if not all(e["ok"] for e in errors + refused):
        raise AssertionError("layer_norm disagrees with its plain version "
                             "at an edge shape, or ran a width or dtype it "
                             "does not take")
    return cases


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


def fp32_hmma(library: str) -> dict:
    """fp32 kernel instance -> its tensor-core products (``HMMA``) in the
    library's SASS, by ``cuobjdump -sass`` beside nvcc; every fp32 instance
    must have none (full fp32 FMAs, no TF32)."""
    import subprocess
    from clip_calibration_tpu_torch.ops import build
    from clip_calibration_tpu_torch.ops.build import _kernel_name
    cuobjdump = osp.join(osp.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", library], check=True,
                          capture_output=True, text=True).stdout
    out = {}
    for func in sass.split("Function : ")[1:]:
        name = _kernel_name(func.split(None, 1)[0])
        if "_f32<" in name:
            out[name] = len(re.findall(r"\bHMMA\b", func))
    return out


def main() -> int:
    import torch
    if len(sys.argv) >= 5 and sys.argv[1] in ("--mesh-worker",
                                              "--serve-worker"):
        # one rank of mesh_path (b) or (c), started by run_mesh_path
        if not torch.cuda.is_available():
            return 2
        sys.path.insert(0, ROOT)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        rank, port, out = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
        if sys.argv[1] == "--mesh-worker":
            mesh_worker(rank, port, out)
        else:
            serve_worker(rank, port, out, sys.argv[5:])
        return 0
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
    from clip_calibration_tpu_torch.ops import layer_norm as ln_ops
    from clip_calibration_tpu_torch.ops import mha_qkv as kernels
    seconds = build.build()
    ptxas = {name: build.ptxas_report(name) for name in build.SOURCES
             if osp.exists(build.log_path(name))}
    hmma = {name: fp32_hmma(build.library_path(name))
            for name in ("mha_qkv_fwd", "mha_qkv_bwd")}
    emit("build", seconds=seconds, kernels=sorted(build.SOURCES),
         ptxas=ptxas, fp32_sass_hmma=hmma)
    # no fp32 attention instance and no instance of K2, K3 or LayerNorm
    # may spill
    spilled = [fn for name, report in ptxas.items()
               for fn, r in report.items() if r["spill_bytes"] and (
                   "_f32<" in fn or name in ("mha_qkv_bwd", "int8_matmul",
                                             "layer_norm"))]
    if spilled or not all(counts and not any(counts.values())
                          for counts in hmma.values()) or not all(
            any("_f32<" in fn for fn in ptxas.get(n, {})) for n in hmma):
        raise AssertionError(f"kernel instances: spilled {spilled}, fp32 "
                             f"HMMA {hmma}, ptxas {sorted(ptxas)}")

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
    k3 = ShapeRecorder(int8_ops.kernel_product)
    # the LayerNorm launchers, counted by path from 0
    ln_fwd = LayerNormRecorder(ln_ops._forward, ln_ops.layer_norm)
    ln_bwd = LayerNormRecorder(ln_ops.layer_norm_bwd, ln_ops.layer_norm_bwd)
    ln_ops.layer_norm.launches = ln_ops.layer_norm_bwd.launches = 0
    old_cwd = os.getcwd()
    os.chdir(WORK)  # the ./temp feature caches are cwd-relative
    attention.mha_qkv, kernels.mha_qkv_bwd, int8_ops.kernel_product = \
        k1, k2, k3
    ln_ops._forward, ln_ops.layer_norm_bwd = ln_fwd, ln_bwd

    def on(path, run, *args):
        ln_fwd.path = ln_bwd.path = path
        return run(*args)

    try:
        k1_main = on("main_path", run_main_path, k1)
        k1_train, k2_train = on("train_path", run_train_path, k1, k2)
        k1_fp32, k2_fp32 = on("fp32_path", run_fp32_path, k1, k2)
        prompt = on("prompt_path", run_prompt_path, k1, k2)
        fanout = on("fanout_path", run_fanout_path, k1, k2, k3)
        k1_serve, k3_serve = on("serve_path", run_serve_path, k1, k3)
        k4_probe, probe_rows = on("probe_path", run_probe_path)
        mesh = on("mesh_path", run_mesh_path, k1, k2, k3)
    finally:
        attention.mha_qkv, kernels.mha_qkv_bwd, int8_ops.kernel_product = \
            k1.fn, k2.fn, k3.fn
        ln_ops._forward, ln_ops.layer_norm_bwd = ln_fwd.fn, ln_bwd.fn
        os.chdir(old_cwd)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    ln_by_path = check_layer_norm_paths(ln_fwd, ln_bwd, mesh)

    seconds = {}

    def timed(check, *args):
        t0 = time.perf_counter()
        out = check(*args)
        seconds[check.__name__] = time.perf_counter() - t0
        return out

    cases_fwd = timed(check_kernels, device, k1.calls)
    # K1 at mesh_path's shapes: the TP vision tower's local heads and the
    # class-sharded text fan-outs
    for shape, heads in (([32, 208, 1152], 6), ([25, 16, 1536], 8),
                         ([132, 32, 1536], 8)):
        if not any(c["qkv"] == shape and c["heads"] == heads
                   and c["main_path_launches"] for c in cases_fwd):
            raise AssertionError(f"mha_qkv_fwd not checked at mesh_path's "
                                 f"{shape}, {heads} heads")
    cases_bwd = timed(check_kernels_bwd, device, k2.calls)
    cases_int8 = timed(check_int8_matmul, device, k3.calls)
    # K3 at mesh_path's TP shapes: each rank's wqkv, wo, w_fc and w_proj
    # products over 64 images (its columns of wqkv and w_fc, rows of wo
    # and w_proj)
    for mkn in ([64 * 208, 768, 1152], [64 * 208, 384, 768],
                [64 * 208, 768, 1536], [64 * 208, 1536, 768]):
        if not any(c["mkn"] == mkn and c["main_path_launches"]
                   for c in cases_int8):
            raise AssertionError(f"int8_matmul not checked at mesh_path's "
                                 f"TP shape {mkn}")
    cases_k4 = timed(check_int8_attention, device,
                     {r["variant"]: r["launches"] for r in probe_rows})
    cases_ln = timed(check_layer_norm, device,
                     ln_fwd.calls.get("main_path", {}))
    timed(check_towers, device)
    timed(check_train_step, device)
    timed(check_prompt_step, device)
    timed(check_fanout_step, device)
    timed(check_serve_tower, device)
    emit("check_seconds", **seconds)

    def of(cases, dtype):
        return [c for c in cases if c["dtype"] == dtype]

    print(json.dumps({"kernels": [
        _kernel_entry(
            "mha_qkv_fwd", "clip_calibration_tpu_torch/csrc/mha_qkv_fwd.cu",
            "clip_calibration_tpu/ops/pallas_attention.py:36",
            k1_main + k1_train + prompt["mha_qkv_fwd"]
            + fanout["mha_qkv_fwd"] + k1_serve + mesh["mha_qkv_fwd"],
            of(cases_fwd, "bfloat16"), dtype="bfloat16",
            launches_by_path={"main_path": k1_main, "train_path": k1_train,
                              "fp32_path": 0,
                              "prompt_path": prompt["mha_qkv_fwd"],
                              "fanout_path": fanout["mha_qkv_fwd"],
                              "serve_path": k1_serve, "probe_path": 0,
                              "mesh_path": mesh["mha_qkv_fwd"]}),
        _kernel_entry(
            "mha_qkv_fwd_f32",
            "clip_calibration_tpu_torch/csrc/mha_qkv_fwd.cu",
            "clip_calibration_tpu/ops/pallas_attention.py:36",
            k1_fp32 + prompt["mha_qkv_fwd_f32"] + fanout["mha_qkv_fwd_f32"]
            + mesh["mha_qkv_fwd_f32"],
            of(cases_fwd, "float32"), dtype="float32",
            launches_by_path={"main_path": 0, "train_path": 0,
                              "fp32_path": k1_fp32,
                              "prompt_path": prompt["mha_qkv_fwd_f32"],
                              "fanout_path": fanout["mha_qkv_fwd_f32"],
                              "serve_path": 0, "probe_path": 0,
                              "mesh_path": mesh["mha_qkv_fwd_f32"]}),
        _kernel_entry(
            "mha_qkv_bwd", "clip_calibration_tpu_torch/csrc/mha_qkv_bwd.cu",
            "clip_calibration_tpu/ops/pallas_attention.py:94",
            k2_train + prompt["mha_qkv_bwd"] + fanout["mha_qkv_bwd"]
            + mesh["mha_qkv_bwd"],
            of(cases_bwd, "bfloat16"), dtype="bfloat16",
            launches_by_path={"main_path": 0, "train_path": k2_train,
                              "fp32_path": 0,
                              "prompt_path": prompt["mha_qkv_bwd"],
                              "fanout_path": fanout["mha_qkv_bwd"],
                              "serve_path": 0, "probe_path": 0,
                              "mesh_path": mesh["mha_qkv_bwd"]}),
        _kernel_entry(
            "mha_qkv_bwd_f32",
            "clip_calibration_tpu_torch/csrc/mha_qkv_bwd.cu",
            "clip_calibration_tpu/ops/pallas_attention.py:94",
            k2_fp32 + prompt["mha_qkv_bwd_f32"] + fanout["mha_qkv_bwd_f32"]
            + mesh["mha_qkv_bwd_f32"],
            of(cases_bwd, "float32"), dtype="float32",
            launches_by_path={"main_path": 0, "train_path": 0,
                              "fp32_path": k2_fp32,
                              "prompt_path": prompt["mha_qkv_bwd_f32"],
                              "fanout_path": fanout["mha_qkv_bwd_f32"],
                              "serve_path": 0, "probe_path": 0,
                              "mesh_path": mesh["mha_qkv_bwd_f32"]}),
        _kernel_entry(
            "int8_matmul", "clip_calibration_tpu_torch/csrc/int8_matmul.cu",
            "clip_calibration_tpu/ops/pallas_int8_matmul.py:35",
            k3_serve + fanout["int8_matmul"] + mesh["int8_matmul"],
            cases_int8,
            launches_by_path={"main_path": 0, "train_path": 0,
                              "fp32_path": 0, "prompt_path": 0,
                              "fanout_path": fanout["int8_matmul"],
                              "serve_path": k3_serve, "probe_path": 0,
                              "mesh_path": mesh["int8_matmul"]}),
        _kernel_entry(
            "int8_attention",
            "clip_calibration_tpu_torch/csrc/int8_attention.cu",
            "benchmarks/probe_int8_attention.py:69", k4_probe, cases_k4,
            launches_by_path={"main_path": 0, "train_path": 0,
                              "fp32_path": 0, "prompt_path": 0,
                              "fanout_path": 0, "serve_path": 0,
                              "probe_path": k4_probe, "mesh_path": 0},
            variants={c["variant"]: {k: c[k] for k in (
                "main_path_launches", "max_abs_err", "ms", "plain_ms",
                "library_ms", "bound_ms", "bound_by")}
                for c in cases_k4 if c["main_path_launches"]}),
        _kernel_entry(
            "layer_norm", "clip_calibration_tpu_torch/csrc/layer_norm.cu",
            "none (XLA fuses the JAX package's LayerNorm)",
            sum(sum(by.values()) for by in ln_by_path.values()),
            of(cases_ln, "bfloat16"), dtype="bfloat16",
            launches_by_path={p: sum(by.values())
                              for p, by in ln_by_path.items()},
            launches_by_kernel={k: sum(by[k] for by in ln_by_path.values())
                                for k in LN_KERNELS},
            fp32_cases=of(cases_ln, "float32")),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
