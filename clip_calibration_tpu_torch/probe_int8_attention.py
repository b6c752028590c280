"""K4's path: the int8 attention probe.

    python -m clip_calibration_tpu_torch.probe_int8_attention [B L D H] \
        [--device cuda|cpu]

Counterpart of ``benchmarks/probe_int8_attention.py``: attention over a
seeded bf16 qkv ([B, L, 3D], standard normal x 0.5) with a pad mask on the
keys from 197 on (the padded ViT-B/16 vision tower's), in the three
variants of ``ops/int8_attention.py`` (fp32 scores; int8 QK^T; int8 QK^T
and PV). Prints one JSON line per variant: the max and mean |out - the
fp32_scores out| (bf16 outputs), the time of one call and the attention
math's rate (4 B H L^2 d operations per call), and the K4 launches it made.
Defaults: the batch-256 ViT-B/16 serving attention (B 256, L 208, D 768,
H 12).

On the card each call is timed by ``tools/profiling.py::time_ms`` (CUDA
events around one call with cold inputs, median of 25) and every row
carries the card's name and power limit; on the CPU (``--device cpu``,
the plain version) by the host clock, median of 3. A variant that fails
raises.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from clip_calibration_tpu_torch.ops.int8_attention import (VARIANTS,
                                                           int8_attention)
from clip_calibration_tpu_torch.tools.device import resolve_device

DEFAULT_SHAPE = (256, 208, 768, 12)
PAD_FROM = 197  # keys from here on are masked, as in the padded tower


def probe_inputs(B: int, L: int, D: int, device, seed: int = 0):
    """The probe's seeded bf16 qkv and its pad mask."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((B, L, 3 * D), generator=gen, device=device,
                      dtype=torch.float32).to(torch.bfloat16) * 0.5
    mask = torch.zeros((L, L), dtype=torch.float32, device=device)
    mask[:, PAD_FROM:] = torch.finfo(torch.float32).min
    return qkv, mask


def _host_ms(fn, repeats: int = 3) -> float:
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run(B: int, L: int, D: int, H: int, device) -> list:
    """The probe's rows, one per variant (see the module docstring)."""
    device = resolve_device(device)
    qkv, mask = probe_inputs(B, L, D, device)
    on_card = device.type == "cuda"
    if on_card:
        from clip_calibration_tpu_torch.tools.profiling import (
            L2_FLUSH_BYTES, nvidia_smi, time_ms)
        card = nvidia_smi()
        flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    ops = 4.0 * B * H * L * L * (D // H)
    rows, ref = [], None
    for variant in VARIANTS:
        launches0 = int8_attention.launches
        out = int8_attention(qkv, mask, H, variant).float()
        row = {"variant": variant, "shape": [B, L, D, H],
               "device": str(device)}
        if ref is None:
            ref = out
        else:
            diff = (out - ref).abs()
            row["max_abs_diff_vs_fp32"] = float(diff.max())
            row["mean_abs_diff_vs_fp32"] = float(diff.mean())
        call = lambda: int8_attention(qkv, mask, H, variant)  # noqa: E731
        ms = time_ms(call, flush) if on_card else _host_ms(call)
        row["ms_per_call"] = ms
        row["tera_ops_per_s"] = ops / (ms * 1e-3) / 1e12
        row["launches"] = int8_attention.launches - launches0
        if on_card:
            row["card"] = card
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="int8 attention probe (K4) on the card")
    parser.add_argument("shape", nargs="*", type=int,
                        help="B L D H (default: 256 208 768 12)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    if args.shape and len(args.shape) != 4:
        parser.error("give all four of B L D H, or none")
    B, L, D, H = args.shape or DEFAULT_SHAPE
    run(B, L, D, H, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
