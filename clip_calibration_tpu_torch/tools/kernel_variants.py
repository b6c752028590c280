"""Times variants of an attention kernel's source on the card, side by
side with the unchanged source.

    python -m clip_calibration_tpu_torch.tools.kernel_variants TARGET \\
        [VARIANTS.json]

TARGET is ``mha_qkv_fwd.cu`` (K1, bf16), ``mha_qkv_fwd.cu:fp32`` (K1,
fp32), ``mha_qkv_bwd.cu:fp32`` (K2, fp32) or ``int8_attention.cu`` (K4);
VARIANTS.json maps a variant's name to a list of [old, new] text
replacements (default: ``RECORDED``, the variants PERF.md reports).
Each variant is a copy of the target's source under ``csrc/`` (with the
shared headers) where each ``old`` (which must occur) is replaced by
``new``, built with ``ops/build.py``'s nvcc flags under
``build/kernel_variants/``, held to the plain version and timed with
``tools/profiling.py::time_ms`` at the kernel's main shapes (K1 and K2:
the ViT-B/16 vision shapes at batch 1, 8, 32 (and 64 for bf16 K1) and the
CoOp text shape; K4: every variant at the probe's shape and at batch 8).
Prints one JSON line per shape: for each build its ms and its max
|kernel - plain| (K4: as a multiple of ``k4_tolerance``). Needs a card.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import os.path as osp
import shutil
import subprocess
import sys

import torch

from ..ops import build
from .profiling import L2_FLUSH_BYTES, nvidia_smi, time_ms

OUT_DIR = osp.join(osp.dirname(build.BUILD_DIR), "kernel_variants")
_ARGTYPES = {
    "mha_qkv_fwd": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    "mha_qkv_bwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    "int8_attention": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
}


def _emit(**fields):
    print(json.dumps(fields), flush=True)


# what each variant takes away or changes, to show what bounds the kernel
_FULL_STEP = "      if (nk == {bk})\n        step(std::true_type{{}});\n" \
    "      else\n        step(std::false_type{{}});"
RECORDED = {
    "mha_qkv_fwd.cu": {
        # compute alone (only the first tile is ever copied)
        "no_loads": [["    if (i + STAGES - 1 < total) issue(i + "
                      "STAGES - 1);", ""]],
        # the copies alone
        "no_compute": [["    if (active) {\n      if (k0 == 0) {",
                        "    if (active && L < 0) {\n"
                        "      if (k0 == 0) {"]],
        # every tile through the guarded (ragged-tile) step
        "guarded_steps": [[_FULL_STEP.format(bk="MBK"),
                           "      step(std::false_type{});"]],
        "streamed_mask": [["constexpr int MASK_SMEM_MAX = 60 * 1024;",
                           "constexpr int MASK_SMEM_MAX = 0;"]],
        "one_head_a_block": [["constexpr int FILL_BLOCKS = 4 * SMS;",
                              "constexpr int FILL_BLOCKS = 1 << 30;"]],
    },
    "mha_qkv_fwd.cu:fp32": {
        "no_loads": [["    if (i + 1 < ntiles) issue(i + 1);  // into tile "
                      "i - 1's stage", ""]],
        "no_compute": [["    if (!active) continue;",
                        "    if (!active || L > 0) continue;"]],
        # blocks padded by at most 10% of L (ViT-B/16: 32 rows, 224 for
        # 208), as the dq and dk/dv kernels choose them
        "rows_pad_10": [["switch (f32_fill_rows(64, L,",
                         "switch (f32_fill_rows(f32_pad_rows(L, 10), L,"]],
        # the mask values (read straight from L2) replaced by zeros
        "no_mask": [["      mk[r][j] = row < L && col < L ? __ldg(mask + at) "
                     ": 0.f;", "      mk[r][j] = 0.f;"]],
    },
    "mha_qkv_bwd.cu:fp32": {
        "no_loads": [["    if (i + 1 < walk) issue(i + 1);", ""],
                     ["    if (i + 1 < ntiles) issue(i + 1);", ""]],
        "no_compute": [["    if (!active) continue;",
                        "    if (!active || L > 0) continue;"]],
        # 64-row blocks whatever their padding (ViT-B/16: 256 rows for 208)
        "rows_64": [["constexpr int F32_WASTE_PCT = 10;",
                     "constexpr int F32_WASTE_PCT = 1000;"]],
        # one of the two kernels alone (the other's launch removed)
        "dq_only": [["  dkdv<<<grid, F::THREADS, F::SMEM_DKDV, stream>>>",
                     "  if (L < 0) dkdv<<<grid, F::THREADS, F::SMEM_DKDV, "
                     "stream>>>"]],
        "dkdv_only": [["  dq<<<grid, F::THREADS, F::SMEM_DQ, stream>>>",
                       "  if (L < 0) dq<<<grid, F::THREADS, F::SMEM_DQ, "
                       "stream>>>"]],
        "no_mask": [["      mk[r][j] = row < L && col < L ? __ldg(mask + at) "
                     ": 0.f;", "      mk[r][j] = 0.f;"]],
    },
    "int8_attention.cu": {
        "no_loads": [["    if (i + STAGES - 1 < total) issue(i + "
                      "STAGES - 1);", ""]],
        "no_compute": [["    if (active) {\n      const float* mrow",
                        "    if (active && L < 0) {\n"
                        "      const float* mrow"]],
        # the int8 copies of k and v made for the first head only
        "no_prologue": [["      prologue(base + (h0 + hh) * HD);",
                         "      if (hh == 0) prologue(base + (h0 + hh) "
                         "* HD);"]],
        "guarded_steps": [[_FULL_STEP.format(bk="BK"),
                           "      step(std::false_type{});"]],
        "streamed_mask": [["if (whole <= MAX_SMEM && (hg > 1 || smem > "
                           "MAX_SMEM))", "if (whole <= MAX_SMEM && smem > "
                           "MAX_SMEM)"]],
        "eight_warps": [["constexpr int MAX_WARPS = 13;",
                         "constexpr int MAX_WARPS = 8;"]],
    },
}


def source_file(target: str) -> str:
    """The file under csrc/ of a target (``mha_qkv_fwd.cu:fp32`` ->
    ``mha_qkv_fwd.cu``)."""
    return target.split(":")[0]


def apply_variants(target: str, variants: dict) -> dict:
    """name -> {file name: text}: the target's source and the shared
    headers (``csrc/*.cuh``) with the variant's replacements; the
    unchanged files are "source". Each ``old`` is replaced in every file
    that holds it; raises if none does."""
    files = [source_file(target)] + sorted(
        f for f in os.listdir(build.CSRC_DIR) if f.endswith(".cuh"))
    texts = {f: open(osp.join(build.CSRC_DIR, f)).read() for f in files}
    out = {"source": texts}
    for name, edits in variants.items():
        variant = dict(texts)
        for old, new in edits:
            hits = [f for f, t in variant.items() if old in t]
            if not hits:
                raise ValueError(f"{name}: {old!r} is not in {files}")
            for f in hits:
                variant[f] = variant[f].replace(old, new)
        out[name] = variant
    return out


def compile_variants(target: str, variants: dict) -> dict:
    """name -> ctypes library, one nvcc each, all started together."""
    source = source_file(target)
    procs = {}
    for name, files in apply_variants(target, variants).items():
        d = osp.join(OUT_DIR, name)
        os.makedirs(d, exist_ok=True)
        for f, text in files.items():
            open(osp.join(d, f), "w").write(text)
        lib = osp.join(d, "lib.so")
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib,
             osp.join(d, source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        _emit(built=name, ptxas=[ln.strip() for ln in log.splitlines()
                                 if "registers" in ln or "spill" in ln])
        libs[name] = ctypes.CDLL(lib)
        getattr(libs[name], source[:-3]).argtypes = _ARGTYPES[source[:-3]]
    return libs


def _time_all(libs, fn_name, args, out, want, tol, flush):
    """{name: [ms, max |out - want| / tol]} over the builds."""
    row = {}
    stream = torch.cuda.current_stream().cuda_stream
    for name, lib in libs.items():
        fn = getattr(lib, fn_name)

        def call():
            err = fn(*args(out), stream)
            if err != 0:
                raise RuntimeError(f"{name}: cudaError_t {err}")
        call()
        torch.cuda.synchronize()
        err = float(((out.float() - want).abs() / tol).max())
        row[name] = [time_ms(call, flush), err]
    return row


def _attention_cases(dev, gen, dtype, shapes):
    """(B, L, D, H, qkv, mask) at each (B, L, D, H, real, causal): the
    towers' masks (causal and/or keys from ``real`` masked, padded rows
    pinned to key 0)."""
    neg = torch.finfo(torch.float32).min
    for B, L, D, H, real, causal in shapes:
        mask = torch.zeros((L, L), dtype=torch.float32, device=dev)
        if causal:
            mask = torch.triu(torch.full((L, L), neg, device=dev), 1)
        mask[:, real:] = neg
        mask[real:, :] = neg
        mask[real:, 0] = 0.0
        qkv = torch.randn((B, L, 3 * D), generator=gen, device=dev,
                          dtype=torch.float32).to(dtype)
        yield B, L, D, H, qkv, mask


VISION_TEXT = [(32, 208, 768, 12, 197, False), (1, 208, 768, 12, 197, False),
               (8, 208, 768, 12, 197, False), (50, 32, 512, 8, 25, True)]


def run(target: str, variants: dict) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_variants times kernels on a card")
    from ..ops.int8_attention import VARIANTS, int8_attention_reference
    from ..ops.mha_qkv import mha_qkv_bwd_reference, mha_qkv_reference
    from ..probe_int8_attention import probe_inputs
    _emit(device=nvidia_smi())
    libs = compile_variants(target, variants)
    dev = torch.device("cuda", 0)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    if target in ("mha_qkv_fwd.cu", "mha_qkv_fwd.cu:fp32"):
        fp32 = target.endswith(":fp32")
        shapes = VISION_TEXT if fp32 else VISION_TEXT[:1] + [
            (64, 208, 768, 12, 197, False)] + VISION_TEXT[1:]
        dtype = torch.float32 if fp32 else torch.bfloat16
        for B, L, D, H, qkv, mask in _attention_cases(dev, gen, dtype,
                                                      shapes):
            out = torch.empty((B, L, D), dtype=qkv.dtype, device=dev)
            want = mha_qkv_reference(qkv, mask, H).float()
            _emit(kernel="mha_qkv_fwd", dtype=str(dtype)[6:],
                  qkv=[B, L, 3 * D], heads=H,
                  **_time_all(libs, "mha_qkv_fwd", lambda o: (
                      qkv.data_ptr(), mask.data_ptr(), o.data_ptr(), B, L, D,
                      H, int(not fp32)), out, want, 1.0, flush))
    elif target == "mha_qkv_bwd.cu:fp32":
        for B, L, D, H, qkv, mask in _attention_cases(
                dev, gen, torch.float32, VISION_TEXT):
            g = torch.randn((B, L, D), generator=gen, device=dev)
            out = torch.empty_like(qkv)
            stats = torch.empty((3, B, H, L), device=dev)
            want = mha_qkv_bwd_reference(qkv, mask, g, H)
            _emit(kernel="mha_qkv_bwd", dtype="float32", qkv=[B, L, 3 * D],
                  heads=H, **_time_all(libs, "mha_qkv_bwd", lambda o: (
                      qkv.data_ptr(), mask.data_ptr(), g.data_ptr(),
                      o.data_ptr(), stats.data_ptr(), B, L, D, H, 0), out,
                      want, 1.0, flush))
    elif target == "int8_attention.cu":
        for B, L, D, H in [(256, 208, 768, 12), (8, 208, 768, 12)]:
            qkv, mask = probe_inputs(B, L, D, dev)
            out = torch.empty((B, L, D), dtype=qkv.dtype, device=dev)
            for vi, variant in enumerate(VARIANTS):
                want = int8_attention_reference(qkv, mask, H,
                                                variant).float()
                if variant == "int8_qk_pv":  # 2 sv of the column
                    tol = 2 * qkv[..., 2 * D:].float().abs().amax(
                        dim=1, keepdim=True) / 127
                else:  # 2 bf16 ulps of max |plain|
                    top = float(want.abs().max())
                    tol = 2 * 2.0 ** (math.floor(math.log2(top)) - 7)
                _emit(kernel="int8_attention", qkv=[B, L, 3 * D], heads=H,
                      variant=variant, **_time_all(
                          libs, "int8_attention", lambda o, vi=vi: (
                              qkv.data_ptr(), mask.data_ptr(), o.data_ptr(),
                              B, L, D, H, vi), out, want, tol, flush))
    else:
        raise ValueError(f"no shapes for {target}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (1, 2) or argv[0] not in RECORDED:
        print(__doc__, file=sys.stderr)
        return 2
    run(argv[0], json.load(open(argv[1])) if len(argv) == 2
        else RECORDED[argv[0]])
    return 0


if __name__ == "__main__":
    sys.exit(main())
