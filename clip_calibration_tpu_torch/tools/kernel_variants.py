"""Times variants of a kernel's source on the card, side by side with
the unchanged source.

    python -m clip_calibration_tpu_torch.tools.kernel_variants TARGET \\
        [VARIANTS.json] [--csrc DIR] [--against DIR]

TARGET is ``mha_qkv_fwd.cu`` (K1, bf16), ``mha_qkv_fwd.cu:fp32`` (K1,
fp32), ``mha_qkv_bwd.cu`` (K2, bf16), ``mha_qkv_bwd.cu:fp32`` (K2,
fp32), ``int8_matmul.cu`` (K3) or ``int8_attention.cu`` (K4).
VARIANTS.json maps a variant's
name to a list of [old, new] text replacements (default: ``RECORDED``,
the variants PERF.md reports). Each variant is a copy of the target's
source under ``csrc/`` (or ``--csrc DIR``), with the shared headers,
where each ``old`` (which must occur) is replaced by ``new``, built with
``ops/build.py``'s nvcc flags under ``build/kernel_variants/``, held to
the plain version and timed with ``tools/profiling.py::time_ms`` at the
kernel's main shapes (K1 and K2: the ViT-B/16 vision shapes at batch 1,
8, 32 (and 64 for bf16 K1) and the CoOp text shape (and L 16 for bf16
K2); K3: the serve path's main products, int32 and rescaled; K4: every
variant at the probe's shape and at batch 8). ``--against DIR`` adds the
unchanged source of another tree (a checkout of the parent commit) as
one more build, named ``against``. Prints one JSON line per shape: for
each build its ms and its max |kernel - plain| (K4: as a multiple of
``k4_tolerance``). Needs a card.
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


def argtypes(target: str) -> dict:
    """The C entry points of a target's library, from the ``ARGTYPES``
    table of the kernel's module (``ops/build.py::load``)."""
    from ..ops import int8_attention, int8_matmul, layer_norm, mha_qkv
    tables = {**mha_qkv.ARGTYPES, **int8_matmul.ARGTYPES,
              **int8_attention.ARGTYPES, **layer_norm.ARGTYPES}
    return tables[source_file(target)[:-3]]


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
    "mha_qkv_bwd.cu": {
        # route (b): only the first streamed tile is copied
        "no_loads": [["    if (i + 1 < total) issue(i + 1);  // into tile "
                      "i - 1's stage", ""],
                     ["    if (i + 1 < n) issue(i + 1);", ""]],
        # the copies alone (route (a): the block returns after them)
        "no_compute": [["    if (!active) continue;",
                        "    if (!active || L > 0) continue;"],
                       ["  __syncthreads();\n\n  __nv_bfloat16* ks = qs + "
                        "F::TILE;", "  __syncthreads();\n  if (L > 0) return;"
                        "\n  __nv_bfloat16* ks = qs + F::TILE;"]],
        # no mask copies (the tiles keep what shared memory held)
        "no_mask": [["  load_mask(ms, F::MLD, mask, L, 0, F::LP, 0, F::LP, "
                     "F::THREADS);", ""],
                    ["    load_mask(reinterpret_cast<float*>(kt + 2 * "
                     "T::STREAM), MS, mask, L, q0,\n              T::ROWS, "
                     "k0, KT, THREADS);", ""],
                    ["    load_mask(mt, T::MT, mask, L, q0, KT, k_blk, "
                     "T::ROWS, THREADS);", ""]],
        # route (b) at every L (the text shapes too)
        "tiled_only": [["constexpr int FUSED_MAX_L = 64;",
                        "constexpr int FUSED_MAX_L = 0;"]],
        # expf (the accurate exponential) for __expf
        "expf": [["__expf(", "expf("]],
        # one of route (b)'s two kernels alone (the other's launch removed)
        "dq_only": [["  dkdv<<<grid, NW * 32, T::SMEM_DKDV, stream>>>",
                     "  if (L < 0) dkdv<<<grid, NW * 32, T::SMEM_DKDV, "
                     "stream>>>"]],
        "dkdv_only": [["  dq<<<grid, NW * 32, T::SMEM_DQ, stream>>>",
                       "  if (L < 0) dq<<<grid, NW * 32, T::SMEM_DQ, "
                       "stream>>>"]],
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
    "int8_matmul.cu": {
        # only the ring's first STAGES - 1 k tiles are copied
        "no_loads": [["    if (i + STAGES - 1 < nk) issue(i + STAGES - 1);"
                      "  // into i - 1's stage", ""]],
        # no wgmma (a runtime condition that never holds keeps the code)
        "no_compute": [["      wgmma_n128(acc, da + 2 * kk, db + 2 * kk, 1);",
                        "      if (K < 0) wgmma_n128(acc, da + 2 * kk, db + "
                        "2 * kk, 1);"]],
        # the staged tile never leaves (split K still adds it)
        "no_store": [["      if (row >= M) break;",
                      "      if (row >= M || N > 0) break;"]],
        # plain stores for the streaming (evict-first) ones
        "plain_stores": [["__stcs(reinterpret_cast<int4*>(o), v);",
                          "*reinterpret_cast<int4*>(o) = v;"],
                         ["__stcs(reinterpret_cast<uint2*>(o),",
                          "(*reinterpret_cast<uint2*>(o)) = ("]],
        # a fourth ring stage (one block an SM)
        "stages_4": [["constexpr int STAGES = 3;",
                      "constexpr int STAGES = 4;"]],
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


def _sources(target: str, csrc: str) -> dict:
    """{file name: text}: the target's source and the shared headers
    (``*.cuh``) of the tree ``csrc``."""
    files = [source_file(target)] + sorted(
        f for f in os.listdir(csrc) if f.endswith(".cuh"))
    return {f: open(osp.join(csrc, f)).read() for f in files}


def apply_variants(target: str, variants: dict, csrc: str = None,
                   against: str = None) -> dict:
    """name -> {file name: text}: the target's source and the shared
    headers (``csrc/*.cuh``, or those of ``csrc``) with the variant's
    replacements; the unchanged files are "source", and ``against``'s
    unchanged files "against". Each ``old`` is replaced in every file
    that holds it; raises if none does."""
    texts = _sources(target, csrc or build.CSRC_DIR)
    files = sorted(texts)
    out = {"source": texts}
    if against:
        out["against"] = _sources(target, against)
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


def compile_variants(target: str, variants: dict, csrc: str = None,
                     against: str = None) -> dict:
    """name -> ctypes library, one nvcc each, all started together."""
    source = source_file(target)
    procs = {}
    for name, files in apply_variants(target, variants, csrc,
                                      against).items():
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
        libs[name] = build.bind(ctypes.CDLL(lib), argtypes(target))
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


# K3's main products on the serve path (M, K, N): the 32-row bucket's w_fc
# (the most bytes of the 120-launch ties), the batch-64 wqkv, the 1-row
# bucket's w_proj (split K) and the batch-1 projection
K3_SHAPES = [(6656, 768, 3072), (13312, 768, 2304), (208, 3072, 768),
             (1, 768, 512)]


def _run_k3(libs, dev, gen, flush):
    """Each build's int32 and bf16 rescaled products (through
    ``ops/int8_matmul.py``'s launch) at ``K3_SHAPES``."""
    from ..ops.int8_matmul import int8_matmul_reference, launch
    for M, K, N in K3_SHAPES:
        x = torch.randint(-127, 128, (M, K), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int8)
        w = torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int8)
        wt = w.t().contiguous()
        xs = torch.rand((M, 1), generator=gen, device=dev) + 0.5
        ws = torch.rand((N,), generator=gen, device=dev) * 1e-3
        want = int8_matmul_reference(x, w)
        want_r = (want.float() * xs * ws).to(torch.bfloat16)
        rows = {"int32": {}, "rescaled_bf16": {}}
        for name, lib in libs.items():
            calls = (lambda: launch(lib, x, wt),
                     lambda: launch(lib, x, wt, xs, ws, torch.bfloat16))
            for route, call, ref in zip(rows, calls, (want, want_r)):
                try:
                    got = call()
                    torch.cuda.synchronize()
                    err = float((got.float() - ref.float()).abs().max())
                    rows[route][name] = [time_ms(call, flush), err]
                except RuntimeError as e:  # the context is lost: say where
                    raise RuntimeError(f"{name}, {route}, "
                                       f"{[M, K, N]}") from e
        for route, row in rows.items():
            _emit(kernel="int8_matmul", route=route, mkn=[M, K, N], **row)


def run(target: str, variants: dict, csrc: str = None,
        against: str = None) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_variants times kernels on a card")
    from ..ops.int8_attention import VARIANTS, int8_attention_reference
    from ..ops.mha_qkv import mha_qkv_bwd_reference, mha_qkv_reference
    from ..probe_int8_attention import probe_inputs
    _emit(device=nvidia_smi())
    libs = compile_variants(target, variants, csrc, against)
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
    elif target == "mha_qkv_bwd.cu":
        # bf16: the error as a multiple of chip_smoke.py's TOL_BWD
        for B, L, D, H, qkv, mask in _attention_cases(
                dev, gen, torch.bfloat16,
                VISION_TEXT + [(50, 16, 512, 8, 14, True)]):
            g = torch.randn((B, L, D), generator=gen, device=dev).to(qkv.dtype)
            out = torch.empty_like(qkv)
            stats = torch.empty((3, B, H, L), device=dev)
            want = mha_qkv_bwd_reference(qkv, mask, g, H).float()
            _emit(kernel="mha_qkv_bwd", dtype="bfloat16", qkv=[B, L, 3 * D],
                  heads=H, **_time_all(libs, "mha_qkv_bwd", lambda o: (
                      qkv.data_ptr(), mask.data_ptr(), g.data_ptr(),
                      o.data_ptr(), stats.data_ptr(), B, L, D, H, 1), out,
                      want, 2e-2 + 2e-2 * want.abs(), flush))
    elif target == "int8_matmul.cu":
        _run_k3(libs, dev, gen, flush)
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
    argv = list(sys.argv[1:] if argv is None else argv)
    dirs = {}
    for flag in ("--csrc", "--against"):
        if flag in argv:
            i = argv.index(flag)
            dirs[flag[2:]] = argv[i + 1] if i + 1 < len(argv) else None
            del argv[i:i + 2]
    if (len(argv) not in (1, 2) or argv[0] not in RECORDED
            or None in dirs.values()):
        print(__doc__, file=sys.stderr)
        return 2
    run(argv[0], json.load(open(argv[1])) if len(argv) == 2
        else RECORDED[argv[0]], **dirs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
