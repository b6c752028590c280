"""The benchmark of the PyTorch and CUDA port: one run of one cell.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout. The cell's entry in
``BENCHMARK.json`` names its configuration (``configs/<config>.json``),
its traffic (``traffic/<traffic>.json``, whose ``driver`` names the
program entry the window drives: ``drivers/<driver>.py``) and its
metrics; ``limits/<cell>.json`` holds the limits of the numbers that
decide ``correct``, and ``metrics/<metric>.py`` the reader of each
per-layer metric. A later cell, mix or metric is new files and entries.

A run: set-up (the port imported, kernels loaded or built, weights made
from the seed on the device, the cell's shapes warmed, the first steps
checked), then ``--seconds`` of measured window, then, with the window
closed and the program's state freed, the plain reference
(``reference/``) over what the window produced. The last line of
standard output is the result; the numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.

``--rehearse`` runs the same path on the CPU at a ViT-Test-sized
configuration (``rehearsal_config``) and the traffic file's
``rehearsal`` sizes, with the kernels' plain versions; its ``device``
names the CPU. Without it a run needs a card, and exits 2 without one.

A configuration file (``configs/<config>.json``) states a CLIP model
whose towers are pre-LN transformers (a ViT image tower, a causal text
tower pooled at the end-of-text token). Its keys, of which the last
three take OpenAI's value when absent (``schema.py``):

- ``name``, ``model`` (the port's backbone name), ``source``,
  ``reduced``; ``source_notes`` and ``assumed`` for the reader: what it
  is, where it comes from, and what was set without a source;
- ``precision``: ``"bf16"`` or ``"fp32"``, the products' type;
- ``embed_dim``: the joint embedding's width;
- ``image_resolution``, ``vision_patch_size``: the image's side and the
  patches' (``(resolution / patch)^2 + 1`` tokens with the class token);
- ``vision_layers``, ``vision_width``, ``vision_heads``: the image
  tower's depth, width and heads (head width: width / heads);
- ``transformer_layers``, ``transformer_width``, ``transformer_heads``:
  the text tower's;
- ``context_length``, ``vocab_size``: the text tower's token positions
  and vocabulary (OpenAI's: 77, 49408);
- ``vision_mlp_width``, ``transformer_mlp_width`` (optional; 4 x the
  tower's width): each tower's MLP hidden width;
- ``activation`` (optional; ``"quick_gelu"``): the MLP's activation,
  ``"quick_gelu"`` (``x * sigmoid(1.702 x)``) or ``"gelu"`` (exact, erf).

The keys that name fields of the port's ``CLIPConfig`` build it; where
the port cannot run what the file states, the run stops before any
weight is made and names the key (``drivers/common.py::port_config``).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import os
import os.path as osp
import sys
import time
from types import SimpleNamespace

from . import schema

HERE = osp.dirname(osp.abspath(__file__))
ROOT = osp.dirname(HERE)
#: loaded by nothing the benchmark runs, compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "clip_calibration_tpu")
#: the configuration a rehearsal runs (ViT-Test's sizes)
REHEARSAL_SIZES = {"embed_dim": 32, "image_resolution": 32,
                   "vision_layers": 2, "vision_width": 64,
                   "vision_patch_size": 8, "vision_heads": 1,
                   "transformer_width": 64, "transformer_heads": 4,
                   "transformer_layers": 2}
#: the build and kernel caches, at fixed paths inside the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": "build/portbench/triton",
              "TORCH_EXTENSIONS_DIR": "build/portbench/torch_extensions"}


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def rehearsal_config(config: dict) -> dict:
    """``config`` at ``REHEARSAL_SIZES``, keeping its activation; an MLP
    width it states keeps its ratio to the tower's width, rounded to a
    multiple of 8. A configuration that states neither rehearses at
    ``REHEARSAL_SIZES`` alone."""
    out = {**config, **REHEARSAL_SIZES}
    for tower in schema.TOWERS:
        key = f"{tower}_mlp_width"
        if key in config:
            ratio = config[key] / config[f"{tower}_width"]
            out[key] = 8 * max(1, round(ratio * out[f"{tower}_width"] / 8))
    return out


def load_cell(workload: str, rehearse: bool = False) -> SimpleNamespace:
    """Everything ``BENCHMARK.json`` and the cell's files say about it."""
    spec = _json(osp.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = _json(osp.join(ROOT, conf["file"]))
    traffic = _json(osp.join(HERE, "traffic", cell["traffic"] + ".json"))
    if rehearse:
        config = rehearsal_config(config)
        traffic = {**traffic, **traffic.get("rehearsal", {})}

    def ours(m):
        return workload in m.get("workloads", [workload])

    # a rehearsal's numbers are held to limits set from rehearsals
    limits = _json(osp.join(HERE, "limits", workload + ".json"))
    limits = limits["rehearsal"] if rehearse else {
        k: v for k, v in limits.items() if k != "rehearsal"}
    return SimpleNamespace(
        name=workload, cell=cell, config=config, traffic=traffic,
        limits=limits,
        end_to_end=[m for m in spec["end_to_end"] if ours(m)],
        per_layer=[m for m in spec["per_layer"] if ours(m)],
        rehearse=rehearse)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def set_environment(traffic: dict) -> None:
    """Before torch or numpy is imported: the caches inside the checkout,
    no JAX, and ``cpu_threads`` threads in each CPU thread pool, as the
    cell's traffic file sets it (absent: the pools' defaults). Where the
    measured steps are paced by one Python thread's dispatch, pools of
    spinning workers on the machine's other cores only made the runs
    spread more (one chip machine, ViT-L/14 CoOp: 549-660 images/s with
    the default pools, 629-668 with one thread)."""
    for var, rel in CACHE_DIRS.items():
        path = osp.join(ROOT, rel)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path
    # keep libraries that can load JAX by themselves from doing so
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    threads = traffic.get("cpu_threads")
    if threads is not None:
        for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                    "OPENBLAS_NUM_THREADS"):
            os.environ[var] = str(threads)


def _driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def _reader(metric: str):
    path = osp.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def device_info(run, peak_bytes: int) -> dict:
    import torch
    if run.rehearse:
        return {"platform": "cpu", "kind": "cpu (rehearsal)", "count": 1,
                "memory_peak_bytes": peak_bytes}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": run.cell["chips"], "memory_peak_bytes": peak_bytes}


def judge(checks: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every limited number present,
    finite and at most its limit. A number the cell's limits leave out is
    not compared (``PERF.md`` says why); the run prints it as a note."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = checks.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        out[name] = {"value": v, "limit": limit}
    return ok, out


def per_layer_metrics(run, reading) -> dict:
    out = {}
    for m in run.per_layer:
        v = _reader(m["name"])(reading)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def main(argv=None, t0: float = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="run on the CPU at a ViT-Test-sized configuration "
                        "(the kernels' plain versions)")
    args = p.parse_args(argv)
    run = load_cell(args.workload, args.rehearse)
    run.seed, run.seconds, run.trace = args.seed, args.seconds, args.trace

    set_environment(run.traffic)
    import torch
    if not args.rehearse:
        cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if cards < run.cell["chips"]:
            print(f"portbench: {run.name} needs {run.cell['chips']} CUDA "
                  f"device(s); torch sees {cards}", file=sys.stderr)
            return 2
    run.device = torch.device("cpu" if args.rehearse else "cuda:0")
    try:
        import clip_calibration_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the port is not in this checkout ({e})",
              file=sys.stderr)
        return 1

    from .tracing import NoSlice, Slice
    drv = _driver(run.traffic["driver"]).Driver(run)
    tracer = Slice() if args.trace else NoSlice()
    with contextlib.redirect_stdout(sys.stderr):
        drv.setup()
        tracer.prepare()
        if run.device.type == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        e2e = drv.window(args.seconds, tracer)
        tracer.stop()
        peak = (torch.cuda.max_memory_allocated(run.device)
                if run.device.type == "cuda" else 0)
        bad = forbidden_modules()
        if bad:
            print(f"portbench: loaded by the run: {bad}", file=sys.stderr)
            return 1
        reading = drv.reading(tracer) if args.trace else None
        drv.release()
        checks = drv.check()
    correct, compared = judge(checks, run.limits)
    correct = correct and e2e["failed"] == 0
    if args.trace:
        metrics = per_layer_metrics(run, reading)
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for m in run.end_to_end:
            if m["name"] in e2e["metrics"]:
                metrics[m["name"]] = {"value": e2e["metrics"][m["name"]],
                                      "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": e2e["attempted"],
              "failed": e2e["failed"], "metrics": metrics,
              "device": device_info(run, peak)}
    if args.trace:
        s = tracer.summary
        result["device"]["busy_s"] = s.busy_s
        result["device"]["window_s"] = s.window_s
        result["breakdown"] = {"device_ops": s.top_ops(),
                               "idle_gaps": s.idle_by_host()}
    result["checks"] = compared
    # the reference and the metric readers ran after the window's check
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded by the run: {bad}", file=sys.stderr)
        return 1
    notes = {**e2e.get("notes", {}),
             **{k: v for k, v in checks.items() if k not in compared}}
    for k, v in notes.items():
        print(f"note {k} {v!r}", file=sys.stderr)
    for name, c in compared.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"check failed {e2e['failed']} limit 0", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
