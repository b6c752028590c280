"""Nothing the benchmark runs loads JAX or the JAX package, and its
reference loads nothing of the port.

Each check imports in a fresh interpreter and lists ``sys.modules`` by
whole top-level name (the part before the first dot): the port's name
begins with the JAX package's, so a prefix test would be wrong.
"""

from __future__ import annotations

import glob
import json
import os.path as osp
import subprocess
import sys

HERE = osp.dirname(osp.abspath(__file__))
ROOT = osp.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "clip_calibration_tpu"}


def _loaded_after(code: str) -> set:
    probe = (code + "\nimport json, sys\n"
             "print(json.dumps(sorted({m.split('.')[0] "
             "for m in list(sys.modules)})))")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={"PYTHONPATH": ROOT, "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def _readers() -> str:
    paths = sorted(glob.glob(osp.join(HERE, "metrics", "*.py")))
    return "".join(
        f"import importlib.util as u; s = u.spec_from_file_location("
        f"'m{i}', {p!r}); u.module_from_spec(s).__spec__.loader"
        f".exec_module(u.module_from_spec(s))\n"
        for i, p in enumerate(paths))


def test_harness_reference_and_readers_load_no_jax():
    drivers = [osp.splitext(osp.basename(p))[0] for p in
               glob.glob(osp.join(HERE, "drivers", "*.py"))]
    code = ("import portbench.harness, portbench.tracing, "
            "portbench.readers, portbench.flops, portbench.bounds, "
            "portbench.controls, portbench.sweep, portbench.faults\n"
            "import portbench.reference.clip_ref, "
            "portbench.reference.coop_ref\n"
            + "".join(f"import portbench.drivers.{d}\n" for d in drivers)
            + _readers()
            # what the drivers import of the port at run time
            + "import clip_calibration_tpu_torch.serving, "
              "clip_calibration_tpu_torch.http_server, "
              "clip_calibration_tpu_torch.trainers, "
              "clip_calibration_tpu_torch.evaluators.vl_evaluator\n")
    loaded = _loaded_after(code)
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
    assert "clip_calibration_tpu_torch" in loaded


def test_reference_loads_nothing_of_the_port():
    loaded = _loaded_after(
        "import portbench.reference.clip_ref, portbench.reference.coop_ref"
        ", portbench.reference.tokenizer")
    assert not loaded & (FORBIDDEN | {"clip_calibration_tpu_torch"}), \
        loaded
    for path in glob.glob(osp.join(HERE, "reference", "*.py")):
        src = open(path).read()
        assert "clip_calibration_tpu" not in src, path


def test_nothing_reads_the_jax_benchmarks():
    for path in glob.glob(osp.join(HERE, "**", "*.py"), recursive=True):
        if osp.basename(path).startswith("test_"):
            continue
        src = open(path).read()
        for name in ("benchmarks/", "bench.py", "BENCH_", "MULTICHIP_"):
            assert name not in src, (path, name)


def test_jax_loaded_after_the_window_stops_the_result():
    """A metric reader (run after the window's check, with the reference)
    that loads a forbidden module: the harness prints no result."""
    code = ("import sys, types; from portbench import harness\n"
            "read = harness.per_layer_metrics\n"
            "def loads_jax(run, reading):\n"
            "    sys.modules['jax'] = types.ModuleType('jax')\n"
            "    return read(run, reading)\n"
            "harness.per_layer_metrics = loads_jax\n"
            "sys.exit(harness.main(sys.argv[1:]))")
    cell = json.load(open(osp.join(ROOT, "BENCHMARK.json")))[
        "workloads"][0]["name"]
    proc = subprocess.run(
        [sys.executable, "-c", code, "--workload", cell, "--seed", "7",
         "--seconds", "1", "--trace", "1", "--rehearse"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": ROOT, "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "jax" in proc.stderr.splitlines()[-1]
