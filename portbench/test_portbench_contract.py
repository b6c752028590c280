"""The benchmark against its contract, on the CPU.

``BENCHMARK.json``'s shape, names and units; every cell's files; every
cell's harness path rehearsed (``--rehearse``: the CPU, a ViT-Test-sized
configuration, the kernels' plain versions) with its last line parsed;
the harness refusing to run without a card or without the port; each
fault a cell can have, planted in the port, turning ``correct`` false;
and each cell's control failing its limits. ``test_cell_on_card`` runs a
cell for real and skips without a card.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import re
import shutil
import subprocess
import sys

import pytest

HERE = osp.dirname(osp.abspath(__file__))
ROOT = osp.dirname(HERE)
with open(osp.join(ROOT, "BENCHMARK.json")) as _f:
    SPEC = json.load(_f)
CELLS = [w["name"] for w in SPEC["workloads"]]
DRIVER = {w["name"]: json.load(open(osp.join(
    HERE, "traffic", w["traffic"] + ".json")))["driver"]
    for w in SPEC["workloads"]}
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
LINE = re.compile(r"[^\n\t]{1,200}")
TIMEOUT = 300


def _run(args, cwd=ROOT, code=None):
    cmd = [sys.executable] + (["-c", code] if code else
                              ["portbench/run.py"]) + list(args)
    env = {**os.environ, "PYTHONPATH": cwd}
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=TIMEOUT, env=env)


def _last(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# -- BENCHMARK.json --------------------------------------------------------

def test_spec_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits the driver's 12 hours
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= len(SPEC["configs"]) <= 24
    assert 1 <= len(SPEC["workloads"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16
    assert 1 <= len(SPEC["per_layer"]) <= 128
    assert len(json.dumps(SPEC)) < 64 * 1024
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_and_units():
    entries = (SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"]
               + SPEC["per_layer"])
    names = [e["name"] for e in entries]
    for group in ("configs", "workloads"):
        got = [e["name"] for e in SPEC[group]]
        assert len(got) == len(set(got))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for n in names:
        assert NAME.fullmatch(n), n
    for w in SPEC["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
        assert LINE.fullmatch(w["why"]), w["why"]
    for c in SPEC["configs"]:
        assert LINE.fullmatch(c["source"]) and LINE.fullmatch(c["why"])
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.fullmatch(k)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert LINE.fullmatch(m["layer"])
    for word in SPEC["command"]:
        assert LINE.fullmatch(word)


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]

    def reports(metric, cell):
        return cell in metric.get("workloads", CELLS)

    for cell in CELLS:
        own = [m for m in SPEC["end_to_end"] if reports(m, cell)]
        assert len(own) >= 2, cell
        assert any(reports(m, cell) for m in SPEC["per_layer"]), cell
    for m in SPEC["per_layer"]:
        moves = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert reports(moves, cell), (m["name"], cell)
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all("\n" not in layer for layer in layers)


def test_every_cell_has_its_files():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert c["file"].startswith("portbench/")
        conf = json.load(open(osp.join(ROOT, c["file"])))
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert conf["source"] == c["source"]
    for w in SPEC["workloads"]:
        assert osp.exists(osp.join(HERE, "traffic", w["traffic"] + ".json"))
        limits = json.load(open(osp.join(HERE, "limits",
                                         w["name"] + ".json")))
        assert limits["rehearsal"] and set(limits) - {"rehearsal"}
    for m in SPEC["per_layer"]:
        assert osp.exists(osp.join(HERE, "metrics", m["name"] + ".py"))


# -- the harness, rehearsed --------------------------------------------------

@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_last_line(cell, trace):
    out = _last(_run(["--workload", cell, "--seed", "2147483747",
                      "--seconds", "1", "--trace", str(trace),
                      "--rehearse"]))
    keys = list(out)
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(keys)
    assert keys[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    dev = out["device"]
    assert dev["platform"] == "cpu" and "cpu" in dev["kind"]
    assert dev["count"] == 1
    own = [m for m in SPEC["end_to_end"]
           if cell in m.get("workloads", CELLS)]
    layer = [m for m in SPEC["per_layer"]
             if cell in m.get("workloads", CELLS)]
    if trace:
        assert "breakdown" in out
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert dev["window_s"] > 0 and "busy_s" in dev
        assert set(out["metrics"]) <= {m["name"] for m in layer}
        assert out["metrics"], "no per-layer metric was read"
    else:
        assert set(out["metrics"]) == {m["name"] for m in own}
    units = {m["name"]: m["unit"] for m in own + layer}
    for name, v in out["metrics"].items():
        assert v["unit"] == units[name]
        assert isinstance(v["value"], float)
    for name, c in out["checks"].items():
        assert c["limit"] is not None and c["value"] <= c["limit"], name


def test_no_card_exits_nonzero():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                 "--trace", "0"])
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_benchmark_files_alone_exit_nonzero(tmp_path):
    shutil.copy(osp.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                 "--trace", "0", "--rehearse"], cwd=str(tmp_path))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


# -- what correct catches ----------------------------------------------------

FAULT_CASES = [(c, f) for c in CELLS
               for f in __import__("portbench.faults", fromlist=["FAULTS"])
               .FAULTS[DRIVER[c]]]


@pytest.mark.parametrize("cell,fault", FAULT_CASES)
def test_fault_turns_correct_false(cell, fault):
    code = ("import sys; from portbench import faults, harness; "
            f"faults.plant({fault!r}, {DRIVER[cell]!r}); "
            "sys.exit(harness.main(sys.argv[1:]))")
    out = _last(_run(["--workload", cell, "--seed", "2147483749",
                      "--seconds", "1", "--trace", "0", "--rehearse"],
                     code=code))
    assert out["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_its_limits(cell):
    proc = subprocess.run(
        [sys.executable, "portbench/controls.py", "--workload", cell,
         "--seconds", "1", "--control-seeds", "2147483751", "--rehearse"],
        cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    control = json.loads(proc.stdout.strip().splitlines()[-1])[
        "upper"]["control"]
    limits = json.load(open(osp.join(HERE, "limits", cell + ".json")))
    limits = limits["rehearsal"]
    assert any(control[k] > limits[k] for k in limits), (control, limits)


@pytest.mark.card
def test_cell_on_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = _last(_run(["--workload", CELLS[0], "--seed", "2147483753",
                      "--seconds", "3", "--trace", "0"]))
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
