"""The readers of the program's own spans and counters
(``program.py``, the ``metrics/`` files that use it), on the CPU.

With no recorder in the port (the port before it had one), every such
reader returns None and a rehearsal still prints its line; a rehearsal
with the recorder prints every host-side metric of its cell (the
``idle_in_*`` readers need device operations, which a CPU trace lacks,
and return None there, as ``device_idle_pct`` does); and the idle time of
a made-up trace is put down to the innermost program span.
"""

from __future__ import annotations

import json
import os.path as osp
from types import SimpleNamespace

import pytest

from portbench import harness, program
from portbench.test_portbench_contract import HERE, SPEC, _last, _run
from portbench.tracing import Summary

NEW = {m["name"]: m for m in SPEC["per_layer"]
       if "program." in open(osp.join(HERE, "metrics",
                                      m["name"] + ".py")).read()}
HOST_SIDE = sorted(n for n in NEW if not n.startswith("idle_in_"))


def test_sixteen_readers_use_the_program():
    assert len(NEW) == 16
    for m in NEW.values():
        assert m["source"] in ("program_span", "program_counter",
                               "device_trace")
        assert (m["source"] == "device_trace") == \
            m["name"].startswith("idle_in_")


def _events(spans, kernels, window=(0.0, 1000.0)):
    """A trace's events: the slice's annotation, the device's kernels
    and the host's spans, as (name, start us, duration us)."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.slice",
           "ts": window[0], "dur": window[1] - window[0]}]
    ev += [{"ph": "X", "cat": "kernel", "name": "k", "ts": s, "dur": d}
           for s, d in kernels]
    ev += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": s,
            "dur": d} for n, s, d in spans]
    return ev


def _summary_without_program_spans():
    return Summary(_events([("bench.forward_backward", 0.0, 1000.0)],
                           [(100.0, 50.0)]))


@pytest.mark.parametrize("metric", sorted(NEW))
def test_reader_without_recorder_returns_none(metric, monkeypatch):
    """As the parent commit's port: no ``snapshot`` and no program span
    in the trace."""
    import clip_calibration_tpu_torch.tools.profiling as profiling
    monkeypatch.delattr(profiling, "snapshot", raising=False)
    reading = SimpleNamespace(
        summary=_summary_without_program_spans(), calls={},
        work_bound_s=0.0,
        spans={"forward_backward": [0.01] * 4, "calib_pass": [1.0] * 2},
        counters={})
    assert harness._reader(metric)(reading) is None


def test_idle_goes_to_the_innermost_span():
    # device busy on [0, 100) and [300, 400): gaps [100, 300), [400, 1000)
    spans = [("train.step", 50.0, 900.0),          # [50, 950)
             ("tower.text", 150.0, 100.0),         # [150, 250): gap mid 200
             ("bench.forward_backward", 0.0, 1000.0),
             ("aten::mm", 180.0, 40.0)]            # not a program span
    s = Summary(_events(spans, [(0.0, 100.0), (300.0, 400.0 - 300.0)]))
    # gap [100, 300) (mid 200) is under tower.text; [400, 1000) (mid 700)
    # under train.step
    assert program.idle_in_span_pct(s, "tower.text") == pytest.approx(20.0)
    assert program.idle_in_span_pct(s, "train.step") == pytest.approx(60.0)
    assert program.idle_in_span_pct(s, "train.backward") is None
    assert program.idle_in_span_pct(_summary_without_program_spans(),
                                    "tower.text") is None


def test_recent_reads_the_last_values():
    from clip_calibration_tpu_torch.tools import profiling
    for v in (1.0, 2.0, 3.0):
        profiling.count("test.program_recent", v)
    assert program.recent("test.program_recent", 2).tolist() == [2.0, 3.0]
    assert program.recent("test.program_recent").tolist()[-3:] == [1.0, 2.0,
                                                                    3.0]
    assert program.recent("test.program_recent", 10 ** 6) is None
    assert program.recent("test.no_such_name") is None


CELLS = [w["name"] for w in SPEC["workloads"]]


def _new_host_metrics(cell):
    return {n for n in HOST_SIDE if cell in NEW[n]["workloads"]}


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_prints_the_host_side_metrics(cell):
    out = _last(_run(["--workload", cell, "--seed", "2147483759",
                      "--seconds", "1", "--trace", "1", "--rehearse"]))
    assert out["correct"] is True
    got = out["metrics"]
    want = _new_host_metrics(cell)
    assert want and want <= set(got), sorted(want - set(got))
    assert not any(n.startswith("idle_in_") for n in got)  # no device ops
    v = {n: m["value"] for n, m in got.items()}
    if "step_host_ms.train" in v:
        parts = (v["text_fwd_host_ms.train"] + v["vision_fwd_host_ms.train"]
                 + v["backward_host_ms.train"])
        assert 0 < parts <= v["step_host_ms.train"]
        assert v["step_host_ms.train"] <= v["host_enqueue_ms.train"]
    if "calib_fit_ms.eval" in v:
        parts = sum(v[n] for n in ("calib_fit_ms.eval", "knn_ms.eval",
                                   "scoring_ms.eval",
                                   "eval_metrics_ms.eval"))
        assert 0 < parts <= v["calib_pass_ms.eval"]
    if "rows_per_batch.serve" in v:
        assert v["rows_per_batch.serve"] >= 1
        assert 0 < v["batcher_busy_pct.serve"] <= 100


@pytest.mark.parametrize("driver", sorted({
    json.load(open(osp.join(HERE, "traffic", w["traffic"] + ".json")))
    ["driver"]: w["name"] for w in SPEC["workloads"]}.items()))
def test_rehearsal_without_recorder_leaves_the_new_metrics_out(driver):
    """The harness over a port without the recorder (its ``snapshot``
    taken away, as the parent commit's port lacks it) still prints its
    line, without the new metrics."""
    _, cell = driver
    code = ("import sys; "
            "import clip_calibration_tpu_torch.tools.profiling as p; "
            "del p.snapshot; from portbench import harness; "
            "sys.exit(harness.main(sys.argv[1:]))")
    out = _last(_run(["--workload", cell, "--seed", "2147483761",
                      "--seconds", "1", "--trace", "1", "--rehearse"],
                     code=code))
    assert out["correct"] is True
    assert out["metrics"] and not set(out["metrics"]) & set(NEW)

