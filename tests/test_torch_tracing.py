"""The port's spans and counters (``tools/profiling.py``): off, each
span times into its name's ring and never enters ``record_function``;
under a profiler, the spans are nested annotations in the Chrome trace
and the rings are left alone; and the places that record them (the CoOp
step, the towers, the loader's wait, the calibrators, the evaluator, the
dynamic batcher) record once per call."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from clip_calibration_tpu_torch.tools import profiling


def _counts(*names):
    snap = profiling.snapshot()
    return {n: snap[n]["count"] if n in snap else 0 for n in names}


def _grown(before, *names):
    after = _counts(*names)
    return {n: after[n] - before[n] for n in names}


def _no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered without a profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)


def test_span_without_profiler_never_enters_record_function(monkeypatch):
    _no_record_function(monkeypatch)
    before = _counts("test.block", "test.fn", "test.obs", "test.rows")

    @profiling.span("test.fn")
    def fn(x):
        return x + 1

    with profiling.span("test.block"):
        assert fn(1) == 2
    profiling.observe("test.obs", 0.25)
    profiling.count("test.rows", 7)
    assert _grown(before, "test.block", "test.fn", "test.obs",
                  "test.rows") == {"test.block": 1, "test.fn": 1,
                                   "test.obs": 1, "test.rows": 1}
    snap = profiling.snapshot()
    assert snap["test.obs"]["recent"][-1] == 0.25
    assert snap["test.rows"]["recent"][-1] == 7
    assert "total" in snap["test.rows"] and "total_s" in snap["test.obs"]
    assert 0 <= snap["test.block"]["recent"][-1] < 1.0
    # a nested span of its own name times each use
    with profiling.span("test.block"):
        with profiling.span("test.block"):
            pass
    assert _grown(before, "test.block")["test.block"] == 3


def test_cancelled_span_leaves_the_ring_alone():
    before = _counts("test.cancel")
    with profiling.span("test.cancel") as s:
        s.cancel()
    with profiling.span("test.cancel"):
        pass
    assert _grown(before, "test.cancel") == {"test.cancel": 1}


def test_ring_keeps_the_last_values_and_counts_all():
    name = "test.ring"
    n = profiling.RING + 100
    for i in range(n):
        profiling.count(name, i)
    entry = profiling.snapshot()[name]
    assert entry["count"] == n
    assert entry["total"] == n * (n - 1) / 2
    recent = entry["recent"]
    assert len(recent) == profiling.RING
    np.testing.assert_array_equal(recent, np.arange(100, n))
    profiling.count(name, n)
    entry = profiling.snapshot()[name]
    assert entry["count"] == n + 1 and entry["recent"][-1] == n
    assert len(entry["recent"]) == profiling.RING


@pytest.mark.parametrize("across", ["start", "stop"])
def test_span_open_across_a_profiler_start_or_stop_skips_the_ring(
        tmp_path, across):
    from torch.profiler import ProfilerActivity, profile
    name = f"test.across_{across}"
    before = _counts(name)
    prof = profile(activities=[ProfilerActivity.CPU])
    if across == "start":
        with profiling.span(name):
            prof.start()
        with profiling.span("test.inside"):
            pass
        prof.stop()
    else:
        prof.start()
        with profiling.span("test.inside"):
            pass
        with profiling.span(name):
            prof.stop()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    events = {e.get("name"): e
              for e in json.load(open(path))["traceEvents"]}
    assert "test.inside" in events  # the profiler saw its own spans
    if across == "start":
        assert name not in events
    else:  # cut at the stop by the profiler itself, and marked so
        assert events[name]["args"]["finished"] is False
        assert "finished" not in events["test.inside"]["args"]
    assert _grown(before, name) == {name: 0}


def test_span_blocked_on_another_thread_across_a_profiler_stop(
        tmp_path, monkeypatch):
    """The serving batcher's case: its thread opens a span under a
    profiler, then blocks in its queue while the main thread stops the
    profiler. No annotation is opened on that thread, the span exits
    cleanly after the stop, and its ring holds what it held before; the
    main thread's spans are in the trace as ever."""
    import queue
    import threading
    from torch.profiler import ProfilerActivity, profile
    name = "test.blocked"
    with profiling.span(name):  # one use off any profiler
        pass
    before = profiling.snapshot()[name]
    entered_on = []
    record_function = torch.profiler.record_function

    def spy(*args, **kwargs):
        entered_on.append(threading.current_thread())
        return record_function(*args, **kwargs)
    monkeypatch.setattr(torch.profiler, "record_function", spy)

    inbox, inside, errors = queue.Queue(), threading.Event(), []

    def worker():
        try:
            with profiling.span(name):
                inside.set()
                inbox.get()
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    thread = threading.Thread(target=worker)
    thread.start()
    assert inside.wait(10)
    with profiling.span("test.main"):
        pass
    prof.stop()
    inbox.put(None)
    thread.join(10)
    assert not thread.is_alive() and not errors
    assert entered_on == [threading.main_thread()]
    after = profiling.snapshot()[name]
    assert after["count"] == before["count"]
    np.testing.assert_array_equal(after["recent"], before["recent"])
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "test.main" in names and name not in names
    # off the profiler the thread's span times into the ring again
    worker_again = threading.Thread(target=worker)
    inbox.put(None)
    worker_again.start()
    worker_again.join(10)
    assert profiling.snapshot()[name]["count"] == before["count"] + 1


def _coop_trainer(tmp_path):
    from clip_calibration_tpu_torch.config import get_cfg_default
    from clip_calibration_tpu_torch.data.base import set_random_seed
    from clip_calibration_tpu_torch.engine.registry import TRAINER_REGISTRY
    import clip_calibration_tpu_torch.data.datasets  # noqa: F401
    import clip_calibration_tpu_torch.evaluators.vl_evaluator  # noqa: F401
    import clip_calibration_tpu_torch.trainers  # noqa: F401
    cfg = get_cfg_default()
    cfg.TEST.EVALUATOR = "VLClassification"
    cfg.DATASET.NAME = "Synthetic"
    cfg.DATASET.ROOT = str(tmp_path / "data")
    cfg.DATASET.NUM_SHOTS = 1
    cfg.DATASET.SUBSAMPLE_CLASSES = "base"
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    cfg.MODEL.BACKBONE.NAME = "ViT-Test"
    cfg.INPUT.SIZE = (32, 32)
    cfg.TRAINER.NAME = "CoOp"
    cfg.TRAINER.COOP.N_CTX = 4
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 4
    cfg.TEST.NO_TEST = True
    set_random_seed(1)
    return TRAINER_REGISTRY.get("CoOp")(cfg, device="cpu")


STEP_SPANS = ("train.step", "tower.text", "tower.vision", "train.backward")


def test_coop_step_spans_nest_in_the_trace_and_skip_the_ring(tmp_path):
    trainer = _coop_trainer(tmp_path)
    rng = np.random.default_rng(0)
    batch = {"img": rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8),
             "label": rng.integers(0, trainer.num_classes, 4)}
    before = _counts(*STEP_SPANS)
    trainer.forward_backward(batch)  # untraced: one value each
    assert _grown(before, *STEP_SPANS) == dict.fromkeys(STEP_SPANS, 1)
    before = _counts(*STEP_SPANS)
    with profiling.trace(str(tmp_path / "prof")) as tracer:
        trainer.forward_backward(batch)
    assert _grown(before, *STEP_SPANS) == dict.fromkeys(STEP_SPANS, 0)
    events = [e for e in json.load(open(tracer.path))["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("ph") == "X"
              and e.get("name") in STEP_SPANS]
    spans = {}
    for e in events:
        assert e["name"] not in spans, f"{e['name']} twice in one step"
        t0 = float(e["ts"])
        spans[e["name"]] = (t0, t0 + float(e["dur"]))
    assert set(spans) == set(STEP_SPANS)
    s0, s1 = spans["train.step"]
    for child in STEP_SPANS[1:]:
        c0, c1 = spans[child]
        assert s0 <= c0 and c1 <= s1, child
    # the backward follows both forwards
    assert spans["train.backward"][0] >= max(spans["tower.text"][1],
                                             spans["tower.vision"][1])


def test_device_staged_records_every_wait_and_the_last():
    from clip_calibration_tpu_torch.engine.trainer import TrainerX
    stub = SimpleNamespace(put_batch=lambda x: x)
    loader = [{"img": np.zeros(1), "label": np.zeros(1)} for _ in range(3)]
    before = _counts("data.wait")
    got = list(TrainerX._device_staged(stub, loader))
    assert len(got) == 3
    assert _grown(before, "data.wait") == {"data.wait": 4}


def test_eval_calibrators_leave_one_span_per_call(tmp_path):
    from clip_calibration_tpu_torch.config import get_cfg_default
    from clip_calibration_tpu_torch.evaluators.vl_evaluator import \
        VLClassification
    from clip_calibration_tpu_torch.trainers.base_learner import \
        VLBaseLearner
    from clip_calibration_tpu_torch.trainers.calibration import \
        proximity as PX
    from clip_calibration_tpu_torch.trainers.calibration.vl_calibrator \
        import VLCalibration

    cfg = get_cfg_default()
    cfg.OUTPUT_DIR = str(tmp_path)
    rng = np.random.default_rng(0)
    C, N, D = 5, 24, 8

    def unit(*shape):
        x = rng.standard_normal(shape)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    val_f, test_f = unit(N, D), unit(N, D)
    text = {k: unit(C, D) for k in (
        "base_text_features_zs", "current_text_features_zs",
        "base_text_features_tuned", "current_text_features_tuned")}
    val = {"val_logits": 10 * val_f @ text["base_text_features_tuned"].T,
           "val_labels": rng.integers(0, C, N),
           "val_image_knn_dists": PX.get_val_image_knn_dists(
               val_f, 3, device="cpu")}
    names = ("calib.fit", "calib.knn", "calib.score", "eval.metrics")
    before = _counts(*names)
    cal = VLCalibration(cfg, None, None, True, False, val, text,
                        device="cpu")
    cal.fit()
    knn = PX.get_knn_dists(val_f, test_f, 3, device="cpu")
    prox = PX.proximity_from_dists(knn)
    logits = 10 * test_f @ text["current_text_features_tuned"].T
    stub = SimpleNamespace(fused_dac_logit_scale=lambda: None)
    probs = VLBaseLearner._calibrated_probs(
        stub, cal, logits, test_f, text["current_text_features_tuned"],
        prox)
    results = VLClassification(cfg).evaluate(probs, rng.integers(0, C, N),
                                              prox)
    assert np.isfinite(list(results.values())).all()
    assert _grown(before, *names) == dict.fromkeys(names, 1)


def test_batcher_records_queue_waits_and_rows_failed_batch_included():
    from clip_calibration_tpu_torch.http_server import DynamicBatcher
    names = ("batcher.queue_wait", "batcher.rows", "batcher.flush",
             "batcher.collect")
    calls = []

    def predict(batch):
        calls.append(len(batch))
        if batch[0, 0, 0, 0] == 255:
            raise RuntimeError("bad batch")
        return {"preds": np.zeros(len(batch), np.int64)}

    before = _counts(*names)
    b = DynamicBatcher(predict, max_batch=4, max_wait_ms=20.0)
    try:
        good = [b.submit(np.zeros((2, 2, 3), np.uint8)) for _ in range(6)]
        for f in good:
            f.result(timeout=10)
        bad = b.submit(np.full((2, 2, 3), 255, np.uint8))
        with pytest.raises(RuntimeError, match="bad batch"):
            bad.result(timeout=10)
    finally:
        b.close()
    grown = _grown(before, *names)
    assert grown["batcher.queue_wait"] == 7
    assert grown["batcher.rows"] == grown["batcher.flush"] == len(calls)
    # the wait after the last batch, ended by close(), is not a collect
    assert grown["batcher.collect"] == len(calls)
    snap = profiling.snapshot()
    assert snap["batcher.rows"]["recent"][-len(calls):].tolist() == calls
    waits = snap["batcher.queue_wait"]["recent"][-7:]
    assert (waits >= 0).all() and (waits < 10).all()
