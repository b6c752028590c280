"""The port's HTTP model server (``clip_calibration_tpu_torch/
http_server.py``): the JAX suite's ``tests/test_http_server.py`` against
the port's copy, over the port's predictors on the CPU, plus a pin of the
copy's code to the original and the HTTP surface over a w8a8 predictor.
"""

import base64
import io
import json
import os.path as osp
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, REPO)
FIX = osp.join(REPO, "tests", "fixtures", "golden_e2e")

CLASSNAMES = ["amber", "basalt", "cobalt", "dune"]


@pytest.fixture(autouse=True)
def _fixture_weights(monkeypatch):
    monkeypatch.setenv("CLIP_CHECKPOINT_DIR", osp.join(FIX, "weights"))


# ---------------- DynamicBatcher unit gates ----------------


def test_batcher_coalesces_and_routes_rows():
    from clip_calibration_tpu_torch.http_server import DynamicBatcher

    calls = []

    def predict(batch):
        calls.append(batch.shape[0])
        # row-identifying output: each image is a constant plane
        return {"preds": batch[:, 0, 0, 0].astype(np.int64),
                "confidences": np.full(batch.shape[0], 0.5)}

    b = DynamicBatcher(predict, max_batch=8, max_wait_ms=200.0)
    try:
        imgs = [np.full((4, 4, 3), i, np.uint8) for i in range(6)]
        futs = [b.submit(img) for img in imgs]
        rows = [f.result(timeout=10) for f in futs]
        # every row routed back to its own request
        assert [int(r["preds"]) for r in rows] == list(range(6))
        # 6 near-simultaneous submits within the 200ms budget coalesce
        # into far fewer than 6 device calls (first call may race ahead
        # with a partial batch; all remaining must ride one batch)
        assert len(calls) <= 2 and sum(calls) == 6
    finally:
        b.close()


def test_batcher_propagates_predict_errors():
    from clip_calibration_tpu_torch.http_server import DynamicBatcher

    def predict(batch):
        raise RuntimeError("device fell over")

    b = DynamicBatcher(predict, max_batch=4, max_wait_ms=10.0)
    try:
        fut = b.submit(np.zeros((4, 4, 3), np.uint8))
        with pytest.raises(RuntimeError, match="fell over"):
            fut.result(timeout=10)
    finally:
        b.close()


def test_batcher_respects_max_batch():
    from clip_calibration_tpu_torch.http_server import DynamicBatcher

    calls = []

    def predict(batch):
        calls.append(batch.shape[0])
        return {"preds": np.zeros(batch.shape[0], np.int64)}

    b = DynamicBatcher(predict, max_batch=3, max_wait_ms=500.0)
    try:
        futs = [b.submit(np.zeros((2, 2, 3), np.uint8))
                for _ in range(7)]
        for f in futs:
            f.result(timeout=10)
        assert max(calls) <= 3 and sum(calls) == 7
    finally:
        b.close()


# ---------------- HTTP server end-to-end ----------------


def _fixture_image_bytes(n=3):
    """Golden-fixture test images as PNG bytes (what a client posts)."""
    import json as _json

    from PIL import Image

    split = _json.load(open(osp.join(
        FIX, "data", "caltech-101", "split_zhou_Caltech101.json")))
    root = osp.join(FIX, "data", "caltech-101", "101_ObjectCategories")
    blobs = []
    for rel, lab, _ in split["test"]:
        if lab in {0, 1, 2, 3}:
            buf = io.BytesIO()
            Image.open(osp.join(root, rel)).convert("RGB").save(
                buf, format="PNG")
            blobs.append(buf.getvalue())
            if len(blobs) == n:
                break
    return blobs


@pytest.fixture(scope="module")
def server():
    """ViT-Test zero-shot server on an ephemeral port (module-scoped:
    one compile). Sets CLIP_CHECKPOINT_DIR manually (module-scoped
    fixtures cannot use the function-scoped monkeypatch) and restores
    it on teardown so the fixture path cannot leak into other
    modules."""
    import os

    prev = os.environ.get("CLIP_CHECKPOINT_DIR")
    os.environ["CLIP_CHECKPOINT_DIR"] = osp.join(FIX, "weights")
    from clip_calibration_tpu_torch.http_server import serve_http
    from clip_calibration_tpu_torch.serving import Predictor

    pred = Predictor("ViT-Test", CLASSNAMES, precision="fp32",
                     batch_size=8, device="cpu")
    from clip_calibration_tpu_torch.config import get_cfg_default
    from clip_calibration_tpu_torch.data.transforms import build_transform

    cfg = get_cfg_default()
    cfg.INPUT.INTERPOLATION = "bicubic"
    cfg.INPUT.SIZE = (32, 32)
    srv = serve_http(":0", pred, CLASSNAMES,
                     build_transform(cfg, is_train=False), topk=2,
                     max_wait_ms=20.0, backbone="ViT-Test")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield srv
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
        if prev is None:
            os.environ.pop("CLIP_CHECKPOINT_DIR", None)
        else:
            os.environ["CLIP_CHECKPOINT_DIR"] = prev


def _url(srv, path):
    host, port = srv.server_address[:2]
    return f"http://{host}:{port}{path}"


def _get(srv, path):
    with urllib.request.urlopen(_url(srv, path), timeout=30) as r:
        return json.loads(r.read())


def _post(srv, body, ctype):
    req = urllib.request.Request(
        _url(srv, "/predict"), data=body,
        headers={"Content-Type": ctype}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_healthz_and_classes(server):
    h = _get(server, "/healthz")
    assert h["status"] == "ok" and h["backbone"] == "ViT-Test"
    assert h["classes"] == 4 and h["max_batch"] == 8
    assert _get(server, "/classes")["classnames"] == CLASSNAMES


def test_single_image_matches_direct_predictor(server):
    blob = _fixture_image_bytes(1)[0]
    row = _post(server, blob, "image/png")

    # the same pixels through the library API
    img = server.decode_image(blob)
    out = server.predictor.predict(img[None])
    assert row["pred"] == CLASSNAMES[int(out["preds"][0])]
    assert row["confidence"] == pytest.approx(
        float(out["confidences"][0]), abs=1e-5)
    assert len(row["topk"]) == 2
    assert row["topk"][0]["prob"] >= row["topk"][1]["prob"]


def test_json_batch_matches_direct_predictor(server):
    blobs = _fixture_image_bytes(3)
    body = json.dumps({
        "images": [base64.b64encode(b).decode() for b in blobs]
    }).encode()
    rows = _post(server, body, "application/json")["predictions"]
    assert len(rows) == 3

    imgs = np.stack([server.decode_image(b) for b in blobs])
    out = server.predictor.predict(imgs)
    for i, row in enumerate(rows):
        assert row["pred"] == CLASSNAMES[int(out["preds"][i])]
        assert row["confidence"] == pytest.approx(
            float(out["confidences"][i]), abs=1e-5)


def test_concurrent_requests_coalesce_and_agree(server):
    blobs = _fixture_image_bytes(3)
    results = {}
    errs = []

    def hit(i):
        try:
            results[i] = _post(server, blobs[i % 3], "image/png")
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append(e)

    before = len(server.batcher.snapshot_sizes())
    threads = [threading.Thread(target=hit, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs
    # identical images -> identical predictions regardless of which
    # coalesced batch each landed in
    for i in range(6):
        assert results[i] == results[i % 3]
    sizes = server.batcher.snapshot_sizes()[before:]
    assert sum(sizes) == 6
    stats = _get(server, "/stats")
    assert stats["requests"] >= 6 and stats["p50_latency_ms"] > 0


def test_bad_requests(server):
    # empty body
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, b"", "application/octet-stream")
    assert e.value.code == 400
    # undecodable image
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, b"not an image", "image/jpeg")
    assert e.value.code == 400
    # bad path
    with pytest.raises(urllib.error.HTTPError) as e:
        with urllib.request.urlopen(_url(server, "/nope"), timeout=30):
            pass
    assert e.value.code == 404


def test_cli_http_flag_validation():
    from clip_calibration_tpu_torch import serve

    # neither --images nor --http
    with pytest.raises(SystemExit, match="--images .*--http"):
        serve.main(["--classnames", "a", "b", "--device", "cpu"])


def test_http_quantized_predictor_composition():
    """The HTTP surface composes with a quantized predictor: serving a
    Predictor(quantize='int8') over HTTP gives the same prediction as
    calling it directly."""
    from clip_calibration_tpu_torch.config import get_cfg_default
    from clip_calibration_tpu_torch.data.transforms import build_transform
    from clip_calibration_tpu_torch.http_server import serve_http
    from clip_calibration_tpu_torch.serving import Predictor

    pred = Predictor("ViT-Test", CLASSNAMES, precision="fp32",
                     batch_size=4, quantize="int8", device="cpu")
    cfg = get_cfg_default()
    cfg.INPUT.INTERPOLATION = "bicubic"
    cfg.INPUT.SIZE = (32, 32)
    srv = serve_http(":0", pred, CLASSNAMES,
                     build_transform(cfg, is_train=False),
                     max_wait_ms=5.0, backbone="ViT-Test")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        blob = _fixture_image_bytes(1)[0]
        row = _post(srv, blob, "image/png")
        out = pred.predict(srv.decode_image(blob)[None])
        assert row["pred"] == CLASSNAMES[int(out["preds"][0])]
        assert row["confidence"] == pytest.approx(
            float(out["confidences"][0]), abs=1e-5)
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)


def test_keepalive_survives_bad_path_post(server):
    """A 404'd POST must drain its body: on a keep-alive connection the
    next request on the SAME socket must still parse (an unread body
    would desync the HTTP framing)."""
    import http.client

    host, port = server.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=30)
    try:
        blob = _fixture_image_bytes(1)[0]
        conn.request("POST", "/nope", body=blob,
                     headers={"Content-Type": "image/png"})
        r1 = conn.getresponse()
        assert r1.status == 404
        r1.read()
        # same connection, now a real prediction
        conn.request("POST", "/predict", body=blob,
                     headers={"Content-Type": "image/png"})
        r2 = conn.getresponse()
        assert r2.status == 200
        assert "pred" in json.loads(r2.read())
    finally:
        conn.close()


def test_batcher_close_rejects_new_and_fails_stragglers():
    from clip_calibration_tpu_torch.http_server import DynamicBatcher

    def predict(batch):
        return {"preds": np.zeros(batch.shape[0], np.int64)}

    b = DynamicBatcher(predict, max_batch=4, max_wait_ms=5.0)
    b.submit(np.zeros((2, 2, 3), np.uint8)).result(timeout=10)
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(np.zeros((2, 2, 3), np.uint8))


def test_batcher_survives_bad_predictor_output():
    """A predictor output that is not row-indexable must fail THAT
    batch's futures, not kill the worker thread (later requests would
    hang forever otherwise)."""
    from clip_calibration_tpu_torch.http_server import DynamicBatcher

    calls = []

    def predict(batch):
        calls.append(batch.shape[0])
        if len(calls) == 1:
            return {"preds": 3}  # scalar: not indexable per row
        return {"preds": np.zeros(batch.shape[0], np.int64)}

    b = DynamicBatcher(predict, max_batch=2, max_wait_ms=5.0)
    try:
        with pytest.raises(Exception):
            b.submit(np.zeros((2, 2, 3), np.uint8)).result(timeout=10)
        # the worker must still be alive and serving
        out = b.submit(np.zeros((2, 2, 3), np.uint8)).result(timeout=10)
        assert int(out["preds"]) == 0
    finally:
        b.close()


def test_http_over_tempscaling_trainer_checkpoint(tmp_path):
    """The HTTP surface composes with a TrainerPredictor: a calibrated
    TempScaling checkpoint serves over HTTP with predictions matching
    the direct library call (the calibrated production shape —
    tempered probabilities through the trainer's own inference)."""
    import torch

    from clip_calibration_tpu_torch.config import get_cfg_default
    from clip_calibration_tpu_torch.data.transforms import build_transform
    from clip_calibration_tpu_torch.http_server import serve_http
    from clip_calibration_tpu_torch.serving import (TrainerPredictor,
                                              build_serving_trainer)

    BASE = CLASSNAMES[:2]
    opts = ["CALIBRATION.SCALING.BASE_LEARNER", "CoOp",
            "CALIBRATION.SCALING.BASE_DIR",
            osp.join(FIX, "coop_model"),
            "CALIBRATION.SCALING.BASE_EPOCH", "3",
            "TRAINER.COOP.N_CTX", "4", "INPUT.SIZE", "(32, 32)",
            "MODEL.PRECISION", "fp32", "TRAINER.COOP.PREC", "fp32"]
    fitted = build_serving_trainer(BASE, trainer_name="TempScaling",
                                   backbone="ViT-Test", opts=opts,
                                   device="cpu")
    with torch.no_grad():
        fitted.model_params("scale_learner")["scale"].fill_(np.log(2.5))
    ck = str(tmp_path / "calibrated")
    fitted.save_model(0, ck)
    pred = TrainerPredictor.from_checkpoint(
        ck, BASE, trainer_name="TempScaling", backbone="ViT-Test",
        opts=opts, epoch=1, batch_size=4, device="cpu")

    cfg = get_cfg_default()
    cfg.INPUT.INTERPOLATION = "bicubic"
    cfg.INPUT.SIZE = (32, 32)
    srv = serve_http(":0", pred, BASE,
                     build_transform(cfg, is_train=False),
                     max_wait_ms=5.0, backbone="ViT-Test")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        blob = _fixture_image_bytes(1)[0]
        row = _post(srv, blob, "image/png")
        out = pred.predict(srv.decode_image(blob)[None])
        assert row["pred"] == BASE[int(out["preds"][0])]
        assert row["confidence"] == pytest.approx(
            float(out["confidences"][0]), abs=1e-5)
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)


def test_batcher_fuzz_concurrency():
    """Stress invariants under randomized concurrent load: every
    submitted request resolves exactly once with ITS OWN row, batches
    never exceed max_batch, and the size ledger accounts for every
    request — across jittered submit timing and a predictor that
    sometimes fails."""
    import random
    import time as _time

    from clip_calibration_tpu_torch.http_server import DynamicBatcher

    rng = random.Random(0)

    def predict(batch):
        if batch[0, 0, 0, 1] == 255:  # poison marker
            raise ValueError("poisoned batch")
        _time.sleep(rng.random() * 0.003)
        return {"echo": batch[:, 0, 0, 0].astype(np.int64)}

    b = DynamicBatcher(predict, max_batch=5, max_wait_ms=3.0)
    results, errors = {}, {}

    def client(cid, n):
        for r in range(n):
            val = (cid * 17 + r) % 251
            img = np.full((2, 2, 3), val, np.uint8)
            poison = rng.random() < 0.1
            if poison:
                img[0, 0, 1] = 255
            _time.sleep(rng.random() * 0.002)
            try:
                out = b.submit(img).result(timeout=30)
                results[(cid, r)] = (int(out["echo"]), val)
            except ValueError:
                errors[(cid, r)] = True
            except Exception:
                # a non-poisoned request can land in a poisoned batch —
                # that still counts as a resolved (failed) future
                errors[(cid, r)] = True

    try:
        threads = [threading.Thread(target=client, args=(c, 12))
                   for c in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        # every request resolved exactly once
        assert len(results) + len(errors) == 6 * 12
        # each success carries its own value (no cross-request routing)
        for got, want in results.values():
            assert got == want
        sizes = b.snapshot_sizes()
        assert max(sizes) <= 5
        assert sum(sizes) == 6 * 12
    finally:
        b.close()


# ---------------- the copy and the w8a8 path ----------------


def _code(path):
    """The module's AST with every docstring dropped."""
    import ast

    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(
                body[0], ast.Expr) and isinstance(
                getattr(body[0], "value", None), ast.Constant) and \
                isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


def test_port_copy_is_pinned_to_the_original():
    assert _code(osp.join(REPO, "clip_calibration_tpu_torch",
                          "http_server.py")) == \
        _code(osp.join(REPO, "clip_calibration_tpu", "http_server.py"))


def test_http_w8a8_predictor_concurrent_and_batch():
    """A static-scale w8a8 predictor behind the server: concurrent single
    images and one JSON batch answer what direct predict computes (lone
    requests may ride the 1-row bucket's dynamic scales, so each answer is
    held to predict on the batch it was served in: the same image alone
    and inside the batch give the same top class here)."""
    from clip_calibration_tpu_torch.config import get_cfg_default
    from clip_calibration_tpu_torch.data.transforms import build_transform
    from clip_calibration_tpu_torch.http_server import serve_http
    from clip_calibration_tpu_torch.serving import Predictor
    from helpers import golden_test_images

    cal, _ = golden_test_images({0, 1, 2, 3})
    pred = Predictor("ViT-Test", CLASSNAMES, precision="fp32",
                     batch_size=4, quantize="w8a8", calibration_images=cal,
                     device="cpu")
    cfg = get_cfg_default()
    cfg.INPUT.INTERPOLATION = "bicubic"
    cfg.INPUT.SIZE = (32, 32)
    srv = serve_http(":0", pred, CLASSNAMES,
                     build_transform(cfg, is_train=False),
                     max_wait_ms=50.0, backbone="ViT-Test")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        blobs = _fixture_image_bytes(3)
        imgs = np.stack([srv.decode_image(b) for b in blobs])
        batch = pred.predict(imgs)
        alone = [pred.predict(img[None]) for img in imgs]
        results, errs = {}, []

        def hit(i):
            try:
                results[i] = _post(srv, blobs[i], "image/png")
            except Exception as e:  # noqa: BLE001 — surfaced below
                errs.append(e)

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not errs
        for i in range(3):
            want = {float(batch["confidences"][i]),
                    float(alone[i]["confidences"][0])}
            assert results[i]["pred"] == CLASSNAMES[int(batch["preds"][i])]
            assert any(results[i]["confidence"] == pytest.approx(c, abs=1e-5)
                       for c in want)
        body = json.dumps({"images": [base64.b64encode(b).decode()
                                      for b in blobs]}).encode()
        rows = _post(srv, body, "application/json")["predictions"]
        for i, row in enumerate(rows):
            assert row["pred"] == CLASSNAMES[int(batch["preds"][i])]
            assert row["confidence"] == pytest.approx(
                float(batch["confidences"][i]), abs=1e-5)
        assert _get(srv, "/stats")["requests"] == 6
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
