"""HTTP serving over a process mesh (``clip_calibration_tpu_torch/
parallel/http_mesh.py`` behind ``serve.py --http --mesh``), on gloo
groups of 2 CPU processes.

The serve CLI runs on every rank with the ``CC_*`` cluster variables:
rank 0 serves HTTP, rank 1 joins each batch. Concurrent single images,
one JSON batch and a request that is not an image go to rank 0; the
answers are held to the single-process ``Predictor`` on the same decoded
images, then SIGTERM to rank 0 must end both ranks with exit code 0.
The tower is the TP test tower (2 vision heads; registered by a two-line
launcher, as the CLI has no preset of that shape), tensor-parallel with
int8 weights on mesh (1, 2) and data-parallel at full precision on mesh
(2). Every wait is bounded: a hang fails the test within a minute.
"""

import base64
import json
import os
import os.path as osp
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, osp.dirname(osp.abspath(__file__)))

from torch_parallel_driver import TP_PRESET, free_port, run_ranks  # noqa

CLASSNAMES = ["cat", "dog", "pelican"]
#: the whole test, launch to exit, in seconds
DEADLINE_S = 55
#: serve.main with the TP test tower registered as a preset
LAUNCHER = ("import sys; sys.path.insert(0, {repo!r}); "
            "from clip_calibration_tpu_torch.models import clip as M; "
            "from clip_calibration_tpu_torch.parallel.dryrun import TP_CFG; "
            "M.PRESETS[{preset!r}] = TP_CFG; "
            "from clip_calibration_tpu_torch import serve; "
            "sys.exit(serve.main(sys.argv[1:]))")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    from clip_calibration_tpu_torch.models import clip as M
    from clip_calibration_tpu_torch.models.weights import save_params
    from clip_calibration_tpu_torch.parallel.dryrun import TP_CFG
    d = tmp_path_factory.mktemp("http_mesh_weights")
    save_params(str(d / (TP_PRESET + ".npz")),
                M.init_clip(M.CLIP(TP_CFG, torch.float32, "cpu"), 7))
    return str(d)


@pytest.fixture()
def tp_preset(monkeypatch, weights):
    from clip_calibration_tpu_torch.models import clip as M
    from clip_calibration_tpu_torch.parallel.dryrun import TP_CFG
    monkeypatch.setitem(M.PRESETS, TP_PRESET, TP_CFG)
    monkeypatch.setenv("CLIP_CHECKPOINT_DIR", weights)


def _png(rng) -> bytes:
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


def _decode(blob: bytes) -> np.ndarray:
    """The server's decoding (serve.py's eval geometry at 32 px)."""
    import io
    from PIL import Image
    from clip_calibration_tpu_torch.serve import _host_transform, build_parser
    args = build_parser().parse_args(["--http", ":0", "--classnames", "a"])
    return np.asarray(_host_transform(args, 32)(Image.open(io.BytesIO(blob))))


def _start(tmp_path, weights, mesh, extra):
    port = free_port()
    procs, logs = [], []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   CLIP_CHECKPOINT_DIR=weights,
                   CC_COORD_ADDR=f"localhost:{port}", CC_NUM_PROCS="2",
                   CC_PROC_ID=str(rank))
        log = open(tmp_path / f"rank{rank}.log", "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c",
             LAUNCHER.format(repo=REPO, preset=TP_PRESET),
             "--device", "cpu", "--backbone", TP_PRESET, "--precision",
             "fp32", "--classnames", *CLASSNAMES, "--batch-size", "4",
             "--max-wait-ms", "50", "--http", "127.0.0.1:0", "--mesh", mesh,
             *extra], cwd=tmp_path, env=env, stdout=log,
            stderr=subprocess.STDOUT, text=True))
    return procs, logs


def _text(log) -> str:
    log.flush()
    with open(log.name) as f:
        return f.read()


def _url(procs, logs, deadline) -> str:
    while time.monotonic() < deadline:
        for line in _text(logs[0]).splitlines():
            if line.startswith("serving on http://"):
                return line.split()[2]
        if any(p.poll() is not None for p in procs):
            break
        time.sleep(0.2)
    raise AssertionError("no server:\n" + "\n".join(
        f"rank {r}:\n{_text(log)[-3000:]}" for r, log in enumerate(logs)))


def _post(url, body, ctype, timeout):
    req = urllib.request.Request(url + "/predict", data=body,
                                 headers={"Content-Type": ctype},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("mesh,extra", [("1,2", ["--quantize", "int8"]),
                                        ("2", [])],
                         ids=["tp-int8", "data-parallel"])
def test_http_over_two_ranks_matches_one_process(tmp_path, weights,
                                                 tp_preset, mesh, extra):
    from clip_calibration_tpu_torch.serving import Predictor
    deadline = time.monotonic() + DEADLINE_S
    rng = np.random.default_rng(11)
    blobs = [_png(rng) for _ in range(9)]
    procs, logs = _start(tmp_path, weights, mesh, extra)
    try:
        url = _url(procs, logs, deadline)
        left = lambda: max(1.0, deadline - time.monotonic())  # noqa: E731
        # not an image: rejected by rank 0's decode, the followers never
        # hear of it
        with pytest.raises(urllib.error.HTTPError) as bad:
            _post(url, b"not an image", "image/png", left())
        assert bad.value.code == 400
        answers, errors = {}, []

        def hit(i):
            try:
                answers[i] = _post(url, blobs[i], "image/png", left())
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(e)

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=left())
        assert not errors and len(answers) == 6, errors
        body = json.dumps({"images": [base64.b64encode(b).decode()
                                      for b in blobs[6:]]}).encode()
        rows = [answers[i] for i in range(6)] + _post(
            url, body, "application/json", left())["predictions"]
        with urllib.request.urlopen(url + "/stats", timeout=left()) as r:
            assert json.loads(r.read())["requests"] == 9
        procs[0].send_signal(signal.SIGTERM)
        for p in procs:
            p.wait(timeout=left())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{_text(logs[r])[-3000:]}"
    quantize = extra[1] if extra else None
    one = Predictor(TP_PRESET, CLASSNAMES, precision="fp32", batch_size=4,
                    quantize=quantize, device="cpu")
    want = one.predict(np.stack([_decode(b) for b in blobs]))
    for i, row in enumerate(rows):
        assert row["pred"] == CLASSNAMES[int(want["preds"][i])]
        # mesh vs one process within 2e-5, then rounded to 6 places
        assert row["confidence"] == pytest.approx(
            float(want["confidences"][i]), abs=3e-5)


def test_mesh_predictor_rejects_before_any_collective(tmp_path, weights,
                                                      tp_preset):
    """Rank 0's ``MeshPredictor`` over 2 ranks (mesh (1, 2)): a wrong
    image size raises there and sends nothing, an empty batch returns at
    once, no-op headers keep rank 1 waiting through a pause, one batch is
    joined, and the stop code ends rank 1's ``follow``."""
    from clip_calibration_tpu_torch.serving import Predictor
    rng = np.random.default_rng(12)
    images = rng.integers(0, 256, (5, 32, 32, 3), dtype=np.uint8)
    r0, r1 = run_ranks(str(tmp_path / "ranks"), 2,
                       {"classnames": CLASSNAMES, "serve_images": images},
                       ["mesh_predictor@1,2"], weights, timeout=50)
    r0, r1 = r0["mesh_predictor@1,2"], r1["mesh_predictor@1,2"]
    assert "expected [N, 32, 32, 3]" in r0["rejected"]
    assert r0["empty"]["probs"].shape == (0, 3)
    assert "stopped" in r0["after_stop"]
    assert r1 == {"joined": 1}
    want = Predictor(TP_PRESET, CLASSNAMES, precision="fp32", batch_size=3,
                     device="cpu").predict(images)["probs"]
    np.testing.assert_allclose(r0["probs"], want, rtol=2e-5, atol=2e-5)
