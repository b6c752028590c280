"""The port stands alone: it imports nothing of JAX or the JAX package,
runs without scikit-learn and matplotlib (optional for the port), and
never falls back to the CPU on its own."""

import ast
import glob
import json
import os
import os.path as osp
import subprocess
import sys
import textwrap

import pytest

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
PORT = osp.join(REPO, "clip_calibration_tpu_torch")
FIX = osp.join(REPO, "tests", "fixtures", "golden_e2e")
FORBIDDEN = ("jax", "jaxlib", "optax", "ml_dtypes", "clip_calibration_tpu")

SOURCES = sorted(glob.glob(osp.join(PORT, "**", "*.py"), recursive=True)
                 ) + [osp.join(REPO, "chip_smoke.py")]


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=[osp.relpath(p, REPO) for p in SOURCES])
def test_no_jax_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{osp.relpath(path, REPO)} imports {mod}"


def test_port_has_its_own_assets():
    assert osp.exists(osp.join(PORT, "assets", "bpe_simple_vocab_16e6.txt.gz"))
    assert osp.exists(osp.join(PORT, "csrc", "mha_qkv_fwd.cu"))
    assert osp.exists(osp.join(PORT, "csrc", "mha_qkv_bwd.cu"))
    assert osp.exists(osp.join(PORT, "csrc", "int8_matmul.cu"))
    assert osp.exists(osp.join(PORT, "csrc", "int8_attention.cu"))


_BLOCKER = textwrap.dedent("""
    import sys

    class Blocker:
        # jax and the JAX package, plus scikit-learn and matplotlib,
        # which the port's main path must not need
        names = ("jax", "jaxlib", "optax", "ml_dtypes",
                 "clip_calibration_tpu", "sklearn", "matplotlib")

        def find_spec(self, fullname, path=None, target=None):
            if any(fullname == n or fullname.startswith(n + ".")
                   for n in self.names):
                raise ImportError(f"blocked: {fullname}")
            return None

    sys.meta_path.insert(0, Blocker())
    # as on a machine without them: importlib.util.find_spec probes (torch
    # makes some) answer None, and an import raises ModuleNotFoundError
    for name in Blocker.names:
        sys.modules[name] = None
""")


def _run(code, cwd, env_extra=None, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2",
               **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", _BLOCKER + code], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_port_runs_with_jax_blocked(tmp_path):
    """Import the port and run one ViT-Test encode on the CPU."""
    code = textwrap.dedent("""
        import torch
        from clip_calibration_tpu_torch.models import clip as M
        from clip_calibration_tpu_torch.models.backbone import (
            load_clip_backbone)
        model, cfg = load_clip_backbone("ViT-Test", "float32", "cpu")
        with torch.inference_mode():
            f = M.encode_image(model, cfg, torch.zeros(2, 32, 32, 3),
                               dtype=torch.float32)
        assert f.shape == (2, 32) and bool(torch.isfinite(f).all())
        assert sys.modules["jax"] is None  # never imported
        print("ok")
    """)
    r = _run(code, str(tmp_path),
             {"CLIP_CHECKPOINT_DIR": osp.join(FIX, "weights")})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def test_parallel_and_loaders_run_with_jax_blocked(tmp_path):
    """The multi-device modules and the eleven dataset loaders import with
    jax and the JAX package blocked; the dry run goes through on one rank
    (no process group: a (1, 1) mesh)."""
    code = textwrap.dedent("""
        import clip_calibration_tpu_torch.data.datasets as D
        from clip_calibration_tpu_torch.engine.registry import (
            DATASET_REGISTRY)
        from clip_calibration_tpu_torch.parallel import (dryrun, http_mesh,
                                                         mesh, tp)
        for name in ("DescribableTextures", "EuroSAT", "FGVCAircraft",
                     "Food101", "ImageNet", "ImageNetA", "ImageNetR",
                     "ImageNetSketch", "ImageNetV2", "OxfordFlowers",
                     "OxfordPets", "StanfordCars", "SUN397", "UCF101"):
            DATASET_REGISTRY.get(name)
        res = dryrun.dryrun_multichip("cpu", root="dry")
        assert "tp" not in res and res["products"]["cocoop"]["loss"]
        assert sys.modules["jax"] is None  # never imported
        print("ok")
    """)
    r = _run(code, str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")


def test_cli_stage_runs_with_jax_and_sklearn_blocked(tmp_path):
    """The whole ZeroshotCLIP stage of the CLI (loader, tokenizer, towers,
    KNN, calibrator, evaluator) runs without jax, sklearn or matplotlib."""
    import shutil
    shutil.copytree(osp.join(FIX, "data", "caltech-101"),
                    tmp_path / "data" / "caltech-101")
    args = ["--device", "cpu", "--seed", "1", "--backbone", "ViT-Test",
            "--root", "data", "--trainer", "ZeroshotCLIP",
            "--dataset-config-file",
            osp.join(REPO, "configs", "datasets", "caltech101.yaml"),
            "--config-file", osp.join(FIX, "coop_fp32.yaml"),
            "--output-dir", "out", "DATASET.NUM_SHOTS", "4",
            "MODEL.PRECISION", "fp32", "INPUT.SIZE", "(32, 32)",
            "DATASET.SUBSAMPLE_CLASSES", "base"]
    code = textwrap.dedent(f"""
        import runpy
        sys.argv = ["train"] + {args!r}
        runpy.run_module("clip_calibration_tpu_torch.train",
                         run_name="__main__")
    """)
    r = _run(code, str(tmp_path),
             {"CLIP_CHECKPOINT_DIR": osp.join(FIX, "weights")})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "=> result" in open(tmp_path / "out" / "log.txt").read()


BIN_STAGES = [  # (output dir, calibration config)
    ("out/iso_procal", {"BASE_CALIBRATION_MODE": "bin_based",
                        "BIN_CALIBRATOR_NAME": "isotonic_regression",
                        "IF_PROCAL": True}),
    ("out/multi_iso", {"BASE_CALIBRATION_MODE": "bin_based",
                       "BIN_CALIBRATOR_NAME": "multi_isotonic_regression"}),
]


def test_cli_bin_calibrators_run_with_sklearn_blocked(tmp_path):
    """Two ZeroshotCLIP stages of the CLI with ``CALIBRATION.BIN``
    (isotonic regression inside the proximity-binned BinMeanShift, and
    multi-class isotonic regression) and a k-means BinMeanShift, without
    jax, sklearn or matplotlib. Each stage's calibrated probabilities are
    held to the JAX package's calibrator (scikit-learn's fits) on the same
    inputs, to 1e-12."""
    import shutil
    import numpy as np
    from clip_calibration_tpu.config import get_cfg_default
    from clip_calibration_tpu.trainers.calibration.vl_calibrator import (
        VLCalibration)
    shutil.copytree(osp.join(FIX, "data", "caltech-101"),
                    tmp_path / "data" / "caltech-101")
    args = ["--device", "cpu", "--seed", "1", "--backbone", "ViT-Test",
            "--root", "data", "--trainer", "ZeroshotCLIP",
            "--dataset-config-file",
            osp.join(REPO, "configs", "datasets", "caltech101.yaml"),
            "--config-file", osp.join(FIX, "coop_fp32.yaml")]
    opts = ["DATASET.NUM_SHOTS", "4", "MODEL.PRECISION", "fp32",
            "INPUT.SIZE", "(32, 32)", "DATASET.SUBSAMPLE_CLASSES", "base"]
    stages = [(out, json.dumps(cal)) for out, cal in BIN_STAGES]
    code = textwrap.dedent(f"""
        import runpy
        import numpy as np
        from clip_calibration_tpu_torch.trainers.calibration import (
            bin_mean_shift, binning, vl_calibrator)
        predict = vl_calibrator.VLCalibration.predict

        def recorded(self, logits, test_proximity):
            probs = predict(self, logits, test_proximity)
            np.savez(self.cfg.OUTPUT_DIR + "/calibrated.npz",
                     val_logits=self.val_logits, val_labels=self.val_labels,
                     val_knn=self.val_image_knn_dists, logits=logits,
                     proximity=test_proximity, probs=probs)
            return probs

        vl_calibrator.VLCalibration.predict = recorded
        for out, cal in {stages!r}:
            sys.argv = (["train"] + {args!r} + ["--output-dir", out,
                        "--calibration-config", cal] + {opts!r})
            runpy.run_module("clip_calibration_tpu_torch.train",
                             run_name="__main__")
            sys.stdout = sys.__stdout__
        rng = np.random.default_rng(0)
        prox = rng.random(60) ** 2
        km = bin_mean_shift.BinMeanShift(
            "isotonic_regression", binning.IsotonicRegression,
            bin_strategy="kmeans", proximity_bin=4)
        np.save("kmeans_probs.npy", km.fit_transform(
            rng.normal(size=(60, 3)), prox, rng.integers(0, 3, 60)))
        np.save("kmeans_edges.npy", km.bin_edges)
        assert sys.modules["jax"] is None and sys.modules["sklearn"] is None
        print("ok")
    """)
    r = _run(code, str(tmp_path),
             {"CLIP_CHECKPOINT_DIR": osp.join(FIX, "weights")})
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")
    assert np.isfinite(np.load(tmp_path / "kmeans_probs.npy")).all()
    assert len(np.load(tmp_path / "kmeans_edges.npy")) == 5
    for out, cal in BIN_STAGES:
        rec = np.load(tmp_path / out / "calibrated.npz")
        cfg = get_cfg_default()
        jax_cal = VLCalibration(
            cfg, "bin_based", cal["BIN_CALIBRATOR_NAME"], False,
            cal.get("IF_PROCAL", False),
            {"val_logits": rec["val_logits"], "val_labels": rec["val_labels"],
             "val_image_knn_dists": rec["val_knn"]}, None)
        jax_cal.fit()
        want = jax_cal.predict(rec["logits"], rec["proximity"])
        np.testing.assert_allclose(rec["probs"], want, rtol=1e-12,
                                   atol=1e-12)
        log = ("log_" + cal["BIN_CALIBRATOR_NAME"]
               + ("_procal" if cal.get("IF_PROCAL") else "") + ".txt")
        assert "=> result" in open(tmp_path / out / log).read()


def test_cli_training_runs_with_jax_and_sklearn_blocked(tmp_path):
    """The training slice of the CLI: a ZeroshotCLIP base run, one CoOp
    training epoch (optimizer, checkpoint, final test) and a TempScaling
    fit on it, without jax, sklearn or matplotlib."""
    flags = ["--device", "cpu", "--seed", "1", "--backbone", "ViT-Test",
             "--root", "data", "--dataset-config-file",
             osp.join(REPO, "configs", "datasets", "synthetic.yaml")]
    opts = ["DATASET.NUM_SHOTS", "4", "INPUT.SIZE", "(32, 32)",
            "DATASET.SUBSAMPLE_CLASSES", "base"]
    coop = ["--trainer", "CoOp", "--config-file",
            osp.join(REPO, "configs", "trainers", "CoOp",
                     "vit_test_ep3.yaml"), "--output-dir", "out/coop"]
    scaling = json.dumps({
        "BASE_CALIBRATION_MODE": "scaling_based",
        "SCALING_CONFIG": osp.join(REPO, "configs", "calibration",
                                   "TempScaling", "ep5_lr5e-2.yaml"),
        "IF_DAC": False, "IF_PROCAL": False})
    runs = [  # (flags, opts) of each run
        (["--trainer", "ZeroshotCLIP", "--output-dir", "out/zs"], []),
        (coop, ["OPTIM.MAX_EPOCH", "1"]),
        (coop + ["--base-dir", "out/coop", "--calibration-config",
                 scaling], ["CALIBRATION.SCALING.BASE_EPOCH", "1"]),
    ]
    code = textwrap.dedent(f"""
        import runpy
        for run_flags, run_opts in {runs!r}:
            sys.argv = (["train"] + {flags!r} + run_flags + {opts!r}
                        + run_opts)
            runpy.run_module("clip_calibration_tpu_torch.train",
                             run_name="__main__")
            sys.stdout = sys.__stdout__
        assert sys.modules["jax"] is None and sys.modules["sklearn"] is None
    """)
    r = _run(code, str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    assert osp.exists(tmp_path / "out" / "coop" / "prompt_learner" /
                      "model.pth.tar-1")
    assert osp.exists(tmp_path / "out" / "coop" / "scale_learner" /
                      "model-calibrated.pth.tar-5")
    log = open(tmp_path / "out" / "coop" / "log_TempScaling.txt").read()
    assert "temperature" in log and "=> result" in log


def test_serving_runs_with_jax_and_sklearn_blocked(tmp_path):
    """The serving slice: the serve CLI in batch mode (w8a8 with
    calibration images and saved scales) and an HTTP round trip over a
    w8a8 predictor, without jax, sklearn or matplotlib."""
    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(0)
    (tmp_path / "imgs").mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
                        ).save(str(tmp_path / "imgs" / f"{i}.png"))
    code = textwrap.dedent("""
        import base64, json, threading, urllib.request
        from clip_calibration_tpu_torch import serve
        from clip_calibration_tpu_torch.config import get_cfg_default
        from clip_calibration_tpu_torch.data.transforms import (
            build_transform)
        from clip_calibration_tpu_torch.http_server import serve_http
        from clip_calibration_tpu_torch.serving import Predictor
        assert serve.main(["--device", "cpu", "--backbone", "ViT-Test",
                           "--classnames", "amber", "basalt",
                           "--images", "imgs", "--out", "p.jsonl",
                           "--quantize", "w8a8", "--calibration-images",
                           "imgs", "--save-act-scales", "s.npz"]) == 0
        pred = Predictor("ViT-Test", ["amber", "basalt"], quantize="w8a8",
                         act_scales="s.npz", batch_size=4, device="cpu")
        cfg = get_cfg_default()
        cfg.INPUT.SIZE = (32, 32)
        srv = serve_http(":0", pred, ["amber", "basalt"],
                         build_transform(cfg, is_train=False))
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        host, port = srv.server_address[:2]
        body = json.dumps({"images": [base64.b64encode(
            open("imgs/0.png", "rb").read()).decode()]}).encode()
        req = urllib.request.Request(
            f"http://{host}:{port}/predict", data=body,
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            rows = json.loads(r.read())["predictions"]
        srv.shutdown()
        srv.server_close()
        assert rows[0]["pred"] in ("amber", "basalt")
        assert sys.modules["jax"] is None and sys.modules["sklearn"] is None
        print("ok")
    """)
    r = _run(code, str(tmp_path),
             {"CLIP_CHECKPOINT_DIR": osp.join(FIX, "weights")})
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")
    assert len(open(tmp_path / "p.jsonl").read().splitlines()) == 3


def test_cli_default_device_raises_without_cuda(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "clip_calibration_tpu_torch.train",
         "--trainer", "ZeroshotCLIP", "--output-dir", str(tmp_path)],
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
    assert not os.listdir(tmp_path)  # failed before doing anything


def test_library_constructors_default_to_cuda_and_raise():
    import numpy as np
    import torch
    from clip_calibration_tpu_torch.config import get_cfg_default
    from clip_calibration_tpu_torch.engine.registry import build_trainer
    from clip_calibration_tpu_torch.models.backbone import load_clip_backbone
    from clip_calibration_tpu_torch.trainers.calibration.proximity import (
        get_knn_dists)
    import clip_calibration_tpu_torch.trainers  # noqa: F401
    assert not torch.cuda.is_available()
    cfg = get_cfg_default()
    cfg.TRAINER.NAME = "ZeroshotCLIP"
    from clip_calibration_tpu_torch.serving import Predictor
    from clip_calibration_tpu_torch import probe_int8_attention
    from clip_calibration_tpu_torch.parallel import dryrun as D
    from clip_calibration_tpu_torch.parallel.mesh import Mesh
    mesh = Mesh((1, 2), 0, None, None, (0,))
    for call in (lambda: build_trainer(cfg),
                 lambda: D.dryrun_multichip(),
                 lambda: D.setup("ViT-Test", n_cls=2, batch=2),
                 lambda: D.product_trainers(mesh),
                 lambda: D.tp_tower(mesh),
                 lambda: load_clip_backbone("ViT-Test"),
                 lambda: Predictor("ViT-Test", ["a", "b"]),
                 lambda: probe_int8_attention.main(["1", "8", "64", "1"]),
                 lambda: get_knn_dists(np.zeros((3, 2)), np.zeros((2, 2)), 1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
