"""The port's tooling against the JAX package's: ``tools/profiling.py``
(``trace``; its spans and counters are in ``test_torch_tracing.py``),
``TPU.PROFILE_DIR`` step tracing in the train loop, and
``interpret_prompt``."""

import json
import os
import os.path as osp
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIX = osp.join(REPO, "tests", "fixtures", "golden_e2e")


def test_trace_writes_chrome_trace(tmp_path):
    from clip_calibration_tpu_torch.tools.profiling import trace
    with trace(str(tmp_path / "prof")) as tracer:
        torch.ones((64, 64)) @ torch.ones((64, 64))
    assert osp.dirname(tracer.path) == str(tmp_path / "prof")
    events = json.load(open(tracer.path))["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def _train_cli(cwd, out, extra_flags, extra_opts=()):
    flags = ["--device", "cpu", "--seed", "1", "--backbone", "ViT-Test",
             "--root", "data", "--dataset-config-file",
             osp.join(REPO, "configs", "datasets", "synthetic.yaml"),
             "--output-dir", out]
    opts = ["DATASET.NUM_SHOTS", "4", "INPUT.SIZE", "(32, 32)",
            "DATASET.SUBSAMPLE_CLASSES", "base", "TRAIN.PRINT_FREQ", "1"]
    r = subprocess.run(
        [sys.executable, "-m", "clip_calibration_tpu_torch.train"] + flags
        + list(extra_flags) + opts + list(extra_opts), cwd=str(cwd),
        capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"),
        timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


@pytest.fixture(scope="module")
def coop_runs(tmp_path_factory):
    """One CoOp epoch without tracing, traced for its first step, and
    traced for more steps than the epoch has (after the ZeroshotCLIP base
    run its test pipeline needs)."""
    wd = tmp_path_factory.mktemp("torch_profile")
    _train_cli(wd, "out/zs", ["--trainer", "ZeroshotCLIP"])
    coop = ["--trainer", "CoOp", "--config-file",
            osp.join(REPO, "configs", "trainers", "CoOp", "vit_test_ep3.yaml")]
    runs = {}
    for name, prof in (("plain", []),
                       ("traced", ["TPU.PROFILE_DIR", "prof1",
                                   "TPU.PROFILE_STEPS", "1"]),
                       ("traced_whole", ["TPU.PROFILE_DIR", "prof_all",
                                         "TPU.PROFILE_STEPS", "1000"])):
        stdout = _train_cli(wd, f"out/{name}", coop,
                            ["OPTIM.MAX_EPOCH", "1"] + prof)
        log = open(wd / "out" / name / "log.txt").read()
        runs[name] = {"losses": re.findall(r" loss (\S+) \(", log),
                      "stdout": stdout}
    runs["workdir"] = wd
    return runs


@pytest.mark.parametrize("name,prof", [("traced", "prof1"),
                                       ("traced_whole", "prof_all")])
def test_profile_dir_traces_steps_and_keeps_losses(coop_runs, name, prof):
    plain = coop_runs["plain"]["losses"]
    assert len(plain) >= 2  # more steps than the first trace covers
    assert coop_runs[name]["losses"] == plain
    traces = list((coop_runs["workdir"] / prof).glob("trace_*.json"))
    assert len(traces) == 1, traces
    events = json.load(open(traces[0]))["traceEvents"]
    names = {e.get("name") for e in events}
    # the text tower's attention (the plain version on the CPU) ran inside
    assert "aten::softmax" in names or "aten::_softmax" in names
    assert "Tracing first" in coop_runs[name]["stdout"]


def test_traced_steps_stop_at_profile_steps(coop_runs):
    """PROFILE_STEPS 1 traces 1 train step: the trace holds 1 of the
    optimizer's steps, the whole-epoch trace all of them."""
    counts = {}
    for prof in ("prof1", "prof_all"):
        path = next((coop_runs["workdir"] / prof).glob("trace_*.json"))
        events = json.load(open(path))["traceEvents"]
        counts[prof] = sum(1 for e in events if e.get("ph") == "X"
                           and str(e.get("name", "")).startswith(
                               "Optimizer.step"))
    assert counts["prof1"] == 1
    assert counts["prof_all"] == len(coop_runs["plain"]["losses"])


def _interpret(script_args, cwd, jax_script):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               CLIP_CHECKPOINT_DIR=osp.join(FIX, "weights"))
    cmd = ([sys.executable, osp.join(REPO, "interpret_prompts",
                                     "interpret_prompt.py")] if jax_script
           else [sys.executable, "-m",
                 "clip_calibration_tpu_torch.interpret_prompt"])
    r = subprocess.run(cmd + script_args
                       + ([] if jax_script else ["--device", "cpu"]),
                       cwd=str(cwd), env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.splitlines()


def test_interpret_prompt_prints_the_jax_scripts_lines(tmp_path):
    """A reference-format CoOp checkpoint (shallow ctx) and a native one
    with per-layer compound text prompts, against the ViT-Test token
    embedding."""
    from clip_calibration_tpu_torch.engine.checkpoint import save_checkpoint
    rng = np.random.default_rng(0)
    native = save_checkpoint(
        {"state_dict": {
            "ctx": torch.from_numpy(rng.normal(size=(3, 64))
                                    .astype(np.float32) * 0.02),
            "compound_text": torch.from_numpy(
                rng.normal(size=(2, 3, 64)).astype(np.float32) * 0.02)},
         "epoch": 1}, str(tmp_path / "maple"), 1)
    ref = osp.join(FIX, "coop_model", "prompt_learner", "model.pth.tar-3")
    for ckpt in (ref, native):
        args = [ckpt, "5", "--backbone", "ViT-Test"]
        want = _interpret(args, tmp_path, jax_script=True)
        got = _interpret(args, tmp_path, jax_script=False)
        assert got == want
        assert any(ln.startswith("SHOWING RESULTS FOR: shallow ctx")
                   for ln in got)
    assert sum(ln.startswith("SHOWING RESULTS FOR: layer") for ln in got) == 2


@pytest.mark.parametrize("name", ["mha_qkv_fwd", "mha_qkv_bwd",
                                  "int8_matmul", "int8_attention",
                                  "layer_norm"])
def test_build_is_stale_when_a_shared_header_changes(tmp_path, monkeypatch,
                                                     name):
    """``ops/build.py`` rebuilds a kernel whose library is older than its
    source or than any ``csrc/*.cuh`` it may include (a copy of ``csrc/``
    and a build directory with up-to-date libraries, then one header
    touched)."""
    import shutil
    from clip_calibration_tpu_torch.ops import build
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    out = tmp_path / "build"
    out.mkdir()
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(out))
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "csrc/ holds no shared header"
    sources = [csrc / build.SOURCES[n] for n in build.SOURCES]
    for p in sources + headers:
        os.utime(p, (1000.0, 1000.0))
    assert build._stale(name)  # no library yet
    lib = build.library_path(name)
    open(lib, "wb").close()
    os.utime(lib, (2000.0, 2000.0))
    assert not build._stale(name)
    os.utime(csrc / build.SOURCES[name], (3000.0, 3000.0))
    assert build._stale(name)  # its own source is newer
    os.utime(lib, (4000.0, 4000.0))
    assert not build._stale(name)
    os.utime(headers[0], (5000.0, 5000.0))
    assert build._stale(name)  # a shared header is newer


@pytest.mark.parametrize("source", ["mha_qkv_fwd.cu", "mha_qkv_fwd.cu:fp32",
                                    "mha_qkv_bwd.cu", "mha_qkv_bwd.cu:fp32",
                                    "int8_matmul.cu", "int8_attention.cu"])
def test_kernel_variants_apply_to_the_sources(source):
    """Every recorded variant of ``tools/kernel_variants.py`` still finds
    the text it replaces in the kernel's source (they time on the card
    only); a missing text raises."""
    from clip_calibration_tpu_torch.tools import kernel_variants as kv
    texts = kv.apply_variants(source, kv.RECORDED[source])
    assert set(texts) == {"source", *kv.RECORDED[source]}
    for name, text in texts.items():
        assert name == "source" or text != texts["source"]
    with pytest.raises(ValueError, match="is not in"):
        kv.apply_variants(source, {"bad": [["no such text", ""]]})
    assert kv.main([]) == 2
    # the variants' libraries are bound from the kernel module's own table
    from clip_calibration_tpu_torch.ops import (int8_attention, int8_matmul,
                                                mha_qkv)
    name = kv.source_file(source)[:-3]
    module = {"mha_qkv_fwd": mha_qkv, "mha_qkv_bwd": mha_qkv,
              "int8_matmul": int8_matmul,
              "int8_attention": int8_attention}[name]
    assert kv.argtypes(source) is module.ARGTYPES[name]


_C_TYPES = {"void*": "c_void_p", "constvoid*": "c_void_p", "int": "c_int",
            "float": "c_float"}


@pytest.mark.parametrize("name", ["mha_qkv_fwd", "mha_qkv_bwd",
                                  "int8_matmul", "int8_attention",
                                  "layer_norm"])
def test_kernel_tables_match_the_c_entry_points(name):
    """Each kernel module's ``ARGTYPES`` (what ``ops/build.py::load``
    binds) names every ``extern "C"`` entry point of the library's source,
    with its parameters' types in order, and nothing else."""
    import ctypes
    import importlib

    from clip_calibration_tpu_torch.ops import build
    module = importlib.import_module(
        "clip_calibration_tpu_torch.ops."
        + ("mha_qkv" if name.startswith("mha_qkv") else name))
    text = open(osp.join(build.CSRC_DIR, build.SOURCES[name])).read()
    entries = {
        fn: [_C_TYPES[re.sub(r"\s+|\w+$", "", p.strip())]
             for p in params.split(",")]
        for fn, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                     text)}
    assert entries, name
    table = module.ARGTYPES[name]
    assert {fn: [t.__name__ for t in types]
            for fn, types in table.items()} == entries
    assert all(t in (ctypes.c_void_p, ctypes.c_int, ctypes.c_float)
               for types in table.values() for t in types)
