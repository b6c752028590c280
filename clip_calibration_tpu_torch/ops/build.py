"""Builds the port's CUDA kernels from ``csrc/`` at first use.

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface (loaded with ``ctypes``; no PyTorch headers, so a build takes
seconds) under ``build/clip_calibration_tpu_torch/`` at the repository
root, all sources at once (one ``nvcc`` process each, started
together). A library is rebuilt when its source is newer. A failed build
raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import os
import os.path as osp
import shutil
import subprocess
import time
from typing import Dict

PKG_DIR = osp.dirname(osp.dirname(osp.abspath(__file__)))
CSRC_DIR = osp.join(PKG_DIR, "csrc")
BUILD_DIR = osp.join(osp.dirname(PKG_DIR), "build",
                     "clip_calibration_tpu_torch")

#: kernel name -> its source under csrc/
SOURCES = {"mha_qkv_fwd": "mha_qkv_fwd.cu",
           "mha_qkv_bwd": "mha_qkv_bwd.cu",
           "int8_matmul": "int8_matmul.cu",
           "int8_attention": "int8_attention.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and osp.exists(osp.join(home, "bin", "nvcc")):
            return osp.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the port's CUDA kernels are "
            "built from csrc/ at first use")
    return found


def library_path(name: str) -> str:
    return osp.join(BUILD_DIR, f"lib{name}.so")


def log_path(name: str) -> str:
    """The compiler's output of the last build (ptxas register and
    shared-memory counts included)."""
    return osp.join(BUILD_DIR, f"lib{name}.log")


def _stale(name: str) -> bool:
    lib = library_path(name)
    src = osp.join(CSRC_DIR, SOURCES[name])
    return not osp.exists(lib) or osp.getmtime(lib) < osp.getmtime(src)


def build() -> float:
    """Compile every stale kernel. Returns the seconds the build took
    (0.0 when nothing was stale)."""
    todo = [n for n in SOURCES if _stale(n)]
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = library_path(name) + f".tmp{os.getpid()}"
        log = open(log_path(name), "w")
        procs[name] = (tmp, log, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, osp.join(CSRC_DIR, SOURCES[name])],
            stdout=log, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, log, proc) in procs.items():
        proc.wait()
        log.close()
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n"
                          + open(log_path(name)).read())
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if it is stale."""
    lib = _loaded.get(name)
    if lib is None:
        build()
        lib = ctypes.CDLL(library_path(name))
        _loaded[name] = lib
    return lib
