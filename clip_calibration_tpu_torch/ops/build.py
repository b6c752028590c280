"""Builds the port's CUDA kernels from ``csrc/`` at first use.

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface (loaded with ``ctypes``; no PyTorch headers, so a build takes
seconds) under ``build/clip_calibration_tpu_torch/`` at the repository
root, all sources at once (one ``nvcc`` process each, started
together). A library is rebuilt when its source, or any shared header
``csrc/*.cuh``, is newer. A failed build
raises with the compiler's output; nothing falls back.

``load`` also binds the C ABI, once, from the table each kernel's module
keeps (``ARGTYPES``: library -> entry point -> ctypes argument types).
"""

from __future__ import annotations

import ctypes
import glob
import os
import os.path as osp
import re
import shutil
import subprocess
import time
from typing import Dict, List

import torch

PKG_DIR = osp.dirname(osp.dirname(osp.abspath(__file__)))
CSRC_DIR = osp.join(PKG_DIR, "csrc")
BUILD_DIR = osp.join(osp.dirname(PKG_DIR), "build",
                     "clip_calibration_tpu_torch")

#: kernel name -> its source under csrc/
SOURCES = {"mha_qkv_fwd": "mha_qkv_fwd.cu",
           "mha_qkv_bwd": "mha_qkv_bwd.cu",
           "int8_matmul": "int8_matmul.cu",
           "int8_attention": "int8_attention.cu",
           "layer_norm": "layer_norm.cu"}

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


def _kernel_name(mangled: str) -> str:
    """``..15mha_qkv_fwd_f32ILi64ELi32EE..`` -> ``mha_qkv_fwd_f32<64, 32>``
    (the kernel and its integer or bool template arguments)."""
    m = re.search(r"(?<=\d)((?:mha|int8|layer_norm)_\w*?)"
                  r"(?:I((?:L[a-z]+\d+E)+)E|E)",
                  mangled)
    if m is None:
        return mangled
    if m.group(2) is None:
        return m.group(1)
    return f"{m.group(1)}<{', '.join(re.findall(r'(\d+)E', m.group(2)))}>"


def ptxas_report(name: str) -> dict:
    """Per kernel instance of the last build of ``name``: registers and
    bytes spilled (stores + loads), from ptxas's ``-v`` lines in the
    build log."""
    out, fn = {}, None
    for line in open(log_path(name)):
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = _kernel_name(m.group(1))
            out.setdefault(fn, {"registers": None, "spill_bytes": 0})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn is not None:
            out[fn]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = _kernel_name(m.group(1))
            out.setdefault(fn, {"registers": None, "spill_bytes": 0})
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            out[fn]["registers"] = int(m.group(1))
    return out


def _stale(name: str) -> bool:
    """The library is missing, or older than its source or any shared
    header (``csrc/*.cuh``, which every source may include)."""
    lib = library_path(name)
    if not osp.exists(lib):
        return True
    inputs = [osp.join(CSRC_DIR, SOURCES[name])] + glob.glob(
        osp.join(CSRC_DIR, "*.cuh"))
    return osp.getmtime(lib) < max(osp.getmtime(p) for p in inputs)


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


def bind(lib: ctypes.CDLL, argtypes: Dict[str, List]) -> ctypes.CDLL:
    """``lib`` with each C entry point of ``argtypes`` (entry -> ctypes
    argument types; pointers as ``c_void_p``, or ctypes would cut them to
    32-bit ints) typed, returning an int."""
    for entry, types in argtypes.items():
        fn = getattr(lib, entry)
        fn.argtypes = types
        fn.restype = ctypes.c_int
    return lib


def load(name: str, argtypes: Dict[str, Dict[str, List]]) -> ctypes.CDLL:
    """The kernel's shared library, built first if it is stale, its entry
    points bound at first load to ``argtypes[name]`` (the kernel module's
    ``ARGTYPES``)."""
    lib = _loaded.get(name)
    if lib is None:
        build()
        lib = _loaded[name] = bind(ctypes.CDLL(library_path(name)),
                                   argtypes[name])
    return lib


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device, as the launchers take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(entry: str, err: int) -> None:
    """Raises when a launcher returned a ``cudaError_t`` other than 0."""
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError_t {err}")
