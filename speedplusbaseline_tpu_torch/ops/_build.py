"""Build the hand-written CUDA kernels in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, into
``<repo>/build/kernels/<digest>/`` (``build/`` is git-ignored). The digest
covers every source, the flags and ``nvcc --version``, so an edited source
or another toolkit rebuilds and an unchanged one is reused. All sources compile in parallel, one ``nvcc`` each.
``-Xptxas -v`` output (registers, shared memory, spills) is kept beside each
library as ``<name>.log``.

``load`` declares each library's C signatures once, from ``SIGNATURES``
(every entry point returns a ``cudaError_t`` as int). ``launches`` counts
kernel launches per wrapper; each wrapper adds one where it launches its
kernel and nowhere else. When ``SPEEDPLUS_LAUNCH_LOG`` names a file, the
process appends its counts there as one JSON line at exit, so that a caller
can read the launches of a CLI it ran as a subprocess.
"""
from __future__ import annotations

import atexit
import ctypes
import functools
import hashlib
import json
import os
import shutil
import subprocess
import sys
import threading
from typing import Dict

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
SOURCES = ("instancenorm", "resblock")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# {library: {entry point: argtypes}}, matching the extern "C" declarations.
SIGNATURES = {
    "instancenorm": {"gk_in_cluster": [_P] * 4 + [_I] * 8 + [_F, _I, _P],
                     "gk_in_two_pass": [_P] * 6 + [_I] * 8 + [_F, _I, _P],
                     "gk_in_max_active_clusters": [_I] * 4},
    "resblock": {"gk_resblock": [_P] * 16 + [_I] * 5 + [_F, _P],
                 "gk_resblock_tile_pixels": [],
                 "gk_resblock_wsplit_bytes": [_I],
                 "gk_resblock_smem_bytes": [_I, _I]},
}

launches: Dict[str, int] = {"instance_norm_film": 0, "ghiasi_resblock": 0}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


LAUNCH_LOG_ENV = "SPEEDPLUS_LAUNCH_LOG"


@atexit.register
def _write_launch_log() -> None:
    path = os.environ.get(LAUNCH_LOG_ENV)
    if path:
        with open(path, "a") as f:
            f.write(json.dumps({"argv": sys.argv, "launches": launches}) + "\n")


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


@functools.lru_cache(maxsize=None)
def _nvcc_version() -> str:
    return subprocess.run([_nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout


def build_dir() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(_nvcc_version().encode())
    for fname in sorted(os.listdir(CSRC_DIR)):
        if fname.endswith((".cu", ".cuh")):
            h.update(fname.encode())
            with open(os.path.join(CSRC_DIR, fname), "rb") as f:
                h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def build_all() -> Dict[str, str]:
    """Compile every missing library in parallel; return {name: path}."""
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    paths = {n: os.path.join(out_dir, f"lib{n}.so") for n in SOURCES}
    todo = [n for n in SOURCES if not os.path.exists(paths[n])]
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = f"{paths[n]}.{os.getpid()}.tmp"
        log = open(os.path.join(out_dir, f"{n}.log"), "w")
        procs[n] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp,
             os.path.join(CSRC_DIR, f"{n}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for n, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(n)
        else:
            os.replace(tmp, paths[n])  # atomic: no reader sees a partial .so
    if failed:
        logs = "\n".join(build_log(n) for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return paths


def build_log(name: str) -> str:
    path = os.path.join(build_dir(), f"{name}.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(build_all()[name])
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return _libs[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
