"""ctypes binding of the native decode core ``csrc/speedloader.cpp`` (the
port's counterpart of ``speedplusbaseline_tpu/native/loader.py``, with its
argtypes).

The host C++ compiler (``$CXX``, else ``g++``) builds the core at first use,
with the JAX package's Makefile flags, into
``<repo>/build/native/<digest>/libspeedloader.so`` (``build/`` is
git-ignored). The digest covers the source, the flags, the compiler's
``--version`` and the host CPU (``-march=native`` compiles for it), so an
edited source, another compiler or another CPU rebuilds. The build
runs once, under a lock, before any loader thread calls the core; the
library is written under a temporary name and renamed, so a process never
loads a partial file.

Unlike the JAX binding, which falls back to cv2 when its core is not built,
``load`` raises ``RuntimeError`` with the compiler's message when the core
cannot be built or loaded: a run that asks for ``--use_native_loader`` gets
the native path or learns why not.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "speedloader.cpp")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "native")
# speedplusbaseline_tpu/native/Makefile's CXXFLAGS and LDFLAGS, in its order.
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LDFLAGS = ("-shared", "-ljpeg")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _run(cmd, what: str) -> str:
    """Run ``cmd``; its stdout, or RuntimeError with its message."""
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"{what}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{what}: {cmd[0]} exited with {proc.returncode}:\n"
                           f"{proc.stderr}{proc.stdout}")
    return proc.stdout


def _host_cpu() -> bytes:
    """The CPU's model name and feature flags, which ``-march=native`` reads."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.processor().encode()
    return b"\n".join(sorted({ln for ln in lines if ln.startswith((b"model name", b"flags"))}))


def build() -> str:
    """Compile the core unless this source, these flags and this compiler
    built it already; returns the library's path."""
    cxx = os.environ.get("CXX", "g++")
    what = f"cannot build the native decode core {SOURCE} with {cxx!r}"
    h = hashlib.sha256(" ".join(CXXFLAGS + LDFLAGS).encode())
    h.update(_run([cxx, "--version"], what).encode())
    h.update(_host_cpu())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
    path = os.path.join(out_dir, "libspeedloader.so")
    if not os.path.exists(path):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        _run([cxx, *CXXFLAGS, SOURCE, "-o", tmp, *LDFLAGS], what)
        os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The core's library, built on first use; RuntimeError if it cannot be
    built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:  # the loader's threads race to the first call
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise RuntimeError(f"cannot load the native decode core {path}: {e}") from e
            lib.decode_crop_resize_file.argtypes = [
                ctypes.c_char_p, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
            lib.decode_crop_resize_file.restype = ctypes.c_int
            lib.image_size_file.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                            ctypes.POINTER(ctypes.c_int)]
            lib.image_size_file.restype = ctypes.c_int
            _lib = lib
        return _lib


def native_available() -> bool:
    try:
        load()
    except RuntimeError:
        return False
    return True


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) from the JPEG header, without decoding."""
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    rc = load().image_size_file(path.encode(), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"image_size_file({path}) failed: {rc}")
    return w.value, h.value


def decode_crop_resize(path: str, crop_box, out_hw: Tuple[int, int]) -> np.ndarray:
    """Decode, crop and bilinear-resize in one call -> (H, W, 3) uint8 RGB.

    crop_box: (xmin, ymin, width, height) in original pixels, or None for the
    full frame. libjpeg decodes at a DCT-domain scale of 1/2, 1/4 or 1/8 when
    the crop still covers the output there.
    """
    h, w = (int(v) for v in out_hw)
    if h <= 0 or w <= 0:
        raise ValueError(f"out_hw must be positive, got {out_hw}")
    out = np.empty((h, w, 3), dtype=np.uint8)
    if crop_box is None:
        xmin = ymin = cw = ch = -1.0
    else:
        xmin, ymin, cw, ch = [float(v) for v in crop_box]
    rc = load().decode_crop_resize_file(path.encode(), xmin, ymin, cw, ch, w, h,
                                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise IOError(f"decode_crop_resize_file({path}) failed: {rc}")
    return out
