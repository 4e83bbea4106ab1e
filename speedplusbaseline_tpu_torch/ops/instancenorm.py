"""Fused InstanceNorm + FiLM (+ ReLU) on (B, H, W, C) tensors.

Counterpart of ``speedplusbaseline_tpu/ops/instancenorm.py`` (the plain
version) and ``ops/pallas_instancenorm.py`` (the TPU kernel, which
``csrc/instancenorm.cu`` replaces).

* ``instance_norm_film_plain``: centered-variance PyTorch version. The CPU
  tests use it, and ``chip_smoke.py`` holds the kernel to it.
* ``plan``: which of the kernel's two paths a shape takes, and how it is cut.
  The wrapper follows it and nothing else.
* ``instance_norm_film``: the wrapper. A CPU tensor takes the plain version;
  a CUDA tensor launches the planned path or raises. It is differentiable:
  under grad mode, when x, gamma or beta requires grad, the call goes
  through ``_vjp.PlainVJP`` (forward: the same call; backward: the VJP of
  the plain version, recomputed), on either path.

Layout is the JAX functions' (B, H, W, C), contiguous: a channels_last NCHW
tensor ``.permute(0, 2, 3, 1)`` is exactly that, with no copy. torch
InstanceNorm2d semantics: eps=1e-5, biased variance.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from . import _build
from ._vjp import PlainVJP, needs_grad

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ELEM = {torch.float32: 4, torch.bfloat16: 2}

# Card limits of sm_90 (H100): the dynamic shared memory one block may take;
# one SM's shared memory, of which the system keeps 1 KB per resident block;
# the largest (non-portable) cluster.
SMEM_PER_BLOCK = 232_448
SMEM_PER_SM = 233_472
SMEM_RESERVED = 1024
MAX_CLUSTER = 16
# The cluster kernel's block sizes (csrc/instancenorm.cu MAX_THREADS) and the
# bytes ahead of its slab (BAR_BYTES).
_CLUSTER_THREADS = range(256, 513, 32)
_BAR_BYTES = 128
# Two-pass path: aim for about _TARGET_BLOCKS blocks (of 256 threads) per
# launch and chunks of at least _MIN_ROWS rows.
_TARGET_BLOCKS = 1024
_MIN_ROWS = 64

# Wrapper calls by path, beside ``_build.launches["instance_norm_film"]``.
path_calls: Dict[str, int] = {"cluster": 0, "two_pass": 0}


@dataclass(frozen=True)
class Plan:
    """One call's path. ``cluster``: K blocks of ``threads`` per sample, each
    holding ``block_bytes`` of x in ``smem_bytes`` of shared memory.
    ``two_pass``: ``ct`` lanes over channel vectors of ``vec`` elements,
    H*W cut into ``nchunks`` chunks of ``rows_per_chunk`` rows."""
    path: str
    vec: int
    threads: int = 0
    k: int = 0
    block_bytes: int = 0
    smem_bytes: int = 0
    ct: int = 0
    rows_per_chunk: int = 0
    nchunks: int = 0


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' arithmetic: f32, or float64 for float64 input
    (the CPU tests' float64 steps; the kernels take f32 and bf16 only)."""
    return torch.promote_types(dtype, torch.float32)


def instance_norm_film_plain(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
                             beta: Optional[torch.Tensor] = None, eps: float = 1e-5,
                             relu: bool = False) -> torch.Tensor:
    """x: (B, H, W, C); gamma/beta: (B, C) or None. Same shape/dtype as x."""
    xf = x.to(compute_dtype(x.dtype))
    mean = xf.mean(dim=(1, 2), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 2), keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if gamma is not None:
        y = y * gamma[:, None, None, :].to(xf.dtype)
    if beta is not None:
        y = y + beta[:, None, None, :].to(xf.dtype)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def cluster_threads(channels: int, vec: int) -> int:
    """The cluster kernel's block size for C channels: the first whose
    threads * vec elements are a whole number of rows, so that every thread
    holds the same channels in every sweep; 0 if none is."""
    return next((t for t in _CLUSTER_THREADS if t * vec % channels == 0), 0)


def cluster_smem_bytes(block_bytes: int, threads: int, vec: int, channels: int) -> int:
    """Dynamic shared memory of one cluster block (csrc/instancenorm.cu)."""
    return _BAR_BYTES + block_bytes + 4 * (threads * vec + 5 * channels)


def chunking(batch: int, rows: int, ctiles: int):
    """(rows_per_chunk, nchunks) for the two-pass split over H*W."""
    want = max(1, -(-_TARGET_BLOCKS // (batch * ctiles)))
    nchunks = max(1, min(want, rows // _MIN_ROWS))
    per = -(-rows // nchunks)
    return per, -(-rows // per)


def plan(shape, dtype: torch.dtype,
         cluster_fits: Callable[[int, int, int], bool] = lambda k, threads, smem: True) -> Plan:
    """The path of one call on (B, H, W, C) ``shape`` in ``dtype``.

    One read of x (``cluster``) where one sample's slab splits into K <= 16
    ranges on 16-byte bounds that each fit a block's shared memory; the
    smallest such K that leaves two blocks on an SM (so that one block's
    store overlaps another's load), else the smallest that fits at all.
    ``cluster_fits(k, threads, smem_bytes)`` says whether the card can run
    such a cluster (the wrapper asks ``cudaOccupancyMaxActiveClusters``);
    the default takes the limits above as the whole truth. Every other shape
    goes ``two_pass``.
    """
    B, H, W, C = shape
    elem = _ELEM[dtype]
    vec = 16 // elem
    slab = H * W * C * elem
    threads = cluster_threads(C, vec)
    if threads:
        cands = []
        for k in range(1, MAX_CLUSTER + 1):
            if slab % (16 * k):
                continue
            smem = cluster_smem_bytes(slab // k, threads, vec, C)
            if smem <= SMEM_PER_BLOCK:
                two_per_sm = 2 * (smem + SMEM_RESERVED) <= SMEM_PER_SM
                cands.append((not two_per_sm, k, smem))
        for _, k, smem in sorted(cands):
            if cluster_fits(k, threads, smem):
                return Plan("cluster", vec, threads=threads, k=k, block_bytes=slab // k,
                            smem_bytes=smem)
    vec = vec if C * elem % 16 == 0 else 1
    ct = min(32, 1 << max(0, math.ceil(math.log2(-(-C // vec)))))
    per, nchunks = chunking(B, H * W, -(-C // (ct * vec)))
    return Plan("two_pass", vec, ct=ct, rows_per_chunk=per, nchunks=nchunks)


def check_x(x: torch.Tensor, what: str) -> None:
    """Raise unless x is a contiguous (B, H, W, C) float32/bfloat16 CUDA tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous (B, H, W, C) "
                         f"float32/bfloat16 tensor, got {x.dtype} {tuple(x.shape)} "
                         f"strides {x.stride()}")


def check_f32(t: torch.Tensor, name: str, shape, device: torch.device) -> None:
    """Raise unless t is a contiguous float32 tensor of ``shape`` on ``device``."""
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 tensor on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")


@functools.lru_cache(maxsize=None)
def max_active_clusters(device_index: int, dtype: torch.dtype, k: int, threads: int,
                        smem_bytes: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the cluster kernel on the card."""
    with torch.cuda.device(device_index):
        n = _build.load("instancenorm").gk_in_max_active_clusters(_DTYPES[dtype], k, threads,
                                                                 smem_bytes)
    _build.check(max(0, -n), "cudaOccupancyMaxActiveClusters")
    return n


def plan_on_card(shape, dtype: torch.dtype, device: torch.device) -> Plan:
    """``plan`` with the card's own answer to which clusters fit."""
    return _plan_on_card(tuple(shape), dtype, torch.device(device).index or 0)


@functools.lru_cache(maxsize=None)
def _plan_on_card(shape, dtype: torch.dtype, index: int) -> Plan:
    return plan(shape, dtype, lambda k, threads, smem:
                max_active_clusters(index, dtype, k, threads, smem) > 0)


def instance_norm_film(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
                       beta: Optional[torch.Tensor] = None, eps: float = 1e-5,
                       relu: bool = False) -> torch.Tensor:
    """Instance norm over H, W per (sample, channel), optional FiLM and ReLU.

    x: (B, H, W, C) float32 or bfloat16; gamma, beta: (B, C) float32 or None.
    """
    if needs_grad((x, gamma, beta)):
        return PlainVJP.apply(_instance_norm_film, instance_norm_film_plain,
                              {"eps": eps, "relu": relu}, x, gamma, beta)
    return _instance_norm_film(x, gamma, beta, eps, relu)


def _instance_norm_film(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
                        beta: Optional[torch.Tensor] = None, eps: float = 1e-5,
                        relu: bool = False) -> torch.Tensor:
    if x.device.type == "cpu":
        return instance_norm_film_plain(x, gamma, beta, eps, relu)
    check_x(x, "instance_norm_film")
    if x.data_ptr() % 16:
        raise ValueError("instance_norm_film: x must be 16-byte aligned (bulk copies, "
                         "16-byte loads)")
    B, H, W, C = x.shape
    for name, v in (("gamma", gamma), ("beta", beta)):
        if v is not None:
            check_f32(v, name, (B, C), x.device)
    p = plan_on_card(tuple(x.shape), x.dtype, x.device)
    lib = _build.load("instancenorm")
    y = torch.empty_like(x)
    g = gamma.data_ptr() if gamma is not None else None
    b = beta.data_ptr() if beta is not None else None
    dt, stream = _DTYPES[x.dtype], _build.stream_ptr(x.device)
    if p.path == "cluster":
        err = lib.gk_in_cluster(x.data_ptr(), y.data_ptr(), g, b, B, H * W, C, p.k,
                                p.block_bytes, p.threads, p.smem_bytes, dt, float(eps),
                                int(relu), stream)
    else:
        part = torch.empty((B, p.nchunks, C, 2), device=x.device, dtype=torch.float32)
        scale_shift = torch.empty((2, B, C), device=x.device, dtype=torch.float32)
        err = lib.gk_in_two_pass(x.data_ptr(), y.data_ptr(), part.data_ptr(),
                                 scale_shift.data_ptr(), g, b, B, H * W, C, p.rows_per_chunk,
                                 p.nchunks, p.vec, p.ct, dt, float(eps), int(relu), stream)
    _build.check(err, f"instance_norm_film ({p.path} path)")
    _build.launches["instance_norm_film"] += 1
    path_calls[p.path] += 1
    return y


def bytes_moved(shape, dtype: torch.dtype, film: bool) -> int:
    """Compulsory traffic of one call: read x, write y, read gamma/beta."""
    B, H, W, C = shape
    elem = torch.finfo(dtype).bits // 8
    return 2 * B * H * W * C * elem + (2 * B * C * 4 if film else 0)


def flops(shape) -> int:
    """Arithmetic of one call: sum, centered square, scale+shift (+relu)."""
    return 6 * math.prod(shape)
