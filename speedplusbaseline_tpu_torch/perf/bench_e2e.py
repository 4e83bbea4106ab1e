"""End-to-end training throughput from disk (the counterpart of the JAX
package's ``scripts/bench_e2e.py``).

Renders a fake SPEED+ dataset of 1920x1200 JPEGs with the port's generator
and labels it (``generate_fake_speedplus``, ``json2csv``), then times whole
epochs of the plain KRN trainer fed by the real loader: host decode, batch
assembly, the copy to the device and the train step together (224^2, batch
48, bf16, AdamW; no restyle, so neither hand-written kernel runs). Each
epoch ends in ``torch.cuda.synchronize()``; the first warms cuDNN and the
page cache, and the result is the best epoch after it.

    python -m speedplusbaseline_tpu_torch.perf.bench_e2e [num_images] [epochs]
        [cache|nocache|both] [root] [--no_cuda]

Defaults: 192 images, 3 epochs, both. ``nocache`` decodes full frames,
``cache`` first builds the RoI cache at 512 px (``data/cache.py``; its build
time is reported) and feeds the loader through it. ``root`` keeps the
dataset and the cache across runs. The loader uses the native decode core
where this host can build it (``native_available``; the line's ``native``
says which core ran), cv2 otherwise.

Prints one JSON line with the JAX keys (``host_cores``, ``num_workers``,
``e2e_from_disk_img_s``, ``e2e_cached_img_s``, ``cache_build_s`` when built
in this run) and the port's ``native`` and ``card``.
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os
import tempfile
import time
from typing import Optional, Sequence

import torch

from . import common
from ..config import default_cfg
from ..data.cache import build_cache
from ..data.loader import make_dataloader
from ..data.preprocess import json2csv
from ..data.synthetic import generate_fake_speedplus
from ..engine.state import TrainState
from ..engine.steps import make_krn_train_step
from ..native import native_available

CACHE_SIZE = 512


def generate(root: str, n_images: int, dev: torch.device) -> str:
    """``n_images`` synthetic train frames (and 4 test frames) of 1920x1200
    under ``root`` and their KRN CSV, labelled on ``dev``; the CSV's path."""
    generate_fake_speedplus(root, num_train=n_images, num_test=4, width=1920, height=1200,
                            domains=("synthetic",), device=dev)
    return json2csv(root, "speedplus", "synthetic", "train.json", "splits_krn/train.csv",
                    model_name="krn", device=dev)


def measure(root: str, cache_dir: str, epochs: int, dev: torch.device, native: bool, *,
            batch: int = common.BATCH, side: int = common.SIDE["krn"]) -> float:
    """Images a second of the plain KRN trainer over ``root``'s train CSV
    (through the cache when ``cache_dir``): the best epoch after the first
    (the only one when ``epochs`` is 1)."""
    cfg = default_cfg(dataroot=root, input_shape=(side, side), batch_size=batch,
                      num_workers=common.workers(), optimizer="adamw", fp16=True,
                      use_native_loader=native, cache_dir=cache_dir)
    loader = make_dataloader(cfg, dev, is_train=True, is_source=True)
    if len(loader) == 0:
        raise ValueError(f"{len(loader.dataset)} rows make no batch of {batch}")
    torch.manual_seed(0)
    state = TrainState.for_config(cfg, dev)
    step = make_krn_train_step(cfg, dev, style_aug=None)
    rates = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        n = 0
        t0 = time.perf_counter()
        for b in loader:
            sm = step(state, b, False)
            n += int(b["image"].shape[0])
        common.sync(dev)
        dt = time.perf_counter() - t0
        rates.append(n / dt)
        print(f"  epoch {epoch}: {n / dt:.1f} img/s ({n} imgs in {dt:.2f} s)", flush=True)
    losses = {k: float(v) for k, v in sm.items()}
    if not all(math.isfinite(v) for v in losses.values()):
        raise RuntimeError(f"non-finite loss {losses}")
    return max(rates[1:]) if len(rates) > 1 else rates[0]


def bench(n_images: int, epochs: int, mode: str, root: str, dev: torch.device, *,
          batch: int = common.BATCH, side: int = common.SIDE["krn"]) -> dict:
    """Render (unless ``root`` holds the CSV), cache (unless it holds the
    manifest) and measure ``mode``; prints and returns the JSON line."""
    train_csv = os.path.join(root, "speedplus", "synthetic", "splits_krn", "train.csv")
    if not os.path.exists(train_csv):
        print(f"generating {n_images} native-res JPEGs...", flush=True)
        generate(root, n_images, dev)

    cache_dir, cache_build_s = "", None
    if mode in ("cache", "both"):
        cache_dir = os.path.join(root, "roi_cache")
        manifest = os.path.join(cache_dir, "speedplus", "synthetic", "cache_manifest.csv")
        if not os.path.exists(manifest):
            t0 = time.perf_counter()
            build_cache(root, "speedplus", "synthetic", [train_csv], cache_dir,
                        cache_size=CACHE_SIZE)
            cache_build_s = time.perf_counter() - t0
            print(f"cache built in {cache_build_s:.1f}s (one-time)", flush=True)

    native = native_available()
    out = {"host_cores": os.cpu_count(), "num_workers": common.workers(), "native": native}
    kw = dict(batch=batch, side=side)
    if mode in ("nocache", "both"):
        print("from-disk, full-frame decode:", flush=True)
        out["e2e_from_disk_img_s"] = measure(root, "", epochs, dev, native, **kw)
    if mode in ("cache", "both"):
        print("from-disk, RoI cache:", flush=True)
        out["e2e_cached_img_s"] = measure(root, cache_dir, epochs, dev, native, **kw)
        if cache_build_s is not None:
            out["cache_build_s"] = cache_build_s
    return common.emit(out, dev)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("num_images", type=int, nargs="?", default=192)
    ap.add_argument("epochs", type=int, nargs="?", default=3)
    ap.add_argument("mode", nargs="?", default="both", choices=("cache", "nocache", "both"))
    ap.add_argument("root", nargs="?", default="")
    ap.add_argument("--no_cuda", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    dev = common.device(args.no_cuda)
    if args.root:
        os.makedirs(args.root, exist_ok=True)
        ctx = contextlib.nullcontext(args.root)
    else:
        ctx = tempfile.TemporaryDirectory()
    with ctx as root:
        return bench(args.num_images, args.epochs, args.mode, root, dev)


if __name__ == "__main__":
    main()
