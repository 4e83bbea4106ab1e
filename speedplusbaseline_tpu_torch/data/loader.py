"""Threaded prefetching loader feeding device-resident batches (the port's
own counterpart of ``speedplusbaseline_tpu/data/loader.py``).

* decode/crop runs in a thread pool (cv2 releases the GIL during decode and
  resize);
* each batch is stacked into contiguous numpy arrays, wrapped in pinned
  host memory when the target is a GPU, and copied with ``non_blocking=True``
  so the copy overlaps the device's work;
* the shuffle is a per-epoch permutation from a (seed, epoch) Philox stream,
  the JAX package's, so both give the same batches.

Training drops a short last batch; evaluation keeps it as a shorter batch
(the JAX package pads it to a static shape and masks the padding; torch
needs no static shape), so every test row is scored once, in CSV order.

Under data parallelism (``world`` ranks), ``batch_size`` is the global
batch: every rank walks the same index order and loads only its contiguous
rows of each global batch, as the JAX loader's ``_local_slice``. An eval
batch is padded (with copies of its first row) up to a multiple of
``world`` rows, so every rank holds as many, and carries a ``valid`` mask
of its real rows, as the JAX loader's ``_local_pad_target``.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch

from ..parallel.mesh import rank_rows, rank_world


def _stack(samples) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class DataLoader:
    def __init__(self, dataset, batch_size: int, device: torch.device,
                 shuffle: bool = True, num_workers: int = 4, prefetch: int = 2,
                 seed: int = 2021, drop_last: bool = True, rank: int = 0, world: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.drop_last = drop_last
        self.rank, self.world = rank, world
        self.epoch = 0

    def __len__(self):
        if self.drop_last:
            return len(self.dataset) // self.batch_size
        return -(-len(self.dataset) // self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def index_order(self) -> np.ndarray:
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n)
        rng = np.random.Generator(np.random.Philox(key=np.uint64(
            [(self.seed << 20) + self.epoch, 0x5EEDF00D])))
        return rng.permutation(n)

    def local_rows(self, idxs: np.ndarray):
        """This rank's indices of a global batch ``idxs``, and the ``valid``
        mask of its rows for an eval batch under data parallelism (None
        otherwise)."""
        if self.world == 1:
            return idxs, None
        if self.drop_last:
            return idxs[rank_rows(len(idxs), self.rank, self.world)], None
        target = -(-self.batch_size // self.world) * self.world
        padded = np.concatenate([idxs, np.full(target - len(idxs), idxs[0])])
        rows = rank_rows(target, self.rank, self.world)
        return padded[rows], (np.arange(target)[rows] < len(idxs)).astype(np.float32)

    def host_batches(self) -> Iterator[Dict[str, torch.Tensor]]:
        """Batches as host tensors (pinned when the target is a GPU), made
        ahead by a producer thread."""
        order = self.index_order()
        nb = len(self)
        epoch = self.epoch
        pin = self.device.type == "cuda"
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        error: list = []

        def produce():
            # Always enqueue the sentinel, or the consumer blocks forever; an
            # error re-raises on the consumer side.
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(nb):
                        if stop.is_set():
                            return
                        idxs, valid = self.local_rows(
                            order[b * self.batch_size:(b + 1) * self.batch_size])
                        samples = list(pool.map(
                            lambda i: self.dataset.__getitem__(int(i), epoch=epoch),
                            idxs))
                        batch = {k: torch.from_numpy(v)
                                 for k, v in _stack(samples).items()}
                        if valid is not None:
                            batch["valid"] = torch.from_numpy(valid)
                        if pin:
                            batch = {k: v.pin_memory() for k, v in batch.items()}
                        out_q.put(batch)
            except BaseException as e:  # noqa: BLE001 -- re-raised by the consumer
                error.append(e)
            finally:
                out_q.put(None)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    break
                yield batch
            if error:
                raise error[0]
        finally:
            stop.set()
            while thread.is_alive():  # drain so the producer can exit
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    thread.join(timeout=0.1)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        for batch in self.host_batches():
            yield {k: v.to(self.device, non_blocking=True) for k, v in batch.items()}


def make_dataloader(cfg, device: torch.device, is_train: bool = True, is_source: bool = True,
                    load_labels: bool = True) -> DataLoader:
    """Loader of the reference's build.py:45-66. Train: cfg.batch_size,
    shuffled, the short last batch dropped; the labelled source stream by
    default, and with ``is_source=False, load_labels=False`` DANN's
    unlabelled target stream (the test domain's CSV, images only). Eval (the
    test CSV): cfg.eval_batch_size, CSV order, half the workers, the short
    last batch kept (the reference evaluates batch 1; per-image results are
    the same). Under data parallelism, this rank's rows of each."""
    from .csv_dataset import build_dataset

    rank, world = rank_world() or (0, 1)
    if is_train:
        return DataLoader(build_dataset(cfg, True, is_source, load_labels), cfg.batch_size,
                          device, shuffle=True, num_workers=cfg.num_workers,
                          seed=cfg.seed, rank=rank, world=world)
    return DataLoader(build_dataset(cfg, is_train=False, is_source=False), cfg.eval_batch_size,
                      device, shuffle=False, num_workers=max(1, cfg.num_workers // 2),
                      seed=cfg.seed, drop_last=False, rank=rank, world=world)
