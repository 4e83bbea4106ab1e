"""Scalar summaries: TensorBoard events when available, JSONL always.

The reference logs train/valid scalars to TensorBoard (train.py:65,
trainer.py:110-112, inference.py:113-117). We write the same tags through
torch.utils.tensorboard when importable and mirror every scalar to
``scalars.jsonl`` in the log dir so results are machine-readable without TB.
"""
from __future__ import annotations

import json
import os
import time


class SummaryWriter:
    def __init__(self, logdir: str):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "scalars.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter as TBWriter

            self._tb = TBWriter(logdir)
        except ImportError:  # tensorboard is optional
            pass

    def add_scalar(self, tag: str, value, step: int):
        value = float(value)
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": value, "step": int(step), "ts": time.time()}
        ) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
