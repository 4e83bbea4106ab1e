"""Progress reporting — reference src/utils/utils.py:44-105 equivalents.

Same AverageMeter val/avg/unit contract and the same in-place progress-bar
format, so the console UX matches the reference byte-for-byte.
"""
from __future__ import annotations

import logging
import sys


class AverageMeter:
    """Computes and stores the average and current value (utils.py:44-61)."""

    def __init__(self, unit: str = "-"):
        self.unit = unit
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0
        self.sum = 0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count if self.count != 0 else 0


def setup_logger(phase: str = "train"):
    """stdout INFO logger (utils.py:63-79)."""
    head = "%(asctime)-15s %(message)s"
    logging.basicConfig(format=head, datefmt="%Y/%m/%d %H:%M:%S")
    logger = logging.getLogger()
    logger.setLevel(logging.INFO)
    return logger


def report_progress(epoch, lr, epoch_iter, epoch_size, time,
                    is_train: bool = True, **kwargs):
    """In-place progress bar (utils.py:81-105): epoch, lr, iter, per-batch ms
    (val/avg) and arbitrary named meters."""
    blength = 30
    percent = float(epoch_iter / epoch_size)
    arrow = "█" * int(round(percent * blength))
    spaces = " " * (blength - len(arrow))
    msg = "\rTraining " if is_train else "\rTesting "

    msg += (
        "{epoch:03d} (lr: {lr:.5f}): {it:04d}/{esize:04d} "
        "[{prog}{pct:03d}%] [{tv:.0f} ({ta:.0f}) ms] "
    ).format(epoch=epoch, lr=lr, it=epoch_iter, esize=epoch_size,
             tv=time.val, ta=time.avg, prog=arrow + spaces,
             pct=round(percent * 100))

    for key, item in kwargs.items():
        if item is not None:
            msg += "{}: {:.2f} ({:.2f}) [{}] ".format(key, item.val, item.avg, item.unit)

    sys.stdout.write(msg)
    sys.stdout.flush()
    if epoch_iter == epoch_size:
        sys.stdout.write("\n")
        sys.stdout.flush()
