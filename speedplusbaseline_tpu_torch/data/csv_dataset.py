"""KRN CSV-row dataset (a copy of ``speedplusbaseline_tpu/data/
csv_dataset.py::KRNDataset``; reference Park2019KRNDataset.py).

CSV schema (reference preprocess.py:104-114):
  imagepath, xmin, xmax, ymin, ymax, q0..q3, t1..t3, kx1, ky1, ..., kxK, kyK
with the image path relative to ``{dataroot}/{dataname}``. CSV selection
(Park2019KRNDataset.py:52-66):
  train + source  -> {train_domain}/splits_krn/{train_csv}
  otherwise       -> {test_domain}/splits_krn/{test_csv}

Per-sample randomness is a Philox stream keyed by (seed, epoch, index), so
any worker arrangement, and the JAX package, give the same crops.
"""
from __future__ import annotations

import logging
import os.path as osp
from typing import Dict

import numpy as np
import pandas as pd

from .transforms import random_crop

logger = logging.getLogger(__name__)


def _imread(path: str) -> np.ndarray:
    """Decode an image to RGB uint8 (H, W, 3)."""
    try:
        import cv2
    except ImportError:  # pragma: no cover
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"failed to decode {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class KRNDataset:
    def __init__(self, cfg, is_train: bool = True, is_source: bool = True,
                 load_labels: bool = True):
        if cfg.model_name != "krn":
            raise NotImplementedError(f"dataset for model {cfg.model_name!r} "
                                      "is not ported")
        if is_train and is_source and not load_labels:
            raise ValueError("the labeled source stream needs load_labels=True")
        if is_train and not is_source and load_labels:
            raise ValueError("the DANN target stream is unlabeled")
        self.is_train = is_train
        self.load_labels = load_labels
        self.root = osp.join(cfg.dataroot, cfg.dataname)
        self.input_shape = tuple(cfg.input_shape)
        self.seed = cfg.seed
        self.num_keypts = cfg.num_keypoints
        if is_train and is_source:
            csvfile = osp.join(self.root, cfg.train_domain, "splits_krn",
                               cfg.train_csv)
        else:
            csvfile = osp.join(self.root, cfg.test_domain, "splits_krn",
                               cfg.test_csv)
        logger.info("%s from %s", "Training" if is_train else "Testing", csvfile)
        self.csv = pd.read_csv(csvfile, header=None)

    def __len__(self):
        return len(self.csv)

    def rng_for(self, epoch: int, index: int) -> np.random.Generator:
        return np.random.Generator(
            np.random.Philox(key=np.uint64([(self.seed << 20) + epoch, index])))

    def __getitem__(self, index: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        row = self.csv.iloc[index]
        imgpath = osp.join(self.root, str(row[0]).strip())
        bbox = np.array(row[1:5], dtype=np.float32)
        if self.is_train and self.load_labels:
            keypts = np.array(row[12:12 + 2 * self.num_keypts], dtype=np.float32)
            keypts = np.reshape(keypts, (self.num_keypts, 2)).T  # (2, K)
        else:
            keypts = np.zeros((2, self.num_keypts), dtype=np.float32)

        image = _imread(imgpath)
        crop, bbox, keypts = random_crop(self.rng_for(epoch, index), image, bbox,
                                         keypts, self.input_shape, self.is_train)
        if self.is_train:
            if self.load_labels:
                return {"image": crop, "keypts": keypts}
            return {"image": crop}
        q_gt = np.array(row[5:9], dtype=np.float32)
        t_gt = np.array(row[9:12], dtype=np.float32)
        return {"image": crop, "bbox": bbox, "q_gt": q_gt, "t_gt": t_gt}
