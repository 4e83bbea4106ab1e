"""CSV-row datasets (a copy of ``speedplusbaseline_tpu/data/csv_dataset.py``
``KRNDataset``, ``SPNDataset`` and ``build_dataset``; reference
Park2019KRNDataset.py, SPNDataset.py).

CSV schema (reference preprocess.py:104-114):
  imagepath, xmin, xmax, ymin, ymax, q0..q3, t1..t3, then
    KRN: kx1, ky1, ..., kxK, kyK           (pixel coords)
    SPN: class_1..class_n, weight_1..weight_n
with the image path relative to ``{dataroot}/{dataname}``. CSV selection
(Park2019KRNDataset.py:52-66):
  train + source  -> {train_domain}/splits_{model_name}/{train_csv}
  otherwise       -> {test_domain}/splits_{model_name}/{test_csv}

Per-sample randomness is a Philox stream keyed by (seed, epoch, index), so
any worker arrangement, and the JAX package, give the same crops.

``--cache_dir`` swaps each frame for its crop in the RoI cache
(data/cache.py) when the domain has a manifest: the box and keypoints are
mapped into cache coordinates, the eval crop box is mapped back to original
pixels for the pose solver, and SPN returns the original CSV box. Without a
manifest the dataset warns and decodes full frames, as the JAX package does.
``--use_native_loader`` decodes, crops and resizes in one call of the native
core (native/loader.py), which raises RuntimeError when it cannot be built;
the JAX package warns and falls back to cv2 there.
"""
from __future__ import annotations

import logging
import os.path as osp
from typing import Dict

import numpy as np
import pandas as pd

from .cache import load_manifest, to_cache_coords, to_original_coords
from .transforms import crop_params, random_crop, resize_crop

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


class _CSVDataset:
    def __init__(self, cfg, is_train: bool, is_source: bool):
        self.is_train = is_train
        self.root = osp.join(cfg.dataroot, cfg.dataname)
        self.input_shape = tuple(cfg.input_shape)
        self.seed = cfg.seed
        if is_train and is_source:
            domain, csv = cfg.train_domain, cfg.train_csv
        else:
            domain, csv = cfg.test_domain, cfg.test_csv
        csvfile = osp.join(self.root, domain, "splits_" + cfg.model_name, csv)
        logger.info("%s from %s", "Training" if is_train else "Testing", csvfile)
        self.csv = pd.read_csv(csvfile, header=None)

        self.use_native = bool(cfg.use_native_loader)
        if self.use_native:
            from ..native import load

            load()  # build it here, once, before the loader's threads call it
        self.cache = None
        if cfg.cache_dir:
            self.cache = load_manifest(cfg.cache_dir, cfg.dataname, domain)
            if self.cache is None:
                logger.warning("--cache_dir set but no manifest for domain %s under %s "
                               "(build it with python -m speedplusbaseline_tpu_torch."
                               "cache_dataset); decoding full frames", domain, cfg.cache_dir)
            else:
                logger.info("RoI cache: %d images (%s/%s)", len(self.cache), cfg.cache_dir,
                            domain)

    def __len__(self):
        return len(self.csv)

    def rng_for(self, epoch: int, index: int) -> np.random.Generator:
        return np.random.Generator(
            np.random.Philox(key=np.uint64([(self.seed << 20) + epoch, index])))

    def _row(self, index: int):
        """(csv row, image path, csv bbox float32 (4,), cache entry or None):
        the cached image's path where the cache holds the row's image."""
        row = self.csv.iloc[index]
        rel = str(row[0]).strip()
        entry = self.cache.get(rel) if self.cache is not None else None
        imgpath = entry[0] if entry is not None else osp.join(self.root, rel)
        return row, imgpath, np.array(row[1:5], dtype=np.float32), entry

    @staticmethod
    def _eval_sample(crop, bbox, row) -> Dict[str, np.ndarray]:
        return {"image": crop, "bbox": bbox, "q_gt": np.array(row[5:9], dtype=np.float32),
                "t_gt": np.array(row[9:12], dtype=np.float32)}


class KRNDataset(_CSVDataset):
    def __init__(self, cfg, is_train: bool = True, is_source: bool = True,
                 load_labels: bool = True):
        if is_train and is_source and not load_labels:
            raise ValueError("the labeled source stream needs load_labels=True")
        if is_train and not is_source and load_labels:
            raise ValueError("the DANN target stream is unlabeled")
        super().__init__(cfg, is_train, is_source)
        self.load_labels = load_labels
        self.num_keypts = cfg.num_keypoints

    def __getitem__(self, index: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        row, imgpath, bbox, entry = self._row(index)
        if self.is_train and self.load_labels:
            keypts = np.array(row[12:12 + 2 * self.num_keypts], dtype=np.float32)
            keypts = np.reshape(keypts, (self.num_keypts, 2)).T  # (2, K)
        else:
            keypts = np.zeros((2, self.num_keypts), dtype=np.float32)
        if entry is not None:
            bbox, keypts = to_cache_coords(entry, bbox, keypts)

        rng = self.rng_for(epoch, index)
        if self.use_native:
            from ..native import decode_crop_resize, image_size

            w, h = image_size(imgpath)
            cxmin, cxmax, cymin, cymax = crop_params(rng, bbox, w, h, self.is_train)
            crop = decode_crop_resize(imgpath, (cxmin, cymin, cxmax - cxmin, cymax - cymin),
                                      self.input_shape)
            bbox = np.array([cxmin, cxmax, cymin, cymax], dtype=np.float32)
            keypts = keypts.copy()
            keypts[0] = (keypts[0] - cxmin) / max(cxmax - cxmin, 1)
            keypts[1] = (keypts[1] - cymin) / max(cymax - cymin, 1)
        else:
            crop, bbox, keypts = random_crop(rng, _imread(imgpath), bbox, keypts,
                                             self.input_shape, self.is_train)
        if self.is_train:
            if self.load_labels:
                return {"image": crop, "keypts": keypts}
            return {"image": crop}
        if entry is not None:
            # The pose solver denormalizes keypoints with the crop box in
            # original camera pixels (inference.py:63-78).
            bbox = to_original_coords(entry, bbox)
        return self._eval_sample(crop, bbox, row)


class SPNDataset(_CSVDataset):
    """Train rows give n-hot ``y_classes`` (1/num_neighbors at each of the
    row's classes) and ``y_weights`` (the row's weights there) over
    num_classes (SPNDataset.py:83-94); eval rows give the csv bbox, which
    the position solver takes, unclamped."""

    def __init__(self, cfg, is_train: bool = True, is_source: bool = True):
        super().__init__(cfg, is_train, is_source)
        self.num_classes = cfg.num_classes
        self.num_neighbors = cfg.num_neighbors

    def __getitem__(self, index: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        row, imgpath, bbox, entry = self._row(index)
        # The crop is taken in the cached image's frame; the CSV box is returned.
        box = to_cache_coords(entry, bbox)[0] if entry is not None else bbox
        if self.use_native:
            from ..native import decode_crop_resize, image_size

            w, h = image_size(imgpath)
            cxmin, cxmax = max(0, int(box[0])), min(w, int(box[1]))
            cymin, cymax = max(0, int(box[2])), min(h, int(box[3]))
            crop = decode_crop_resize(imgpath, (cxmin, cymin, cxmax - cxmin, cymax - cymin),
                                      self.input_shape)
        else:
            crop, _ = resize_crop(_imread(imgpath), box, self.input_shape)
        if not self.is_train:
            return self._eval_sample(crop, bbox, row)
        n = self.num_neighbors
        classes = np.array(row[12:12 + n], dtype=np.int32)
        y_classes = np.zeros(self.num_classes, dtype=np.float32)
        y_classes[classes] = 1.0 / n
        y_weights = np.zeros(self.num_classes, dtype=np.float32)
        y_weights[classes] = np.array(row[12 + n:12 + 2 * n], dtype=np.float32)
        return {"image": crop, "y_classes": y_classes, "y_weights": y_weights}


def build_dataset(cfg, is_train: bool = True, is_source: bool = True,
                  load_labels: bool = True):
    """Dataset factory (reference src/datasets/build.py:34-43)."""
    if cfg.model_name == "krn":
        return KRNDataset(cfg, is_train, is_source, load_labels)
    if cfg.model_name == "spn":
        return SPNDataset(cfg, is_train, is_source)
    raise ValueError(f"unknown model_name: {cfg.model_name}")
