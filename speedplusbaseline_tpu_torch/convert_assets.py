"""Asset converter: ``python -m speedplusbaseline_tpu_torch.convert_assets --src DIR``.

The counterpart of ``scripts/convert_assets.py``, flag for flag: it turns
the SPEED+ baseline's binary assets, from a speedplusbaseline checkout at
``--src``, into the ``.npy`` files of ``--out`` (default ``assets``) that
both packages read, with the script's names, dtypes, shapes and bytes:

  src/utils/tangoPoints.mat       -> tango_points.npy      (11, 3) float32
  src/utils/attitudeClasses.mat   -> attitude_classes.npy  (5000, 4) float32
  src/styleaug/checkpoints/checkpoint_embeddings.pth (if present)
      -> style_embedding_pbn_mean.npy (100,), style_embedding_pbn_cov.npy (100, 100)
  src/styleaug/checkpoints/embedding_mean_speedplus.npy (if present)
      -> style_embedding_speedplus_mean.npy (100,)

The ``.pth`` is read with ``torch.load(weights_only=False)``, as the script
reads it: it is the reference's own file. Needs no GPU.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from .io_utils.assets import read_attitude_mat, read_tango_mat


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser("Convert the SPEED+ baseline's assets to .npy")
    ap.add_argument("--src", required=True, help="speedplusbaseline checkout root")
    ap.add_argument("--out", default="assets")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    pts = read_tango_mat(os.path.join(args.src, "src/utils/tangoPoints.mat"))
    np.save(os.path.join(args.out, "tango_points.npy"), pts)
    print("tango_points:", pts.shape)

    qclass = read_attitude_mat(os.path.join(args.src, "src/utils/attitudeClasses.mat"))
    np.save(os.path.join(args.out, "attitude_classes.npy"), qclass)
    print("attitude_classes:", qclass.shape)

    emb_path = os.path.join(args.src, "src/styleaug/checkpoints/checkpoint_embeddings.pth")
    if os.path.exists(emb_path):
        ckpt = torch.load(emb_path, map_location="cpu", weights_only=False)
        mean = ckpt["pbn_embedding_mean"].numpy().reshape(-1).astype(np.float32)
        cov = ckpt["pbn_embedding_covariance"].numpy().astype(np.float32)
        np.save(os.path.join(args.out, "style_embedding_pbn_mean.npy"), mean)
        np.save(os.path.join(args.out, "style_embedding_pbn_cov.npy"), cov)
        print("pbn embedding:", mean.shape, cov.shape)

    sp_mean_path = os.path.join(args.src,
                                "src/styleaug/checkpoints/embedding_mean_speedplus.npy")
    if os.path.exists(sp_mean_path):
        sp_mean = np.load(sp_mean_path).reshape(-1).astype(np.float32)
        np.save(os.path.join(args.out, "style_embedding_speedplus_mean.npy"), sp_mean)
        print("speedplus mean embedding:", sp_mean.shape)


if __name__ == "__main__":
    main()
