"""Label preprocessing CLI: ``python -m speedplusbaseline_tpu_torch.preprocess``.

SPEED+ JSON labels -> the per-model CSV (keypoint projection and tight box;
SPN's attitude-class bins), with the private argparse surface of the JAX
package's root ``preprocess.py`` (reference preprocess.py:44-57), flag for
flag, plus ``--no_cuda``. The projection runs on CUDA unless ``--no_cuda`` is
given; with no GPU and no ``--no_cuda`` it raises. Prints ``Wrote <path>``.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from .config import resolve_device
from .data.preprocess import json2csv


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("Generating CSV files")
    parser.add_argument("--projroot", type=str, default=".")
    parser.add_argument("--dataroot", type=str, default="datasets")
    parser.add_argument("--dataname", type=str, default="speedplus")
    parser.add_argument("--model_name", type=str, default="krn")
    parser.add_argument("--num_keypoints", type=int, default=11)
    parser.add_argument("--num_neighbors", type=int, default=5)
    parser.add_argument("--keypts_3d_model", type=str, default="src/utils/tangoPoints.mat")
    parser.add_argument("--attitude_class", type=str,
                        default="src/utils/attitudeClasses.mat")
    parser.add_argument("--domain", type=str, default="synthetic")
    parser.add_argument("--jsonfile", type=str, default="train.json")
    parser.add_argument("--csvfile", type=str, default="splits_krn/train.csv")
    parser.add_argument("--no_cuda", dest="use_cuda", action="store_false", default=True)
    parser.set_defaults(gpu_id=0)  # resolve_device's card; no flag
    return parser


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Write the CSV; returns its path."""
    cfg = build_parser().parse_args(argv)
    out = json2csv(dataroot=cfg.dataroot, dataname=cfg.dataname, domain=cfg.domain,
                   jsonfile=cfg.jsonfile, csvfile=cfg.csvfile, model_name=cfg.model_name,
                   num_keypoints=cfg.num_keypoints, num_neighbors=cfg.num_neighbors,
                   keypts_3d_model=cfg.keypts_3d_model, attitude_class=cfg.attitude_class,
                   device=resolve_device(cfg))
    print(f"Wrote {out}")
    return out


if __name__ == "__main__":
    main()
