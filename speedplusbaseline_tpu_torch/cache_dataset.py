"""RoI cache builder CLI: ``python -m speedplusbaseline_tpu_torch.cache_dataset``.

The counterpart of the JAX package's ``scripts/cache_dataset.py``, flag for
flag. It decodes each frame a domain's CSVs name once, and stores the
bounded region every crop of it lies in at most ``--cache_size`` px
(data/cache.py). The train, test and adapt CLIs read it with ``--cache_dir``.
It does no tensor work, so it takes no device flag. Prints
``manifest: <path>``.

    python -m speedplusbaseline_tpu_torch.cache_dataset --dataroot $DATAROOT \\
        --domain synthetic --csv splits_krn/train.csv [--csv ...] \\
        --cache_dir $CACHEDIR [--cache_size 512] [--quality 95]
"""
from __future__ import annotations

import argparse
import logging
import os.path as osp
from typing import Optional, Sequence

from .data.cache import build_cache


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Build the cache; returns the manifest's path."""
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--dataroot", required=True)
    p.add_argument("--dataname", default="speedplus")
    p.add_argument("--domain", required=True)
    p.add_argument("--csv", action="append", required=True,
                   help="CSV path(s) relative to <dataroot>/<dataname>/<domain>")
    p.add_argument("--cache_dir", required=True)
    p.add_argument("--cache_size", type=int, default=512)
    p.add_argument("--quality", type=int, default=95)
    args = p.parse_args(argv)

    csvs = [osp.join(args.dataroot, args.dataname, args.domain, c) for c in args.csv]
    manifest = build_cache(args.dataroot, args.dataname, args.domain, csvs,
                           args.cache_dir, args.cache_size, args.quality)
    print(f"manifest: {manifest}")
    return manifest


if __name__ == "__main__":
    main()
