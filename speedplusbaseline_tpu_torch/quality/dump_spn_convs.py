"""Export SPN conv1-5 from a trained checkpoint in the ``bvlc_alexnet.npy``
dict format, the file ``maybe_load_pretrained`` reads (the counterpart of
the JAX package's ``scripts/dump_spn_convs.py``).

The dict is {convN: [kernel (HWIO, f32), bias]}, the caffe layout that
``models/weight_convert.py::convert_bvlc_alexnet`` turns back into OIHW.
The 5000-class boot run: train SPN at 500 bins (``convergence_run --model
spn --num_classes 500``), dump its trunk with ``--mirror_assets`` into a
directory, and train the 5000 classes with ``SPEEDPLUS_ASSETS_DIR`` naming
it.

    python -m speedplusbaseline_tpu_torch.quality.dump_spn_convs <model_best.pt> <out.npy>
        [--mirror_assets]

``--mirror_assets`` also copies the repository's assets beside the output
(``common.mirror_assets``), so that the directory can serve as
SPEEDPLUS_ASSETS_DIR. Host work only; no device.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List

import numpy as np
import torch

from ..models.weight_convert import _SPN_CONVS
from . import common


def spn_convs(sd) -> Dict[str, List[np.ndarray]]:
    """{convN: [HWIO f32 kernel, f32 bias]} of an SPN state dict."""
    sd = sd.get("variables", sd)
    weights = {}
    for name in _SPN_CONVS:
        w = sd[f"{name}.weight"].detach().cpu().float()
        b = sd[f"{name}.bias"].detach().cpu().float()
        assert w.ndim == 4 and b.ndim == 1, (name, tuple(w.shape))
        weights[name] = [np.ascontiguousarray(w.permute(2, 3, 1, 0).numpy()), b.numpy()]
    return weights


def dump(ckpt_path: str, out_path: str) -> Dict[str, List[np.ndarray]]:
    weights = spn_convs(torch.load(ckpt_path, map_location="cpu", weights_only=True))
    np.save(out_path, np.array(weights, dtype=object), allow_pickle=True)
    return weights


def main(argv=None) -> Dict[str, List[np.ndarray]]:
    p = argparse.ArgumentParser()
    p.add_argument("ckpt")
    p.add_argument("out")
    p.add_argument("--mirror_assets", action="store_true",
                   help="copy the repository's assets beside the output")
    args = p.parse_args(argv)
    if args.mirror_assets:
        common.mirror_assets(os.path.dirname(os.path.abspath(args.out)))
    w = dump(args.ckpt, args.out)
    print({k: [tuple(a.shape) for a in v] for k, v in w.items()})
    print("wrote", args.out)
    return w


if __name__ == "__main__":
    main()
