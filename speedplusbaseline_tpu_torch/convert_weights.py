"""Weight-conversion CLI: ``python -m speedplusbaseline_tpu_torch.convert_weights
{mobilenet_v2, ghiasi, style_predictor} --src X.pth [--out Y]``.

The counterpart of ``scripts/convert_torchvision_mobilenet.py``,
``scripts/convert_ghiasi.py`` and ``scripts/convert_style_predictor.py``,
without JAX. Each subcommand reads a torch checkpoint, converts it into the
port's module through ``load_state_dict`` (strict, on the card unless
``--no_cuda``) and writes the flax msgpack the JAX script writes, at the
script's default path, so that one assets directory serves both packages:

  mobilenet_v2     torchvision mobilenet_v2 state_dict
                   -> assets/mobilenetv2_backbone.msgpack  {"params", "batch_stats"}
  ghiasi           checkpoint_transformer.pth ("state_dict_ghiasi")
                   -> assets/ghiasi_params.msgpack         the params tree
  style_predictor  checkpoint_stylepredictor.pth ("state_dict_stylepredictor")
                   -> assets/style_predictor.msgpack       {"params", "batch_stats"}

The checkpoint is read with ``torch.load(weights_only=True)``: tensors and
dicts, no pickled module. With no GPU and no ``--no_cuda`` it raises.
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Sequence

import torch
import torch.nn as nn

from .config import resolve_device
from .convert import state_dict_to_flax, write_flax_msgpack
from .models.ghiasi import Ghiasi
from .models.mobilenetv2 import MobileNetV2Features
from .models.style_predictor import StylePredictor
from .models.weight_convert import (convert_ghiasi, convert_mobilenet_v2,
                                    convert_style_predictor)


class _Target(NamedTuple):
    out: str  # the JAX script's default output
    entry: Optional[str]  # the checkpoint's state_dict entry, if any
    module: Callable[[], nn.Module]
    convert: Callable[[Mapping[str, Any]], Dict[str, torch.Tensor]]
    with_stats: bool  # {"params", "batch_stats"}, else the params tree alone
    flax_auto_names: bool  # see convert.state_dict_to_flax


_TARGETS = {
    "mobilenet_v2": _Target("assets/mobilenetv2_backbone.msgpack", None, MobileNetV2Features,
                            convert_mobilenet_v2, True, True),
    "ghiasi": _Target("assets/ghiasi_params.msgpack", "state_dict_ghiasi", Ghiasi,
                      convert_ghiasi, False, True),
    "style_predictor": _Target("assets/style_predictor.msgpack", "state_dict_stylepredictor",
                               StylePredictor, convert_style_predictor, True, False),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("Convert torch weights to the flax msgpack assets")
    ap.add_argument("target", choices=sorted(_TARGETS))
    ap.add_argument("--src", required=True, help="torch checkpoint (.pth)")
    ap.add_argument("--out", default="", help="output .msgpack (default: the JAX "
                                              "script's path under assets/)")
    ap.add_argument("--no_cuda", dest="use_cuda", action="store_false", default=True)
    ap.set_defaults(gpu_id=0)  # resolve_device's card; no flag
    return ap


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Write the converted file; returns its path."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args)
    target = _TARGETS[args.target]
    out = args.out or target.out

    ckpt = torch.load(args.src, map_location="cpu", weights_only=True)
    sd = ckpt.get(target.entry, ckpt) if target.entry else ckpt
    model = target.module().to(device)
    model.load_state_dict(target.convert(sd))
    params, stats = state_dict_to_flax(model.state_dict(),
                                       flax_auto_names=target.flax_auto_names)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    write_flax_msgpack({"params": params, "batch_stats": stats} if target.with_stats
                       else params, out)
    print("wrote", out)
    return out


if __name__ == "__main__":
    main()
