"""Export a trained KRN's MobileNetV2 trunk as a torchvision
``mobilenet_v2().features`` state dict, the ``.pth`` that ``python -m
speedplusbaseline_tpu_torch.convert_weights mobilenet_v2`` (and so
``maybe_load_pretrained``) reads (the counterpart of the JAX package's
``scripts/dump_krn_backbone.py``).

The exact inverse of ``models/weight_convert.py::convert_mobilenet_v2``: the
port's ``base`` already holds torch layouts, so each tensor is copied under
its torchvision name, and ``convert_mobilenet_v2(backbone_to_torchvision(sd))``
gives back ``sd`` bit for bit.

    python -m speedplusbaseline_tpu_torch.quality.dump_krn_backbone <model_best.pt> <out.pth>

Takes the port's ``model_best.pt`` or ``checkpoint.pt`` of KRN or of a DANN
run (KRN under ``net.``). Host work only; no device.
"""
from __future__ import annotations

import sys
from typing import Dict, Mapping

import torch

from ..models.weight_convert import _BN_LEAVES, _MNV2_SCHEDULE


def _inv_convbn(out: Dict[str, torch.Tensor], src: str, conv: str, bn: str,
                sd: Mapping[str, torch.Tensor]) -> None:
    out[f"{conv}.weight"] = sd[f"{src}.conv.weight"]
    for leaf in _BN_LEAVES:
        out[f"{bn}.{leaf}"] = sd[f"{src}.bn.{leaf}"]


def backbone_to_torchvision(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``MobileNetV2Features`` state dict (stem, block1..17) -> torchvision
    ``features.0..17`` keys, f32 contiguous CPU tensors."""
    sd = {k: v.detach().cpu().float().contiguous() for k, v in sd.items()}
    out: Dict[str, torch.Tensor] = {}
    _inv_convbn(out, "stem", "features.0.0", "features.0.1", sd)
    idx = 1
    for t, n in _MNV2_SCHEDULE:
        for _ in range(n):
            src, dst = f"block{idx}", f"features.{idx}.conv"
            if t != 1:
                _inv_convbn(out, f"{src}.expand", f"{dst}.0.0", f"{dst}.0.1", sd)
            i = 0 if t == 1 else 1  # the depthwise conv's index
            _inv_convbn(out, f"{src}.depthwise", f"{dst}.{i}.0", f"{dst}.{i}.1", sd)
            # torchvision's project conv and BN are bare children of `conv`.
            _inv_convbn(out, f"{src}.project", f"{dst}.{i + 1}", f"{dst}.{i + 2}", sd)
            idx += 1
    return out


def base_state_dict(ckpt: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The ``base.`` entries of a KRN (or, under ``net.``, RevGrad) state
    dict or train-state checkpoint, without the prefix."""
    sd = ckpt.get("variables", ckpt)
    prefix = "net.base." if any(k.startswith("net.") for k in sd) else "base."
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def dump(ckpt_path: str, out_path: str) -> Dict[str, torch.Tensor]:
    """Write the checkpoint's trunk as a torchvision state dict; returns it."""
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    sd = backbone_to_torchvision(base_state_dict(ckpt))
    torch.save(sd, out_path)
    return sd


def main(argv=None) -> Dict[str, torch.Tensor]:
    ckpt, out = (sys.argv[1:] if argv is None else argv)[:2]
    sd = dump(ckpt, out)
    print(f"{len(sd)} tensors")
    print("wrote", out)
    return sd


if __name__ == "__main__":
    main()
