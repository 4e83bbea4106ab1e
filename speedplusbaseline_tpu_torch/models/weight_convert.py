"""Pretrained-weight converters and the pretrained-weight loader (counterpart
of ``speedplusbaseline_tpu/models/weight_convert.py``).

Each converter takes a source checkpoint's tensors (numpy arrays or torch
tensors) and returns a ``state_dict`` of the port's module, to be loaded
with ``load_state_dict`` (strict):

  * torchvision ``mobilenet_v2`` ImageNet weights -> ``MobileNetV2Features``
    (KRN's ``base``; reference park2019.py:107);
  * ``bvlc_alexnet.npy`` (caffe, HWIO) conv1-5 -> SPN's conv1-5
    (reference spn.py:101-123);
  * a torch ``SpacecraftPoseNet`` -> the port's SPN;
  * ``checkpoint_transformer.pth`` -> ``Ghiasi`` (styleAugmentor.py:23-27);
  * ``checkpoint_stylepredictor.pth`` -> ``StylePredictor``
    (styleAugmentor.py:30-34).

The real files are not in the repository; the tests run these on state
dicts made from a seed with the original key names and shapes.

``maybe_load_pretrained`` reads the files the JAX trainer reads, from the
same assets directory: ``mobilenetv2_backbone.msgpack`` (written by
``python -m speedplusbaseline_tpu_torch.convert_weights mobilenet_v2`` or
the JAX package's script) and ``bvlc_alexnet.npy``.
"""
from __future__ import annotations

import logging
import os.path as osp
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from ..convert import flax_to_state_dict, read_flax_msgpack

logger = logging.getLogger(__name__)

# (expand_ratio, repeats) of the MobileNetV2 schedule (mobilenetv2._IR_SETTINGS).
_MNV2_SCHEDULE = ((1, 1), (6, 2), (6, 3), (6, 4), (6, 3), (6, 3), (6, 1))
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")
_SPN_CONVS = ("conv1", "conv2", "conv3", "conv4", "conv5")
# SPN's pool5 at the recipe's 227^2: (C, H, W), as torch flattens it.
_SPN_POOL5 = (256, 6, 6)


def _tensor(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, dtype=np.float32))


def _convbn(out: Dict[str, torch.Tensor], dst: str, conv: str, bn: str, sd) -> None:
    out[f"{dst}.conv.weight"] = _tensor(sd[f"{conv}.weight"])
    for leaf in _BN_LEAVES:
        out[f"{dst}.bn.{leaf}"] = _tensor(sd[f"{bn}.{leaf}"])


def convert_mobilenet_v2(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """torchvision ``mobilenet_v2`` state_dict -> ``MobileNetV2Features``
    (stem + block1..17). features.0 is the stem ConvBNReLU; features.i
    (i = 1..17) an InvertedResidual whose ``.conv`` is [expand ConvBNReLU,
    unless t = 1] + depthwise ConvBNReLU + project conv + BN. The final
    1280-channel conv (features.18), the classifier and
    ``num_batches_tracked`` are not part of the backbone and are left out."""
    out: Dict[str, torch.Tensor] = {}
    _convbn(out, "stem", "features.0.0", "features.0.1", sd)
    idx = 1
    for t, n in _MNV2_SCHEDULE:
        for _ in range(n):
            src, dst = f"features.{idx}.conv", f"block{idx}"
            if t != 1:
                _convbn(out, f"{dst}.expand", f"{src}.0.0", f"{src}.0.1", sd)
            i = 0 if t == 1 else 1  # the depthwise conv's index
            _convbn(out, f"{dst}.depthwise", f"{src}.{i}.0", f"{src}.{i}.1", sd)
            _convbn(out, f"{dst}.project", f"{src}.{i + 1}", f"{src}.{i + 2}", sd)
            idx += 1
    return out


def convert_bvlc_alexnet(weights: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``bvlc_alexnet.npy`` dict (per conv, [HWIO kernel, bias]) -> the
    state_dict entries of SPN's conv1-5 (spn.py:104-123): caffe HWIO to
    OIHW; the grouped conv2, conv4 and conv5 hold I/g input channels."""
    out: Dict[str, torch.Tensor] = {}
    for name in _SPN_CONVS:
        for data in weights[name]:
            data = _tensor(data)
            if data.ndim == 4:
                out[f"{name}.weight"] = data.permute(3, 2, 0, 1).contiguous()
            else:
                out[f"{name}.bias"] = data
    return out


def convert_spn_torch(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A torch ``SpacecraftPoseNet`` state_dict (reference spn.py:50-143) ->
    the port's SPN. fc6 and fc9 read the flattened pool5: torch flattens it
    (C, 6, 6), the port (6, 6, C) as flax does, so their input columns are
    permuted."""
    out = {k: _tensor(sd[k]) for k in sd if not k.startswith(("fc6.", "fc9."))}
    for name in ("fc6", "fc9"):
        w = _tensor(sd[f"{name}.weight"])
        out[f"{name}.weight"] = (w.reshape(w.shape[0], *_SPN_POOL5).permute(0, 2, 3, 1)
                                 .reshape(w.shape[0], -1).contiguous())
        out[f"{name}.bias"] = _tensor(sd[f"{name}.bias"])
    return out


def convert_ghiasi(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``checkpoint_transformer.pth``'s ``state_dict_ghiasi`` (keys
    ``layers.N.*``) -> ``Ghiasi`` (``layerN.*``: ConvInRelu ``conv``,
    ResidualBlock ``conv1/2``, ``fc_gamma1/2``, ``fc_beta1/2``,
    UpsampleConvInRelu ``conv``, ``fc_gamma``, ``fc_beta``). Load it with
    ``load_state_dict``: its post-hook remakes the HWIO weights that kernel
    B1 reads."""
    out: Dict[str, torch.Tensor] = {}
    for key, v in sd.items():
        head, n, rest = (key.split(".", 2) + ["", ""])[:3]
        if head != "layers" or not n.isdigit() or not rest:
            raise KeyError(f"unmapped Ghiasi key: {key}")
        out[f"layer{n}.{rest}"] = _tensor(v)
    return out


def convert_style_predictor(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``checkpoint_stylepredictor.pth`` state_dict -> ``StylePredictor``.
    The names are the reference's, so only ``num_batches_tracked`` goes;
    any key the port's module does not hold (a conv bias: BasicConv2d's
    convs have none) raises, as does a missing one."""
    from .style_predictor import StylePredictor

    with torch.device("meta"):
        expected = set(StylePredictor().state_dict())
    out = {k: _tensor(v) for k, v in sd.items() if not k.endswith(".num_batches_tracked")}
    if set(out) != expected:
        raise KeyError(f"StylePredictor keys: unmapped {sorted(set(out) - expected)}, "
                       f"missing {sorted(expected - set(out))}")
    return out


def maybe_load_pretrained(cfg, model: nn.Module, assets_dir: str) -> bool:
    """Load the converted pretrained weights into a fresh model when the
    asset exists; returns whether it loaded. KRN: ``mobilenetv2_backbone.
    msgpack`` ({"params", "batch_stats"}) into ``base``, ``net.base`` under
    DANN. SPN: ``bvlc_alexnet.npy`` into conv1-5. The rest keeps its init.
    ``load_state_dict`` copies into the existing parameters, so an optimizer
    built on them stays valid. A file that does not cover its target
    exactly raises, as flax's ``from_state_dict`` does."""
    if cfg.model_name == "krn":
        path = osp.join(assets_dir, "mobilenetv2_backbone.msgpack")
        if not osp.exists(path):
            return False
        raw = read_flax_msgpack(path)
        base = model.net.base if cfg.dann else model.base
        base.load_state_dict(flax_to_state_dict(raw["params"], raw["batch_stats"]))
        logger.info("MobileNetV2 ImageNet backbone loaded from %s", path)
        return True
    if cfg.model_name == "spn":
        path = osp.join(assets_dir, "bvlc_alexnet.npy")
        if not osp.exists(path):
            return False
        weights = np.load(path, allow_pickle=True, encoding="bytes").item()
        weights = {k.decode() if isinstance(k, bytes) else k: v for k, v in weights.items()}
        sd = convert_bvlc_alexnet(weights)
        for name in _SPN_CONVS:
            getattr(model, name).load_state_dict(
                {leaf: sd[f"{name}.{leaf}"] for leaf in ("weight", "bias")})
        logger.info("bvlc_alexnet conv1-5 loaded from %s", path)
        return True
    return False
