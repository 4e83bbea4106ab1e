"""JAX parameter trees <-> this port's ``state_dict``s, and the flax msgpack
reader and writer.

The JAX package keeps a model as two nested dicts, ``params`` and
``batch_stats``, with flax's layouts. The port's modules use the same names
for every submodule flax names explicitly, and ``conv`` / ``bn`` for flax's
automatic ``Conv_0`` / ``BatchNorm_0`` (KRN, SPN, RevGrad, Ghiasi). The
StylePredictor's flax modules name their conv and BatchNorm ``conv`` / ``bn``
themselves, so there the names pass unchanged (``flax_auto_names=False``).
Every BatchNorm of the port is a module named ``bn``. Layout rules (those of
``speedplusbaseline_tpu/models/weight_convert.py``, in the other direction):

  conv kernel  (kh, kw, I/g, O) HWIO -> weight (O, I/g, kh, kw) OIHW;
               a depthwise (3, 3, 1, C) becomes (C, 1, 3, 3)
  dense kernel (in, out)              -> Linear weight (out, in)
  BatchNorm    params scale/bias      -> weight/bias
               batch_stats mean/var   -> running_mean/running_var
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_AUTO_NAMES = {"Conv_0": "conv", "BatchNorm_0": "bn"}
_AUTO_NAMES_INV = {v: k for k, v in _AUTO_NAMES.items()}
# A flax leaf -> its torch name: conv and dense modules hold kernel/bias,
# BatchNorm scale/bias.
_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_BN_PARAMS = {"weight": "scale", "bias": "bias"}
_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _torch_path(path: Tuple[str, ...]) -> str:
    return ".".join(_AUTO_NAMES.get(p, p) for p in path)


def flax_to_state_dict(params: Mapping[str, Any],
                       batch_stats: Mapping[str, Any] | None = None
                       ) -> Dict[str, torch.Tensor]:
    """Flax ``params`` (+ ``batch_stats``) -> a ``state_dict`` of f32 tensors.
    A BatchNorm is known by its ``scale`` leaf, whatever flax named it."""
    sd: Dict[str, torch.Tensor] = {}
    for path, v in _flatten(params):
        leaf = path[-1]
        if leaf not in _PARAM_LEAVES:
            raise KeyError(f"unmapped flax leaf: {'/'.join(path)}")
        if leaf == "kernel":
            v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
        sd[f"{_torch_path(path[:-1])}.{_PARAM_LEAVES[leaf]}"] = torch.from_numpy(
            np.array(v, dtype=np.float32, order="C"))
    for path, v in _flatten(batch_stats or {}):
        sd[f"{_torch_path(path[:-1])}.{_BN_STATS[path[-1]]}"] = torch.from_numpy(
            np.array(v, dtype=np.float32, order="C"))
    return sd


def _insert(tree: Dict[str, Any], path, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def state_dict_to_flax(sd: Mapping[str, torch.Tensor], flax_auto_names: bool = True):
    """A ``state_dict`` -> (params, batch_stats) nested dicts of numpy arrays.
    ``flax_auto_names``: the model's ``conv`` / ``bn`` are flax's automatic
    ``Conv_0`` / ``BatchNorm_0``; False where flax names them ``conv`` /
    ``bn`` itself (StylePredictor)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    bn_stats = {v: k for k, v in _BN_STATS.items()}
    for key, t in sd.items():
        parts = key.split(".")
        owner, leaf = parts[-2], parts[-1]
        # Only the module that owns the leaf can be flax's Conv_0 /
        # BatchNorm_0; an outer "conv" (RouterV2's) is an explicit name.
        name = _AUTO_NAMES_INV.get(owner, owner) if flax_auto_names else owner
        mods = tuple(parts[:-2]) + (name,)
        v = t.detach().cpu().float().numpy()
        if owner == "bn":
            if leaf in bn_stats:
                _insert(stats, mods + (bn_stats[leaf],), v)
            else:
                _insert(params, mods + (_BN_PARAMS[leaf],), v)
        elif leaf == "weight":
            v = v.transpose(2, 3, 1, 0) if v.ndim == 4 else v.T
            _insert(params, mods + ("kernel",), np.ascontiguousarray(v))
        elif leaf == "bias":
            _insert(params, mods + ("bias",), v)
        else:
            raise KeyError(f"unmapped state_dict key: {key}")
    return params, stats


def read_flax_msgpack(path: str) -> Dict[str, Any]:
    """Read a ``flax.serialization.to_bytes`` file into nested dicts of numpy
    arrays, without flax: arrays are msgpack ext type 1 holding
    (shape, dtype name, raw bytes)."""
    import msgpack

    def ext_hook(code, data):
        if code == 1:
            shape, dtype, buf = msgpack.unpackb(data)
            return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()
        return msgpack.ExtType(code, data)

    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=ext_hook, strict_map_key=False)


def write_flax_msgpack(tree: Mapping[str, Any], path: str) -> None:
    """Write nested dicts of arrays as ``flax.serialization.msgpack_serialize``
    does, without flax: keys in sorted order at every level (flax's tree map
    sorts them), each array as msgpack ext type 1 holding (shape, dtype name,
    C-order bytes). The inverse of ``read_flax_msgpack``."""
    import msgpack

    def ext(x):
        if isinstance(x, np.ndarray):
            return msgpack.ExtType(1, msgpack.packb((x.shape, x.dtype.name, x.tobytes("C")),
                                                    use_bin_type=True))
        raise TypeError(f"cannot write {type(x).__name__} as a flax leaf")

    def sort(t):
        if isinstance(t, Mapping):
            return {str(k): sort(t[k]) for k in sorted(t, key=str)}
        return np.asarray(t)

    with open(path, "wb") as f:
        f.write(msgpack.packb(sort(tree), default=ext, strict_types=True))
