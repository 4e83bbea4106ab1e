"""Where the bf16 Ghiasi generator's error on flax-init weights comes from, on
the card and on the host's CPU (not a test module; imports no JAX):

    python tests/torch_ghiasi_bf16_probe.py            # on a machine with a GPU
    python tests/torch_ghiasi_bf16_probe.py --no_cuda  # the CPU's lines alone

For each seed s of ``chip_smoke.JAX_GHIASI_BF16`` and two kinds of weights,
``numpy`` (``chip_smoke.flax_init_ghiasi(s)``, the same in every torch
version) and ``torch`` (``torch.manual_seed(s); Ghiasi()``, whose draw
follows torch's ``trunc_normal_`` and so the torch version), on chip_smoke
phase ghiasi's inputs, it prints one JSON line with the torch version, the
weights' checksum (the float64 sum of |w| over every parameter) and, each
as (max, mean, elements over 2^-6) of |bf16 - f32| against the plain f32
generator on the CPU:

* ``P``: the plain bf16 generator on the CPU;
* ``K``: the bf16 generator on the card, B1 and B2 launched;
* ``Q``: the same with the plain versions of B1 and B2 in their place;
* ``Q_exact``: Q with every other conv (the 9x9, strided and upsample
  convs) taken in f32 on its bf16-rounded operands and rounded once, in
  place of cuDNN's bf16 conv;
* ``card_f32``: the f32 generator on the card (kernels launched).

K against Q names the kernels, Q_exact against Q cuDNN's bf16 convs, and
the card against P on the same host the card's arithmetic as a whole.
"""
import argparse
import json
import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from speedplusbaseline_tpu_torch.models import ghiasi as gm  # noqa: E402


def stats(got, ref):
    err = (got.float().cpu() - ref).abs()
    return [err.max().item(), err.mean().item(), int((err > 2.0 ** -6).sum())]


def exact_conv(conv, x):
    """``gm._conv`` with f32 arithmetic on the bf16-rounded operands."""
    dt = x.dtype
    y = F.conv2d(x.float(), conv.weight.to(dt).float(), conv.bias.to(dt).float(), conv.stride)
    return y.to(dt)


def weights(kind: str, seed: int):
    if kind == "numpy":
        return chip_smoke.flax_init_ghiasi(seed)
    torch.manual_seed(seed)
    return gm.Ghiasi().state_dict()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no_cuda", action="store_true", help="the CPU's lines alone")
    args = ap.parse_args(argv)
    card = not args.no_cuda
    if card and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (use --no_cuda for the CPU's lines)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda") if card else None
    print(chip_smoke.card_line() if card else "cpu", flush=True)
    x, st = chip_smoke.ghiasi_inputs()
    for kind in ("numpy", "torch"):
        for seed in sorted(chip_smoke.JAX_GHIASI_BF16):
            sd = weights(kind, seed)
            line = {"weights": kind, "seed": seed, "torch": torch.__version__,
                    "checksum": sum(v.double().abs().sum().item() for v in sd.values())}
            nets = {}
            for name, dtype, where in (("cpu_f32", torch.float32, "cpu"),
                                       ("cpu_bf16", torch.bfloat16, "cpu"),
                                       ("card_bf16", torch.bfloat16, dev),
                                       ("card_f32", torch.float32, dev)):
                if where is not None:
                    nets[name] = gm.Ghiasi(dtype).to(where).eval()
                    nets[name].load_state_dict(sd)
            with torch.no_grad():
                ref = nets["cpu_f32"](x, st)
                line["P"] = stats(nets["cpu_bf16"](x, st), ref)
                if card:
                    xd, sdv = x.to(dev), st.to(dev)
                    line["K"] = stats(nets["card_bf16"](xd, sdv), ref)
                    with chip_smoke._PlainGhiasi():
                        line["Q"] = stats(nets["card_bf16"](xd, sdv), ref)
                        conv, gm._conv = gm._conv, exact_conv
                        try:
                            line["Q_exact"] = stats(nets["card_bf16"](xd, sdv), ref)
                        finally:
                            gm._conv = conv
                    line["card_f32"] = stats(nets["card_f32"](xd, sdv), ref)
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
