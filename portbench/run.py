"""One run of one cell of the port's benchmark.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic mix, limits
and per-layer readers are found by name (``spec.py``); the mix names the
runner that runs it. With ``--trace 0`` the result carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
profiled stretch of the window. Every run compares what the timed path
produced with the plain reference and prints each number compared beside
its limit, last on standard error and last in the result line, which is
the last line on standard output. Without as many CUDA devices as the cell
asks for, or with JAX or the JAX package loaded, it prints no result and
exits 1.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# The program's libraries must not load JAX behind its back.
os.environ.setdefault("USE_FLAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "speedplusbaseline_tpu")


def forbidden_loaded(modules=None):
    """Top-level names of loaded modules that are JAX or the JAX package,
    each compared whole (the port's name begins with the JAX package's)."""
    names = {name.split(".")[0] for name in list(modules if modules is not None else sys.modules)}
    return sorted(names & set(FORBIDDEN))


def card(cell):
    """The first CUDA device, where the machine has as many as ``cell``
    asks for; else None. Nothing falls back to the CPU."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        return None
    return torch.device("cuda", 0)


def measure(cell, seed: int, seconds: float, traced: bool, device, t0: float) -> dict:
    """Run ``cell`` once on ``device``; the result line as a dict. The
    numbers compared go last, under ``checks``."""
    from . import spec

    runner = spec.runner(cell.traffic)
    out = runner.run(cell, seed, seconds, traced, device, t0)
    kind = "cpu"
    if device.type == "cuda":
        import torch

        kind = torch.cuda.get_device_name(device)
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": False, "attempted": out.steps, "failed": out.failed}
    if traced:
        ctx = runner.context(cell, out, kind)
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=ctx.busy_us * 1e-6, window_s=ctx.window_us * 1e-6)
        line["breakdown"] = ctx.breakdown()
    else:
        missing = [m["name"] for m in cell.end_to_end if m["name"] not in out.end_to_end]
        if missing:
            raise KeyError(f"the runner gave no {missing}")
        metrics = {m["name"]: {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    line["correct"] = out.failed == 0 and all(
        c["value"] <= c["limit"] for c in out.checks.values())
    line["metrics"] = metrics
    line["device"] = dev
    line["setup"] = out.setup_phases
    line["read_not_held"] = {k: v for k, v in out.readings.items() if k != "numbers"}
    line["read_not_held"].update({k: v for k, v in out.readings["numbers"].items()
                                  if k not in out.checks})
    line["checks"] = out.checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import spec

    cell = spec.cell(args.workload)
    device = card(cell)
    if device is None:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); there is no "
              f"result without them", file=sys.stderr)
        return 1
    line = measure(cell, args.seed, args.seconds, bool(args.trace), device, T0)
    found = forbidden_loaded()
    if found:
        print(f"portbench: modules loaded that must not be: {found}", file=sys.stderr)
        return 1
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']:.6g} limit {c['limit']:.6g}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
