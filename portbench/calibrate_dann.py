"""The readings that the limits of ``correct`` are set from, for a cell run
by ``runners/dann_layerwise``, over many seeds in one process:

    python -m portbench.calibrate_dann --workload <name> --seeds 1 2 3 ... [--controls 3]

For each seed, the program's warm-up exactly as a run makes it
(``dann_layerwise.warm_up``), checked layer by layer against the float32
reference at the compared steps: the sound readings. For the first
``--controls`` seeds also the program again under each control of
``faults_dann`` (float32 computed in TF32, or under the bf16 autocast) and
with each of its faults planted in the timed path, at the cell's own size.
Prints one JSON line a seed (each number the largest over the compared
steps) and a summary line: the largest sound reading of each number, the
smallest reading of each control and fault, and the largest peak of device
memory. Runs on the card (``--cpu`` for a rehearsal at the sizes the
configuration states).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import faults_dann, spec
from .runners import dann_layerwise as d


def _program(cell, seed: int, device) -> dict:
    seeds = d.Seeds.of(seed)
    cfg, state, step, alpha, source, target = d.build(cell.config, cell.traffic, seeds,
                                                      d.target_seed(seed), device, {})
    _loaders, _stepper, got = d.warm_up(cell.config, cfg, state, step, alpha, source, target,
                                        device)
    del state, step, _loaders, _stepper, source, target
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"numbers": d.worst(got), "steps": got,
            "peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0}


def readings(cell, seed: int, device: torch.device, controls: bool) -> dict:
    if device.type == "cuda":
        torch.zeros((), device=device)  # the context, before its statistics
        torch.cuda.reset_peak_memory_stats(device)
    got = _program(cell, seed, device)
    out = {"seed": seed, "program": got["numbers"], "steps": got["steps"],
           "peak_bytes": got["peak_bytes"]}
    if controls:
        for key, plant in {**faults_dann.CONTROLS, **faults_dann.FAULTS}.items():
            with plant():
                out[key] = _program(cell, seed, device)["numbers"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.calibrate_dann")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3,
                    help="seeds that also read the controls and the faults")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        print("calibrate_dann: no CUDA device (pass --cpu to rehearse)", file=sys.stderr)
        return 1
    rows = []
    for i, seed in enumerate(args.seeds):
        t = time.perf_counter()
        row = readings(cell, seed, device, i < args.controls)
        row["seconds"] = time.perf_counter() - t
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload, "seeds": len(rows),
               "sound_max": {k: max(r["program"][k] for r in rows) for k in rows[0]["program"]},
               "peak_bytes_max": max(r["peak_bytes"] for r in rows)}
    for key in (*faults_dann.CONTROLS, *faults_dann.FAULTS):
        got = [r[key] for r in rows if key in r]
        if got:
            summary[f"{key}_min"] = {k: min(g[k] for g in got) for k in got[0]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
