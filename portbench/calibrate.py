"""The readings that the limits of ``correct`` are set from, for one cell,
over many seeds in one process:

    python -m portbench.calibrate --workload <name> --seeds 1 2 3 ... [--controls 3]

For each seed, the program's first steps exactly as a run makes them
(``train_resident.warm_up``) against the float32 reference: the sound
readings. For the first ``--controls`` seeds also the control, the
reference itself with every conv and dense operand rounded to float8 (one
precision below the configuration's bf16), put in the program's place; and
the program again with each fault of ``faults`` planted in its timed path,
at the cell's own size. Prints one JSON line a seed and a summary line: the
largest sound reading of each number and the smallest reading of the
control and of each fault. Runs on the card (``--cpu`` for a rehearsal at
the sizes the configuration states).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import faults, spec
from .runners import train_resident as d


def _program(cell, config, seeds, device):
    cfg, state, step, weights, batches = d.build(config, cell.traffic, seeds, device, {})
    gate = d.Gate(cell.traffic["texture_ratio"], seeds.gate)
    _source, _stepper, prog = d.warm_up(config, cfg, state, step, weights, batches, gate, device)
    del state, step, _source, _stepper
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return cfg, weights, batches, gate, prog


def readings(cell, seed: int, device: torch.device, controls: bool,
             witness: bool = False) -> dict:
    config = cell.config
    seeds = d.Seeds.of(seed)
    cfg, weights, batches, gate, prog = _program(cell, config, seeds, device)
    ref = d.reference_readings(config, weights, batches, gate, cfg.seed, device)
    out = {"seed": seed, "styled": [gate[i] for i in range(d.COMPARED)],
           "program": d.compare(prog, ref), "loss_gaps": d.loss_gaps(prog, ref),
           "loss_ref": ref["loss"], "loss_program": prog["loss"]}
    got = {"program": prog}
    if witness:
        got["program_f32"] = _program(cell, dict(config, fp16=False), seeds, device)[4]
        out["program_f32"] = d.compare(got["program_f32"], ref)
    if controls:
        got["control_fp8"] = d.reference_readings(config, weights, batches, gate, cfg.seed,
                                                  device, "fp8")
        out["control_fp8"] = d.compare(got["control_fp8"], ref)
        for key, plant in faults.of(cell.traffic).items():
            with plant():
                got[key] = _program(cell, config, seeds, device)[4]
            out[key] = d.compare(got[key], ref)
    out["losses"] = {k: v["loss"] for k, v in got.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3, help="seeds that also read the control and the faults")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--witness", action="store_true",
                    help="also run the program in float32 (no autocast) against the reference")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        print("calibrate: no CUDA device (pass --cpu to rehearse)", file=sys.stderr)
        return 1
    rows = []
    for i, seed in enumerate(args.seeds):
        t = time.perf_counter()
        row = readings(cell, seed, device, i < args.controls, args.witness and i < args.controls)
        row["seconds"] = time.perf_counter() - t
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload, "seeds": len(rows),
               "sound_max": {k: max(r["program"][k] for r in rows) for k in rows[0]["program"]}}
    for key in ("control_fp8", *faults.ALL):
        got = [r[key] for r in rows if key in r]
        if got:
            summary[f"{key}_min"] = {k: min(g[k] for g in got) for k in got[0]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
