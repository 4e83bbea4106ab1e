"""What the measuring modules share.

* The timing protocol of the JAX package's root ``bench.py`` (its
  ``WARMUP_STEPS`` and ``_timed_chain``): a step's time is
  ``(t(n) - t(1)) / (n - 1)`` on the host clock, each stamp closed by
  ``torch.cuda.synchronize()``, the CUDA counterpart of JAX's one-element
  fetch.
* The device from ``--no_cuda`` (a GPU, or an error when there is none), and
  the card's name and power limit, which every JSON line carries under
  ``"card"``.
* The recipe of a train step on a resident batch (its config, batch, model
  and generator), the device's busy ms a step, and the styled step that both
  A/Bs time.
* The runner that starts a measure or an arm as its own process, once, and
  the A/Bs' CLI.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..augment.styleaug import StyleAugmentor, load_style_stats, random_style_stats
from ..config import default_cfg, full_f32, resolve_device
from ..engine.state import TrainState
from ..engine.steps import make_train_step
from ..io_utils import default_assets_dir

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WARMUP_STEPS = 5
#: Side of the square input of each model's recipe (SPN's 227 is odd).
SIDE = {"krn": 224, "spn": 227}
BATCH = 48
#: Timed steps of an A/B arm (the JAX scripts' n).
CHAIN_STEPS = 150
#: Steps profiled for the device's busy ms (each profile runs one more first).
PROFILE_STEPS = 3
#: Seconds a child process may take (the root bench.py's _ATTEMPT_TIMEOUT_S).
CHILD_TIMEOUT_S = 900


def device(no_cuda: bool) -> torch.device:
    """The card unless ``no_cuda``; raises when no GPU is present and
    ``no_cuda`` is not given. f32 math is full f32, as in the CLIs
    (``config.full_f32``)."""
    dev = resolve_device(SimpleNamespace(use_cuda=not no_cuda, gpu_id=0))
    full_f32()
    return dev


def workers() -> int:
    """The loader threads of the JAX benches: max(2, the host's cores)."""
    return max(2, os.cpu_count() or 2)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_chain(step_once: Callable[[], object], n: int, dev: torch.device) -> float:
    """Seconds a step: ``(t(n) - t(1)) / (n - 1)``, where each t(k) runs
    ``step_once`` k times and ends in a synchronize; one unmeasured run of
    one step settles the dispatch path first. ``step_once`` must advance
    the state that the next step reads."""
    def run(k):
        t0 = time.perf_counter()
        for _ in range(k):
            step_once()
        sync(dev)
        return time.perf_counter() - t0

    run(1)
    t1 = run(1)
    tn = run(n)
    return (tn - t1) / (n - 1)


def card(dev: torch.device) -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    the card (its first line), or ``"cpu"``."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def emit(record: dict, dev: torch.device) -> dict:
    """Add the card line and print ``record`` as one JSON line."""
    record["card"] = card(dev)
    print(json.dumps(record), flush=True)
    return record


def style_stats():
    """The shipped embedding statistics, or the seeded stand-in where the
    assets lack them (as the JAX A/Bs)."""
    try:
        return load_style_stats(default_assets_dir())
    except FileNotFoundError:
        return random_style_stats(0)


def recipe_cfg(model_name: str, batch: int = BATCH, side: Optional[int] = None, **kw):
    """The JAX benches' train recipe: bf16 (autocast), AdamW lr 1e-3 and
    weight decay 0.01; KRN at 224^2, SPN at 227^2 with the config's classes.
    ``kw`` sets further config keys."""
    side = side or SIDE[model_name]
    return default_cfg(model_name=model_name, batch_size=batch, input_shape=(side, side),
                       optimizer="adamw", lr=1e-3, weight_decay=0.01, fp16=True, **kw)


def resident_batch(cfg) -> Dict[str, np.ndarray]:
    """The JAX benches' batch from ``RandomState(0)``, in their order of
    draws: KRN image then keypts; SPN y_classes and y_weights (each row
    normalized) then image."""
    batch, shape = cfg.batch_size, cfg.input_shape
    rs = np.random.RandomState(0)
    if cfg.model_name == "krn":
        return {"image": rs.rand(batch, *shape, 3).astype(np.float32),
                "keypts": rs.rand(batch, 2, cfg.num_keypoints).astype(np.float32)}
    yc = rs.rand(batch, cfg.num_classes).astype(np.float32)
    yw = rs.rand(batch, cfg.num_classes).astype(np.float32)
    return {"y_classes": yc / yc.sum(1, keepdims=True),
            "y_weights": yw / yw.sum(1, keepdims=True),
            "image": rs.rand(batch, *shape, 3).astype(np.float32)}


def to_device(arrays: Dict[str, np.ndarray], dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


def new_state(cfg, dev: torch.device) -> TrainState:
    """The model of ``cfg`` from seed 0 (JAX's ``PRNGKey(0)``), channels_last
    on ``dev``, and its optimizer."""
    torch.manual_seed(0)
    return TrainState.for_config(cfg, dev)


def generator(cfg, dev: torch.device, **kw) -> StyleAugmentor:
    """The bf16 style augmentor on the shipped statistics, its generator's
    weights from seed 1 (flax's init, ``flax_default_init_``, as JAX's
    ``init_params(PRNGKey(1))``); ``kw`` (``phase_space``, ``f32_out``) goes
    to the StyleAugmentor. Unlike the trainer's ``styleaug.style_augmentor``,
    which loads the shipped generator weights, this keeps the JAX benches'
    flax init, so that each A/B arm times what its JAX counterpart times."""
    torch.manual_seed(1)
    return StyleAugmentor(cfg.texture_alpha, style_stats(), torch.bfloat16, dev, **kw)


def lowering(aug: StyleAugmentor) -> str:
    """The Ghiasi lowering that ``aug`` runs: ``"plain"`` or ``"phase"``."""
    return "phase" if aug.ghiasi.phase_space else "plain"


def busy_ms(state, step, data, styled: bool, dev: torch.device, label: str) -> Optional[float]:
    """The device's busy ms a step over PROFILE_STEPS profiled steps of
    ``step(state, data, styled)`` (torch.profiler; it runs one step more
    first); None on the CPU, where no step runs."""
    if dev.type != "cuda":
        return None
    from ..profile_step import profile

    return profile(state, step, data, styled, steps=PROFILE_STEPS, table=False, label=label)


def check_finite(what: str, losses: Dict[str, torch.Tensor]) -> None:
    """Raise when a loss term of the last step is not finite."""
    values = {k: float(v) for k, v in losses.items()}
    if not all(math.isfinite(v) for v in values.values()):
        raise RuntimeError(f"{what}: non-finite loss {values}")


def styled_arm(arm: str, model_name: str, dev: torch.device, *, f32_out: bool = False,
               phase_space: bool = False, batch: int = BATCH, side: Optional[int] = None,
               n: int = CHAIN_STEPS) -> dict:
    """Time the styled train step of ``model_name`` on one resident batch
    and print its JSON line: WARMUP_STEPS steps, then ``timed_chain`` over
    ``n``; on the card also the device's busy ms a step (``busy_ms``). The
    JAX A/Bs' recipe (``recipe_cfg``, batch 48), batch (``resident_batch``),
    model (``new_state``) and generator (``generator``). ``phase_space`` and
    ``f32_out`` go to the StyleAugmentor. The line holds the JAX keys
    (``arm``, ``styled_step_ms``) and the port's: ``lowering``, ``batch``,
    ``input``, ``steps`` (every step run, for launch counts),
    ``device_busy_ms`` (null on the CPU) and ``card``."""
    cfg = recipe_cfg(model_name, batch, side)
    data = to_device(resident_batch(cfg), dev)
    state = new_state(cfg, dev)
    aug = generator(cfg, dev, phase_space=phase_space, f32_out=f32_out)
    train_step = make_train_step(cfg, dev, aug)
    steps, last = [0], [{}]

    def step(st, b, styled):
        steps[0] += 1
        last[0] = train_step(st, b, styled)
        return last[0]

    def once():
        step(state, data, True)

    for _ in range(WARMUP_STEPS):
        once()
    sync(dev)
    per_step = timed_chain(once, n, dev)
    busy = busy_ms(state, step, data, True, dev, f"{arm} styled")
    check_finite(f"arm {arm}", last[0])
    return emit({"arm": arm, "styled_step_ms": per_step * 1e3, "lowering": lowering(aug),
                 "batch": batch, "input": cfg.input_shape[0], "steps": steps[0],
                 "device_busy_ms": busy}, dev)


def run_child(cmd: Sequence[str], label: str, timeout_s: float = CHILD_TIMEOUT_S) -> dict:
    """Run ``cmd`` once, from the repository root, and return the last line
    of its standard output that starts with ``{``, parsed; its output goes to
    stderr, each line under ``[label]``. A nonzero exit
    (``CalledProcessError``), a timeout (``TimeoutExpired``) or no JSON line
    (``RuntimeError``) raises: there is no retry."""
    out = subprocess.run(list(cmd), cwd=REPO, stdout=subprocess.PIPE, text=True,
                         timeout=timeout_s, check=True)
    lines = out.stdout.splitlines()
    sys.stderr.write("".join(f"[{label}] {ln}\n" for ln in lines))
    records = [ln for ln in lines if ln.startswith("{")]
    if not records:
        raise RuntimeError(f"{label} printed no JSON line")
    return json.loads(records[-1])


def run_arms(module: str, arms: Sequence[str], flags: Sequence[str],
             timeout_s: float) -> Dict[str, dict]:
    """Run ``python -m speedplusbaseline_tpu_torch.perf.<module> --arm A
    flags`` for each arm in turn, each its own process (``run_child``);
    {arm: its JSON line}."""
    return {arm: run_child([sys.executable, "-m", f"speedplusbaseline_tpu_torch.perf.{module}",
                            "--arm", arm, *flags], f"arm {arm}", timeout_s)
            for arm in arms}


def ab_main(module: str, arms: Sequence[str], run_arm, argv: Optional[Sequence[str]]) -> dict:
    """The A/B CLI: ``--arm A`` runs ``run_arm(A, dev, n=...)`` in this
    process; without it, each arm runs as its own process (``run_arms``) and
    ``{arm: {...}}`` is printed last. ``--n`` sets the timed steps,
    ``--timeout`` the seconds an arm may take (900), ``--no_cuda`` the CPU."""
    ap = argparse.ArgumentParser(prog=f"python -m speedplusbaseline_tpu_torch.perf.{module}")
    ap.add_argument("--arm", choices=arms)
    ap.add_argument("--n", type=int, default=CHAIN_STEPS, help="timed steps")
    ap.add_argument("--timeout", type=int, default=CHILD_TIMEOUT_S,
                    help="seconds an arm may take")
    ap.add_argument("--no_cuda", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    dev = device(args.no_cuda)
    if args.arm:
        return run_arm(args.arm, dev, n=args.n)
    flags = ["--n", str(args.n)] + (["--no_cuda"] if args.no_cuda else [])
    results = run_arms(module, arms, flags, args.timeout)
    print(json.dumps(results), flush=True)
    return results
