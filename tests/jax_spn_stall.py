"""The JAX package's side of the SPN Run S stall study, on the CPU (the
port's side is ``speedplusbaseline_tpu_torch.quality.spn_seed_sweep``).
Not a test module: a script that imports both packages, as the tests do.

    JAX_PLATFORMS=cpu python tests/jax_spn_stall.py sweep --root R --out R/jax_seeds \\
        [--seeds 2021 2 0 1 3 4] [--epochs 4]
    JAX_PLATFORMS=cpu python tests/jax_spn_stall.py live --root R --seed S
    JAX_PLATFORMS=cpu python tests/jax_spn_stall.py same_init --root R \\
        [--keys 2 2021] [--steps 64] [--n_batches 4]

``R`` holds Run S's dataset, as the port's sweep (or the convergence
drivers) made it. ``sweep`` runs the repository's ``train.py`` (the JAX
trainer) once a seed with the port's Run S flags (``run_s_flags``), into
``{out}/seed_S``; tabulate with ``spn_seed_sweep --root R --tabulate
--compare {out}``. ``live`` trains one seed as JAX's trainer does and prints
the live-ReLU shares (``spn_seed_sweep.live_shares``' definition, read
through flax's ``capture_intermediates``) before the steps ``LIVE_STEPS``.
``same_init`` draws JAX's init at each ``PRNGKey(k)``, carries it into the
port by ``convert.py`` in memory, and trains both packages in f32 on the
same first ``n_batches`` Run S batches (CSV order, cycled) with dropout off,
AdamW lr 1e-3 wd 0.01 and SPN's clip by value: per step, both loss_c; at
the steps of ``LIVE_AT``, both live shares; at the end, per tensor, the
share of weights more than ``DRIFT`` apart, the largest gap and the gap's
L2 norm over that of the weights' move. Beside them, JAX against itself
from the init moved by one f32 ulp a weight: the drift f32 rounding alone
makes. The last line of each command is a JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from speedplusbaseline_tpu_torch.quality import spn_seed_sweep as sweep  # noqa: E402

LIVE_AT = (0, 16, 32, 64)
# test_spn_train_steps_match_jax holds every weight within 1e-4 after two
# steps; 32 times that is the same drift rate over 64 steps.
DRIFT = 32 * 1e-4


def precision_line() -> str:
    return (f"JAX {jax.__version__} backend {jax.default_backend()} devices "
            f"{len(jax.devices())}, default matmul precision "
            f"{jax.config.jax_default_matmul_precision!r}")


def jax_live_shares(model, params, images) -> dict:
    """``live_shares`` of the flax SPN: the pre-activations of each layer
    from ``capture_intermediates``, in eval mode."""
    _, state = model.apply({"params": params}, images, train=False,
                           capture_intermediates=True, mutable=["intermediates"])
    inter = state["intermediates"]
    out = {}
    for name in sweep.LIVE_LAYERS:
        a = np.asarray(inter[name]["__call__"][0]) > 0
        alive = a.any(0)  # (H, W, C) of a conv, (N,) of a dense layer
        if alive.ndim == 3:
            alive = alive.reshape(-1, alive.shape[-1]).any(0)
        out[name] = float(alive.mean())
    return out


def cmd_sweep(args):
    print(precision_line(), flush=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for seed in args.seeds:
        out = os.path.join(args.out, f"seed_{seed}")
        t0 = time.time()
        subprocess.run([sys.executable, "train.py",
                        *sweep.run_s_flags(args.root, seed, args.epochs, out)],
                       check=True, cwd=REPO, env=env)
        shutil.rmtree(os.path.join(out, "save"))  # 1.4 GB of weights and Adam moments
        print(f"[jax sweep] seed {seed}: {time.time() - t0:.1f} s", flush=True)
    return sweep.tabulate(args.out, "JAX (CPU)", args.epochs)


def jax_cfg(root, seed, epochs):
    from speedplusbaseline_tpu.config import parse_cfg

    return parse_cfg(sweep.run_s_flags(root, seed, epochs, os.path.join(root, "jax_live")))


def cmd_live(args):
    from speedplusbaseline_tpu.data import SPNDataset
    from speedplusbaseline_tpu.data.loader import make_dataloader
    from speedplusbaseline_tpu.engine import build_optimizer, create_train_state
    from speedplusbaseline_tpu.engine.steps import make_spn_train_step
    from speedplusbaseline_tpu.io_utils import default_assets_dir
    from speedplusbaseline_tpu.models import get_model
    from speedplusbaseline_tpu.models.weight_convert import maybe_load_pretrained

    print(precision_line(), flush=True)
    cfg = jax_cfg(args.root, args.seed, args.epochs)
    rng = jax.random.PRNGKey(cfg.seed)
    model = get_model(cfg)
    loader = make_dataloader(cfg, is_train=True, is_source=True)
    tx = build_optimizer(cfg, len(loader))
    state = create_train_state(model, tx, rng, jnp.zeros((1, *cfg.input_shape, 3)))
    state = maybe_load_pretrained(cfg, state, default_assets_dir())
    step = make_spn_train_step(model, tx, cfg)
    ds = SPNDataset(cfg, is_train=True, is_source=True)
    fixed = jnp.asarray(np.stack([ds[i]["image"] for i in range(cfg.batch_size)]),
                        jnp.float32) / 255.0
    shares, epochs = {}, []
    t0 = time.time()
    for epoch in range(cfg.max_epochs):
        loader.set_epoch(epoch + 1)
        total, rows = 0.0, 0
        for batch in loader:
            if int(state.step) in sweep.LIVE_STEPS:
                shares[int(state.step)] = jax_live_shares(model, state.params, fixed)
            state, sm = step(state, batch, rng)
            b = batch["image"].shape[0]
            total += float(sm["loss_c"]) * b
            rows += b
        epochs.append(total / rows)
        print(f"[jax live] epoch {epoch + 1} loss_c {epochs[-1]:.4f} "
              f"({time.time() - t0:.0f} s)", flush=True)
    if int(state.step) in sweep.LIVE_STEPS:
        shares[int(state.step)] = jax_live_shares(model, state.params, fixed)
    print("step  " + " ".join(f"{n:>6s}" for n in sweep.LIVE_LAYERS))
    for s in sorted(shares):
        print(f"{s:4d}  " + " ".join(f"{shares[s][n]:6.3f}" for n in sweep.LIVE_LAYERS))
    return {"seed": args.seed, "shares": shares, "loss_c": epochs}


def cmd_same_init(args):
    from speedplusbaseline_tpu.config import default_cfg as jax_default_cfg
    from speedplusbaseline_tpu.engine import build_optimizer as jax_build_optimizer
    from speedplusbaseline_tpu.engine.state import TrainState as JaxTrainState
    from speedplusbaseline_tpu.engine.steps import make_spn_train_step as jax_make_step
    from speedplusbaseline_tpu.models.spn import SpacecraftPoseNet as JaxSPN
    from speedplusbaseline_tpu_torch.config import parse_cfg
    from speedplusbaseline_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
    from speedplusbaseline_tpu_torch.data import SPNDataset
    from speedplusbaseline_tpu_torch.engine import (TrainState, build_optimizer,
                                                    make_spn_train_step)
    from speedplusbaseline_tpu_torch.models.spn import SpacecraftPoseNet

    print(precision_line(), f"torch {torch.__version__} threads {torch.get_num_threads()}",
          flush=True)
    cfg = parse_cfg(sweep.run_s_flags(args.root, 0, 1, os.path.join(args.root, "same_init"))
                    + ["--no_cuda"])
    ds = SPNDataset(cfg, is_train=True, is_source=True)
    B, nc, S = cfg.batch_size, cfg.num_classes, cfg.input_shape[0]
    batches = []
    for b in range(args.n_batches):
        items = [ds[b * B + i] for i in range(B)]
        batches.append({k: np.stack([it[k] for it in items]) for k in items[0]})
    fixed = batches[0]["image"].astype(np.float32) / 255.0
    kw = dict(model_name="spn", optimizer="adamw", lr=1e-3, weight_decay=0.01,
              num_classes=nc, input_shape=(S, S), lr_decay_step=3)
    result = {}
    for key in args.keys:
        jmodel = JaxSPN(nc, keep_prob=0.0)
        init = jax.device_get(jmodel.init({"params": jax.random.PRNGKey(key)},
                                          jnp.zeros((1, S, S, 3)), train=False)["params"])
        tx = jax_build_optimizer(jax_default_cfg(**kw), len(ds) // B)
        jstep = jax_make_step(jmodel, tx, jax_default_cfg(**kw))
        model = SpacecraftPoseNet(nc, 0.0, (S, S))
        model.load_state_dict(flax_to_state_dict(init, {}))
        model = model.to(memory_format=torch.channels_last)
        state = TrainState(model, build_optimizer(cfg, model.parameters()))
        step = make_spn_train_step(cfg, torch.device("cpu"))
        # JAX against itself from the init moved by one f32 ulp a weight: the
        # drift that f32 rounding alone gives these dynamics.
        ulp = jax.tree_util.tree_map(lambda a: np.nextafter(a, np.float32(np.inf)), init)
        jstates = {side: JaxTrainState(step=jnp.zeros((), jnp.int32),
                                       params=jax.tree_util.tree_map(jnp.asarray, p),
                                       batch_stats={}, opt_state=tx.init(p))
                   for side, p in (("jax", init), ("jax_ulp", ulp))}
        sides = ("jax", "port", "jax_ulp")
        curve = {side: [] for side in sides}
        live = {side: {} for side in sides}
        t0 = time.time()
        for i in range(args.steps + 1):
            if i in LIVE_AT:
                for side, js in jstates.items():
                    live[side][i] = jax_live_shares(jmodel, js.params, jnp.asarray(fixed))
                live["port"][i] = sweep.live_shares(
                    model, torch.from_numpy(fixed).permute(0, 3, 1, 2).contiguous(
                        memory_format=torch.channels_last))
            if i == args.steps:
                break
            batch = batches[i % args.n_batches]
            for side in jstates:
                jstates[side], jsm = jstep(jstates[side],
                                           {k: jnp.asarray(v) for k, v in batch.items()},
                                           jax.random.PRNGKey(key))
                curve[side].append(float(jsm["loss_c"]))
            sm = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, False)
            curve["port"].append(float(sm["loss_c"]))
            print(f"key {key} step {i:3d}  loss_c " + "  ".join(
                f"{side} {curve[side][-1]:.5f}" for side in sides)
                + f"  ({time.time() - t0:.0f} s)", flush=True)
        ref = dict(jax.tree_util.tree_leaves_with_path(jax.device_get(jstates["jax"].params)))
        start = dict(jax.tree_util.tree_leaves_with_path(init))
        others = {"port": state_dict_to_flax(model.state_dict())[0],
                  "jax_ulp": jax.device_get(jstates["jax_ulp"].params)}
        drift, gaps = {}, {}
        for side, tree in others.items():
            drift[side] = {}
            for path, v in jax.tree_util.tree_leaves_with_path(tree):
                gap = np.abs(np.asarray(v) - np.asarray(ref[path]))
                moved = np.abs(np.asarray(ref[path]) - np.asarray(start[path]))
                drift[side][jax.tree_util.keystr(path)] = {
                    "max_gap": float(gap.max()),
                    "share_past_drift": float((gap > DRIFT).mean()),
                    "rel_l2": float(np.linalg.norm(gap) / max(np.linalg.norm(moved), 1e-30))}
            gaps[side] = np.abs(np.array(curve[side]) - np.array(curve["jax"]))
            print(f"key {key}: {side} against jax: largest loss_c gap {gaps[side].max():.5f} "
                  f"(step {int(gaps[side].argmax())})")
        print(f"key {key}: live shares at {LIVE_AT}:")
        for side in sides:
            for s in sorted(live[side]):
                print(f"  {side:7s} {s:3d}  " + " ".join(
                    f"{n} {live[side][s][n]:.3f}" for n in sweep.LIVE_LAYERS))
        print(f"key {key}: per tensor after {args.steps} steps against jax: max gap, share "
              f"past {DRIFT:g}, gap L2 / move L2 (port | jax_ulp)")
        for name in drift["port"]:
            d, u = drift["port"][name], drift["jax_ulp"][name]
            print(f"  {name:22s} {d['max_gap']:.3e} {d['share_past_drift']:.2e} "
                  f"{d['rel_l2']:.3e} | {u['max_gap']:.3e} {u['share_past_drift']:.2e} "
                  f"{u['rel_l2']:.3e}")
        result[key] = {"loss_c": curve, "live": live, "drift": drift,
                       "max_loss_c_gap": {k: float(v.max()) for k, v in gaps.items()}}
    return result


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("sweep")
    s.add_argument("--root", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--seeds", type=int, nargs="+", default=[2021, 2, 0, 1, 3, 4])
    s.add_argument("--epochs", type=int, default=4)
    s = sub.add_parser("live")
    s.add_argument("--root", required=True)
    s.add_argument("--seed", type=int, required=True)
    s.add_argument("--epochs", type=int, default=4)
    s = sub.add_parser("same_init")
    s.add_argument("--root", required=True)
    s.add_argument("--keys", type=int, nargs="+", default=[2, 2021])
    s.add_argument("--steps", type=int, default=64)
    s.add_argument("--n_batches", type=int, default=4)
    args = p.parse_args(argv)
    result = {"sweep": cmd_sweep, "live": cmd_live, "same_init": cmd_same_init}[args.cmd](args)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
