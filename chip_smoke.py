#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``speedplusbaseline_tpu_torch``)
on one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device  -- the card's name and power limit (nvidia-smi);
  2. build   -- nvcc builds the hand-written kernels from csrc/, and
                cuobjdump counts the tensor-core (HGMMA) instructions of B1;
  3. kernels -- each kernel against its plain PyTorch version on the same
                inputs (TF32 off), f32 and bf16, at the shapes of both main
                paths (KRN at 224^2, SPN at 227^2, batch 48), with times
                (CUDA events), bounds and library-call times; B2 on both of
                its paths, with plan()'s path, the path run, the cut and the
                time of each site of both paths and the card's cluster
                occupancy; B1 + B2 per styled step of each model against
                their bound; then the whole Ghiasi generator on the card, in
                f32 and in bf16, against the plain f32 version on the CPU;
  4. geometry -- batched EPnP (``keypoints_to_pose``) on the card at batches
                of 48, 5 and 1: exact keypoints of random poses give
                acc == 1 for every sample, 1-px-noisy ones agree with the
                CPU, nothing is non-finite, and the call makes no host sync
                (``torch.cuda.set_sync_debug_mode("error")``); its device
                time per batch of 48;
  5. spn_geometry -- SPN's pose at batch 48 on the card against the CPU: the
                Gauss-Newton position from the true attitude and the exact
                box (also against ground truth), then top-k, softmax,
                weighted quaternion mean and position from a 5000-class
                weight head; no host sync; the CUDA graph replay equals the
                eager call; its device time;
  6. main, spn_main -- the styled trainer (``train.main``) of KRN at 224^2
                (6 steps) and of SPN at 227^2 with 5000 classes (4 steps),
                batch 48, AdamW, bf16, on a generated dataset of 1920x1200
                JPEGs, validating 100 test rows after its epoch
                (``--test_epoch 1``), then the test CLI (``test.main``) on
                the trainer's ``model_best.pt``, each with the launch
                counters set to 0 just before it and read just after; the
                two evaluations must agree;
  7. grl      -- the gradient reversal on the card: the gradient of the
                source domain loss with respect to the backbone map, taken
                through RevGrad at alpha 0.37, is -0.37 times the one taken
                through the domain classifier alone;
  8. dann     -- DANN adaptation from disk on data the port makes itself:
                its generator writes 64 + 64 synthetic and lightbox frames
                of 640x400, its preprocess CLI labels them on the card, and
                the adapt CLI (``adapt.main``) runs the README adapt recipe
                (224^2, batch 16 + 16, RMSprop, f32) for one epoch of 4
                steps with a validation of the 64 lightbox rows, then the
                test CLI with --perform_dann scores its model_best.pt (the
                two must agree); B1 and B2 must launch 0 times;
  9. pretrained -- the train CLI on converted pretrained assets: seeded
                torchvision-layout MobileNetV2, bvlc_alexnet and
                checkpoint_transformer weights go through the convert_weights
                CLI into an assets directory that SPEEDPLUS_ASSETS_DIR names;
                3 styled KRN steps at 224^2 and 2 styled SPN steps at 227^2
                (batch 48, bf16) must log the loads, start from the converted
                base / conv1-5 bit for bit, hold the converted Ghiasi convs in
                B1's HWIO buffers and launch B1 and B2; then the generator on
                those weights, kernels against plain;
 10. style_predictor -- the embedding CLI at its defaults (320x480, batch 8,
                f32) over 64 generated 640x400 frames with a seeded
                checkpoint_stylepredictor.pth converted by the convert_weights
                CLI, on the card and with --no_cuda (the three files must
                agree; B1 and B2 launch 0 times), and the StylePredictor's
                device time per batch of 8;
 11. resident, eval, spn_eval -- per model, the styled and plain train steps
                on a resident batch (host clock, and device busy time by
                torch.profiler), and the eval step (forward, geometry) as
                device time and on the host clock; the DANN step on resident
                batches of 16 + 16 in f32 and in bf16.
Then one JSON line with every kernel's numbers, the card line, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
result lines. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import logging
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

# Peak rates of one H100 SXM (NVIDIA data sheet, dense).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TENSOR_FLOPS = 989e12

B, S = 48, 224
# The six instance-norm sites of one Ghiasi forward at 224^2, batch 48:
# (layer, NHWC shape, FiLM, ReLU).
B2_SITES = (
    ("layer0", (B, S, S, 32), False, True),
    ("layer1", (B, S // 2, S // 2, 64), False, True),
    ("layer2", (B, S // 4, S // 4, 128), False, True),
    ("layer8", (B, S // 2, S // 2, 64), True, True),
    ("layer9", (B, S, S, 32), True, True),
    ("layer10", (B, S, S, 3), True, False),
)
B1_SHAPE = (B, S // 4, S // 4, 128)
B1_CALLS_PER_STEP = 5
# SPN's 227^2 through the generator: 227 -> 114 -> 57 (B1) -> 114 -> 228.
SPN_S, SPN_CLASSES, SPN_NEIGHBORS = 227, 5000, 5
SPN_B2_SITES = (
    ("layer0", (B, 227, 227, 32), False, True),
    ("layer1", (B, 114, 114, 64), False, True),
    ("layer2", (B, 57, 57, 128), False, True),
    ("layer8", (B, 114, 114, 64), True, True),
    ("layer9", (B, 228, 228, 32), True, True),
    ("layer10", (B, 228, 228, 3), True, False),
)
SPN_B1_SHAPE = (B, 57, 57, 128)
# B1's tensor-core passes per call from bf16 x: conv 1 x*w_hi + x*w_lo, conv 2
# a_hi*w_hi + a_hi*w_lo + a_lo*w_hi (split-bf16 operands, csrc/resblock.cu).
B1_PASSES = 5
# Clock cycles of the sleep kernel that holds the device while time_ms
# enqueues its calls (about 6 ms at the H100's 1.755 GHz boost clock), at
# least; time_ms lengthens the hold to twice the host's enqueue time, counted
# at the H100's highest clock (1.98 GHz), so the hold outlasts the enqueue.
HOLD_CYCLES = 10_000_000
MAX_CYCLES_PER_MS = 1.98e6
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 2.0 ** -6)}  # (atol, rtol)
TOL_B1_F32 = (5e-4, 1e-4)  # K = 1152-term sums of split-bf16 products, in another order
# The bf16 generator against the f32 one: bf16 activations through ten layers
# and a sigmoid in [0, 1]. 2^-6 is four bf16 ulps at the top of [0.5, 1), about
# twice what phase "kernels" reads on an H100.
TOL_GHIASI_BF16 = (2.0 ** -6, 0.0)
# The SPEED+ camera (1920x1200, 17.6 mm / 5.86 um pixels, tests/conftest.py).
FOCAL_PX = 0.0176 / 5.86e-6
CAMERA = {"cameraMatrix": [[FOCAL_PX, 0.0, 960.0], [0.0, FOCAL_PX, 600.0], [0.0, 0.0, 1.0]],
          "distCoeffs": [-0.22383016606510672, 0.51409797089106379, -0.00066499611998340662,
                         -0.00021404771667484594, -0.13124227429077406]}
# EPnP on the card against the CPU on 1-px-noisy keypoints: |dq|inf after sign
# alignment, |dt|inf in m. Both run one f32 algorithm, rounding apart in
# their sums; the refinements stop at one minimum. The bounds are about a
# tenth of the pose error that the 1-px noise itself causes (phase geometry
# prints both).
TOL_EPNP_CARD = (1e-4, 1e-3)
# SPN's position from the true attitude and the exact box against ground
# truth, in m (the CPU reads 2e-6 m at batch 48); SPN's pose on the card
# against the CPU, |dq|inf and |dt|inf in m, as for EPnP.
TOL_SPN_GT = 1e-4
TOL_SPN_CARD = (1e-4, 1e-3)
EVAL_ROWS = 100
# DANN: the README adapt recipe's batch per stream, the rows of each split
# the generator writes, and the reversal coefficient of phase grl.
DANN_B, DANN_ROWS, GRL_ALPHA = 16, 64, 0.37
TOL_GRL = 1e-6  # relative


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def tensor_core_instructions(name: str) -> int:
    """HGMMA instructions in lib<name>.so, from ``cuobjdump -sass``."""
    from speedplusbaseline_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    lib = os.path.join(_build.build_dir(), f"lib{name}.so")
    out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                         timeout=120, check=True)
    return out.stdout.count("HGMMA")


def time_ms(fn, reps: int = 20, hold: bool = True) -> float:
    """Device ms per call: CUDA events around ``reps`` calls after two warm-up
    calls. With ``hold``, a sleep kernel holds the device while the host
    enqueues the calls, so the events time the device's work and not the
    host's enqueue rate, which paces a call of a few tens of microseconds
    (without it: the method of the port's earlier PERF.md figures). When
    the hold ends before the host has enqueued every call (the host the card
    shares slowed down), it measures again with a hold twice as long, up to
    three times, then says so."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = max(HOLD_CYCLES, int(2 * enqueue_ms * reps * MAX_CYCLES_PER_MS))
    for _ in range(3):
        held, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        held.record()
        if hold:
            torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if not hold or held.elapsed_time(start) >= host_ms:
            break
        cycles *= 2
    else:
        print(f"  time_ms: the device hold ({held.elapsed_time(start):.1f} ms) ended before "
              f"the host enqueued {reps} calls ({host_ms:.1f} ms): host-paced", flush=True)
    return start.elapsed_time(end) / reps


def compare(name: str, got, ref, tol) -> float:
    import torch

    torch.cuda.synchronize()
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    atol, rtol = tol
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    max_err = err.max().item()
    print(f"  {name}: max_abs_err {max_err:.3e} (tol {atol:g} + {rtol:g}*|ref|)",
          flush=True)
    if bad.any():
        fail(f"{name}: {int(bad.sum())} elements outside tolerance")
    return max_err


def b2_sites(dev, g, sites, model: str):
    """B2 at each (layer, NHWC shape, FiLM, ReLU) site of one styled step of
    ``model``, bf16: checked against the plain version, timed, its path and
    cut printed beside plan()'s; fails if a site ran another path than its
    plan. Returns (per-step totals, site records, cluster configs, max err)."""
    import torch
    import torch.nn.functional as F

    from speedplusbaseline_tpu_torch.ops import instancenorm as inf

    tot = {"ms": 0.0, "paced_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    records, configs, err = [], set(), 0.0
    for layer, shape, film, relu in sites:
        p = inf.plan_on_card(shape, torch.bfloat16, dev)
        x = torch.rand(shape, device=dev, generator=g).to(torch.bfloat16)
        gam = torch.randn(shape[0], shape[3], device=dev, generator=g) if film else None
        bet = torch.randn(shape[0], shape[3], device=dev, generator=g) if film else None
        err = max(err, compare(f"B2 {model} {layer} {shape} bf16 film={film} relu={relu}",
                               inf.instance_norm_film(x, gam, bet, relu=relu),
                               inf.instance_norm_film_plain(x, gam, bet, relu=relu),
                               TOL["bfloat16"]))
        x_nchw = x.permute(0, 3, 1, 2)
        calls = dict(inf.path_calls)
        ms = time_ms(lambda: inf.instance_norm_film(x, gam, bet, relu=relu))
        ran = {k: v - calls[k] for k, v in inf.path_calls.items() if v != calls[k]}
        if list(ran) != [p.path]:
            fail(f"B2 {model} {layer}: planned the {p.path} path, ran {ran}")
        paced = time_ms(lambda: inf.instance_norm_film(x, gam, bet, relu=relu), hold=False)
        pms = time_ms(lambda: inf.instance_norm_film_plain(x, gam, bet, relu=relu))
        lms = time_ms(lambda: F.instance_norm(x_nchw, eps=1e-5))
        bound = max(inf.bytes_moved(shape, torch.bfloat16, film) / HBM_BYTES_PER_S,
                    inf.flops(shape) / F32_FLOPS) * 1e3
        cut = (f"K={p.k}, {p.block_bytes} B/block, {p.threads} threads" if p.path == "cluster"
               else f"{p.nchunks} chunks of {p.rows_per_chunk} rows")
        print(f"  B2 {model} {layer} {shape} bf16 film={film} relu={relu}: plan {p.path} "
              f"({cut}), ran {p.path}: kernel {ms:.4f} ms, bound {bound:.4f} ms (bytes), "
              f"{ms / bound:.2f}x bound; enqueue-paced {paced:.4f} ms; plain {pms:.4f} ms, "
              f"F.instance_norm {lms:.4f} ms", flush=True)
        records.append({"model": model, "layer": layer, "shape": list(shape), "path": p.path,
                        "k": p.k, "block_bytes": p.block_bytes, "ms": ms, "bound_ms": bound,
                        "x_bound": ms / bound, "paced_ms": paced})
        if p.path == "cluster":
            configs.add((p.k, p.threads, p.smem_bytes))
        for k, v in (("ms", ms), ("paced_ms", paced), ("plain_ms", pms), ("library_ms", lms),
                     ("bound_ms", bound)):
            tot[k] += v
    print(f"  B2 per {model} styled step: kernel {tot['ms']:.4f} ms, bound "
          f"{tot['bound_ms']:.4f} ms ({tot['bound_ms'] / tot['ms']:.0%} of bound); "
          f"enqueue-paced {tot['paced_ms']:.4f} ms", flush=True)
    return tot, records, configs, err


def b1_time(dev, args, shape, model: str):
    """B1 per call at ``shape`` in bf16 against its plain version, with its
    bound: (kernel ms, plain ms, bound ms, one-bf16-pass bound ms)."""
    import torch

    from speedplusbaseline_tpu_torch.ops import resblock as rb

    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
    ms = time_ms(lambda: rb.ghiasi_resblock(x, *args), 10)
    pms = time_ms(lambda: rb.ghiasi_resblock_plain(x, *args), 10)
    by_split = rb.flops(shape, B1_PASSES) / BF16_TENSOR_FLOPS * 1e3
    by_bytes = rb.bytes_moved(shape, torch.bfloat16) / HBM_BYTES_PER_S * 1e3
    by_tc = max(rb.flops(shape) / BF16_TENSOR_FLOPS * 1e3, by_bytes)
    by_f32 = rb.flops(shape) / F32_FLOPS * 1e3
    print(f"  B1 {model} {shape} bf16: kernel {ms:.4f} ms/call, plain {pms:.4f} ms/call, "
          f"bound {max(by_split, by_bytes):.4f} ms (operations: {B1_PASSES} split-bf16 "
          f"passes on the tensor cores; bytes {by_bytes:.4f} ms; one bf16 pass "
          f"{by_tc:.4f} ms; f32 on the CUDA cores {by_f32:.4f} ms)", flush=True)
    return ms, pms, max(by_split, by_bytes), by_tc


def phase_kernels(dev):
    import torch

    from speedplusbaseline_tpu_torch.ops import instancenorm as inf
    from speedplusbaseline_tpu_torch.ops import resblock as rb

    g = torch.Generator(device=dev).manual_seed(0)
    dtypes = (torch.float32, torch.bfloat16)
    report = {}

    # B2: every KRN site shape, an odd one, and shapes of the two-pass path
    # (no 16-byte split; a plane just past what 16 cluster blocks hold); input
    # mean is 10x its std.
    print("phase kernels: B2 instance_norm_film vs instance_norm_film_plain", flush=True)
    err_b2 = 0.0
    shapes = [s[1] for s in B2_SITES[:3]] + [B2_SITES[5][1], (3, 57, 41, 128), (3, 9, 7, 3),
                                              (2, 237, 237, 32)]
    paths = set()
    for shape in shapes:
        for dt in dtypes:
            p = inf.plan_on_card(shape, dt, dev)
            paths.add(p.path)
            x = (torch.randn(shape, device=dev, generator=g) * 0.5 + 5.0).to(dt)
            gam = torch.randn(shape[0], shape[3], device=dev, generator=g)
            bet = torch.randn(shape[0], shape[3], device=dev, generator=g)
            for film, relu in ((False, False), (True, True), (True, False)):
                args = (gam, bet) if film else (None, None)
                err_b2 = max(err_b2, compare(
                    f"B2 {shape} {str(dt)[6:]} {p.path} film={film} relu={relu}",
                    inf.instance_norm_film(x, *args, relu=relu),
                    inf.instance_norm_film_plain(x, *args, relu=relu),
                    TOL[str(dt)[6:]]))
    if paths != {"cluster", "two_pass"}:
        fail(f"B2 checks reached only the {paths} path(s)")
    tot, sites, configs, err = b2_sites(dev, g, B2_SITES, "krn")
    spn_tot, spn_sites, spn_configs, spn_err = b2_sites(dev, g, SPN_B2_SITES, "spn")
    for k, threads, smem in sorted(configs | spn_configs):
        n = inf.max_active_clusters(dev.index or 0, torch.bfloat16, k, threads, smem)
        print(f"  B2 cudaOccupancyMaxActiveClusters: {n} clusters of {k} blocks x {threads} "
              f"threads x {smem} B shared memory (bf16)", flush=True)
    report["instance_norm_film"] = {"max_abs_err": max(err_b2, err, spn_err), "bound_by": "bytes",
                                    "bound_basis": "one read of x and one write of y at "
                                                   "the HBM rate",
                                    "bound_ms_bf16_tensor_core": None,
                                    "sites": sites + spn_sites, **tot, "spn": spn_tot}

    print("phase kernels: B1 ghiasi_resblock vs ghiasi_resblock_plain", flush=True)
    err_b1 = 0.0

    def block_args(shape):
        C = shape[3]
        ws = 1.0 / math.sqrt(9 * C)
        return ([torch.randn(3, 3, C, C, device=dev, generator=g) * ws,
                 torch.randn(C, device=dev, generator=g) * 0.1,
                 torch.randn(3, 3, C, C, device=dev, generator=g) * ws,
                 torch.randn(C, device=dev, generator=g) * 0.1]
                + [torch.randn(shape[0], C, device=dev, generator=g) for _ in range(4)])

    for shape in (B1_SHAPE, SPN_B1_SHAPE, (2, 57, 57, 128), (2, 8, 8, 128), (2, 9, 9, 128),
                  (1, 13, 6, 40)):
        args = block_args(shape)
        for dt in dtypes:
            x = torch.randn(shape, device=dev, generator=g).to(dt)
            tol = TOL_B1_F32 if dt == torch.float32 else TOL["bfloat16"]
            err_b1 = max(err_b1, compare(f"B1 {shape} {str(dt)[6:]}",
                                         rb.ghiasi_resblock(x, *args),
                                         rb.ghiasi_resblock_plain(x, *args), tol))
    n = B1_CALLS_PER_STEP
    per = {}
    for model, shape in (("krn", B1_SHAPE), ("spn", SPN_B1_SHAPE)):
        ms, pms, bound, by_tc = b1_time(dev, block_args(shape), shape, model)
        per[model] = {"ms": n * ms, "plain_ms": n * pms, "bound_ms": n * bound,
                      "bound_ms_bf16_tensor_core": n * by_tc, "library_ms": None}
    report["ghiasi_resblock"] = {"max_abs_err": err_b1, "bound_by": "operations",
                                 "bound_basis": f"{B1_PASSES} split-bf16 passes at the "
                                                "bf16 tensor-core peak",
                                 **per["krn"], "spn": per["spn"]}
    for model, b2, b1 in (("krn", tot, per["krn"]), ("spn", spn_tot, per["spn"])):
        ms, bound = b2["ms"] + b1["ms"], b2["bound_ms"] + b1["bound_ms"]
        print(f"phase kernels: B1 + B2 per {model} styled step (batch {B}): kernel {ms:.4f} ms, "
              f"bound {bound:.4f} ms ({bound / ms:.0%} of bound)", flush=True)
    return report


def phase_ghiasi(dev, sd, weights: str):
    """The whole generator with the state dict ``sd`` (``weights`` names it):
    kernels on the card, in f32 and in bf16 (the main path's dtype), vs the
    plain f32 version on the CPU."""
    import torch

    from speedplusbaseline_tpu_torch.models.ghiasi import Ghiasi

    net_cpu = Ghiasi().eval()
    net_cpu.load_state_dict(sd)
    g = torch.Generator().manual_seed(1)
    x = torch.rand(2, 3, S, S, generator=g)
    st = torch.randn(2, 100, generator=g) * 0.5
    with torch.no_grad():
        ref = net_cpu(x, st)
    for dtype, tol in ((torch.float32, (1e-3, 1e-3)), (torch.bfloat16, TOL_GHIASI_BF16)):
        net_gpu = Ghiasi(dtype).to(dev).eval()
        net_gpu.load_state_dict(sd)
        with torch.no_grad():
            got = net_gpu(x.to(dev), st.to(dev)).float().cpu()
        name = (f"Ghiasi (2, 3, 224, 224) {str(dtype)[6:]}, {weights}, card kernels vs CPU "
                "plain f32")
        compare(name, got, ref, tol)
        mean_err = (got - ref).abs().mean().item()
        print(f"  {name}: mean_abs_err {mean_err:.3e}", flush=True)


def random_poses(rs, n: int):
    """Scalar-first unit quaternions and positions 3.5-9 m in front of the
    camera (tests/conftest.py::random_pose), as float32 arrays."""
    import numpy as np

    q = rs.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[q[:, 0] < 0] *= -1.0
    t = np.stack([rs.uniform(-0.6, 0.6, n), rs.uniform(-0.4, 0.4, n),
                  rs.uniform(3.5, 9.0, n)], 1)
    return q.astype(np.float32), t.astype(np.float32)


def project(q, t):
    """Pixel keypoints (B, 11, 2) of the Tango points at poses (q, t), by the
    port's projection on the CPU."""
    import torch

    from speedplusbaseline_tpu_torch.geometry import project_keypoints
    from speedplusbaseline_tpu_torch.io_utils import load_tango_3d_keypoints

    return project_keypoints(torch.from_numpy(q), torch.from_numpy(t),
                             torch.tensor(CAMERA["cameraMatrix"]),
                             torch.tensor(CAMERA["distCoeffs"]),
                             torch.from_numpy(load_tango_3d_keypoints())).mT.numpy()


def eval_crop(uv):
    """RoI-normalized keypoints (x, y) and crop boxes of the eval crop (the
    tight box enlarged 1.2x, square, clamped to the frame:
    data/transforms.py::crop_params)."""
    import numpy as np

    from speedplusbaseline_tpu_torch.data.transforms import crop_params

    boxes = np.array([crop_params(None, [u[:, 0].min(), u[:, 0].max(), u[:, 1].min(),
                                         u[:, 1].max()], 1920, 1200, False) for u in uv],
                     np.float32)
    x = (uv[..., 0] - boxes[:, 0:1]) / (boxes[:, 1:2] - boxes[:, 0:1])
    y = (uv[..., 1] - boxes[:, 2:3]) / (boxes[:, 3:4] - boxes[:, 2:3])
    return x.astype(np.float32), y.astype(np.float32), boxes


def linalg_syncs(dev) -> None:
    """Print which torch.linalg calls the geometry could use synchronize
    with the host on this card (why geometry/_eigh.py exists)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn(48, 6, 6, device=dev, generator=g)
    A = A @ A.mT + torch.eye(6, device=dev)
    b = torch.randn(48, 6, 1, device=dev, generator=g)
    calls = {"eigh": lambda: torch.linalg.eigh(A), "svd": lambda: torch.linalg.svd(A),
             "solve": lambda: torch.linalg.solve(A, b), "inv": lambda: torch.linalg.inv(A),
             "solve_ex": lambda: torch.linalg.solve_ex(A, b, check_errors=False),
             "inv_ex": lambda: torch.linalg.inv_ex(A, check_errors=False)}
    syncs = []
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        except RuntimeError:
            syncs.append(name)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"phase geometry: torch.linalg calls that sync with the host here: {syncs} "
          f"(of {list(calls)})", flush=True)


def phase_geometry(dev):
    """keypoints_to_pose on the card at batches of 48, 5 and 1."""
    import numpy as np
    import torch

    from speedplusbaseline_tpu_torch.geometry import keypoints_to_pose
    from speedplusbaseline_tpu_torch.io_utils import load_tango_3d_keypoints
    from speedplusbaseline_tpu_torch.metrics import speed_score_batched

    linalg_syncs(dev)

    rs = np.random.RandomState(3)
    consts = [torch.from_numpy(load_tango_3d_keypoints()), torch.tensor(CAMERA["cameraMatrix"]),
              torch.tensor(CAMERA["distCoeffs"])]
    consts_dev = [c.to(dev) for c in consts]
    for n in (B, 5, 1):
        q, t = random_poses(rs, n)
        uv = project(q, t)
        for noise in (0.0, 1.0):
            x, y, box = (torch.from_numpy(a) for a in eval_crop(
                uv + rs.randn(*uv.shape).astype(np.float32) * noise))
            args = [a.to(dev) for a in (x, y, box)] + consts_dev
            keypoints_to_pose(*args)  # makes the cached index tensors
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                q_pr, t_pr = keypoints_to_pose(*args)
            except RuntimeError as e:
                fail(f"geometry B={n}: keypoints_to_pose synchronized with the host: {e}")
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            if not (torch.isfinite(q_pr).all() and torch.isfinite(t_pr).all()):
                fail(f"geometry B={n} noise={noise}: non-finite pose")
            m = speed_score_batched(t_pr, q_pr, torch.from_numpy(t).to(dev),
                                    torch.from_numpy(q).to(dev))
            err_q, err_t = m["err_q"].max().item(), m["err_t"].max().item()
            if noise == 0.0:
                if m["acc"].min().item() != 1.0:
                    fail(f"geometry B={n}: exact keypoints missed the thresholds on "
                         f"{int((m['acc'] < 1).sum())} samples (max eR {err_q:.4f} deg)")
                print(f"phase geometry: B={n}, exact keypoints: acc 1 on every sample, max eR "
                      f"{err_q:.4f} deg, max eT {err_t:.2e} m; no host sync", flush=True)
                continue
            q_cpu, t_cpu = keypoints_to_pose(x, y, box, *consts)
            q_pr, t_pr = q_pr.cpu(), t_pr.cpu()
            dq = (q_pr * torch.sign((q_pr * q_cpu).sum(1, keepdim=True)) - q_cpu).abs().max()
            dt = (t_pr - t_cpu).abs().max()
            print(f"phase geometry: B={n}, 1-px noise: card vs CPU |dq| {dq:.2e} (tol "
                  f"{TOL_EPNP_CARD[0]:g}), |dt| {dt:.2e} m (tol {TOL_EPNP_CARD[1]:g}); "
                  f"the noise's own max eR {err_q:.4f} deg, eT {err_t:.4f} m; no host sync",
                  flush=True)
            if dq > TOL_EPNP_CARD[0] or dt > TOL_EPNP_CARD[1]:
                fail(f"geometry B={n}: the card disagrees with the CPU")
            if n == B:
                time_geometry(args)


def time_geometry(args):
    """keypoints_to_pose at batch 48: its device time, replayed from a CUDA
    graph with the device held (one launch a call, so the hold covers the
    enqueue), and its time as called eagerly (CUDA events, no hold: the
    host enqueues thousands of small kernels a call, more than the launch
    queue holds, so no hold can cover them and this is the host's rate)."""
    import torch

    from speedplusbaseline_tpu_torch.engine.steps import CudaGraphed
    from speedplusbaseline_tpu_torch.geometry import keypoints_to_pose

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        keypoints_to_pose(*args)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    graphed = CudaGraphed(lambda *a: dict(zip("qt", keypoints_to_pose(*a))))
    q_e, t_e = keypoints_to_pose(*args)
    out = graphed(*args)
    if not (torch.equal(out["q"], q_e) and torch.equal(out["t"], t_e)):
        fail("geometry: the graph replay differs from the eager call")
    ms = time_ms(lambda: graphed(*args), reps=20)
    eager_ms = time_ms(lambda: keypoints_to_pose(*args), reps=5, hold=False)
    print(f"phase geometry: keypoints_to_pose at batch {args[0].shape[0]}: {kernels} device "
          f"kernels a call (torch.profiler); device time {ms:.3f} ms (CUDA graph replay, "
          f"device held); called eagerly {eager_ms:.3f} ms (host-paced); the graph replay "
          "equals the eager call bit for bit", flush=True)


def tight_boxes(uv):
    """(B, 4) [xmin, xmax, ymin, ymax] of pixel keypoints (B, N, 2)."""
    import numpy as np

    return np.stack([uv[..., 0].min(1), uv[..., 0].max(1), uv[..., 1].min(1),
                     uv[..., 1].max(1)], 1).astype(np.float32)


def no_sync(fn, what: str):
    """fn() with ``set_sync_debug_mode("error")``: fails if it synchronizes."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    except RuntimeError as e:
        fail(f"{what} synchronized with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)


def phase_spn_geometry(dev):
    """SPN's pose on the card at batch 48 against the CPU on the same inputs:
    the Gauss-Newton position from the true attitude and the exact box of
    the projected Tango points (against ground truth too), then the whole
    pose from a weight head (top-k, softmax, weighted mean of the class
    quaternions, position); no host sync; the graph replay equals the eager
    call; device time."""
    import numpy as np
    import torch

    from speedplusbaseline_tpu_torch.engine.steps import CudaGraphed, spn_pose
    from speedplusbaseline_tpu_torch.geometry import compute_position_spn_batched
    from speedplusbaseline_tpu_torch.io_utils import (load_attitude_classes,
                                                      load_tango_3d_keypoints)

    rs = np.random.RandomState(6)
    q, t = random_poses(rs, B)
    box = tight_boxes(project(q, t))
    consts = [torch.from_numpy(load_tango_3d_keypoints()), torch.tensor(CAMERA["cameraMatrix"]),
              torch.tensor(CAMERA["distCoeffs"])]
    consts_dev = [c.to(dev) for c in consts]
    q_class = torch.from_numpy(load_attitude_classes())

    args = [torch.from_numpy(q), torch.from_numpy(box)]
    t_cpu = compute_position_spn_batched(*args, *consts)
    args_dev = [a.to(dev) for a in args] + consts_dev
    compute_position_spn_batched(*args_dev)
    t_gpu = no_sync(lambda: compute_position_spn_batched(*args_dev),
                    "spn_geometry: compute_position_spn_batched").cpu()
    gt = np.abs(t_gpu.numpy() - t).max()
    dt = (t_gpu - t_cpu).abs().max().item()
    print(f"phase spn_geometry: B={B}, true attitude and exact box: position vs ground truth "
          f"|dt| {gt:.2e} m (tol {TOL_SPN_GT:g}), card vs CPU |dt| {dt:.2e} m (tol "
          f"{TOL_SPN_CARD[1]:g}); no host sync", flush=True)
    if not np.isfinite(gt) or gt > TOL_SPN_GT or dt > TOL_SPN_CARD[1]:
        fail("spn_geometry: the position misses the ground truth or the CPU")

    # A weight head whose top class is the true attitude's nearest bin.
    logits = torch.randn(B, SPN_CLASSES, generator=torch.Generator().manual_seed(7))
    near = torch.from_numpy(quat_bins(q, q_class.numpy(), 1)[0][:, 0].astype(np.int64))
    logits[torch.arange(B), near] += 8.0
    pose_args = [logits, torch.from_numpy(box)]
    q_cpu, t_cpu = spn_pose(*pose_args, q_class, *consts, SPN_NEIGHBORS)
    dev_args = [a.to(dev) for a in pose_args] + [q_class.to(dev)] + consts_dev
    spn_pose(*dev_args, SPN_NEIGHBORS)
    q_gpu, t_gpu = no_sync(lambda: spn_pose(*dev_args, SPN_NEIGHBORS), "spn_geometry: spn_pose")
    graphed = CudaGraphed(lambda *a: dict(zip("qt", spn_pose(*a, SPN_NEIGHBORS))))
    out = graphed(*dev_args)
    out = graphed(*dev_args)  # a replay
    if not (torch.equal(out["q"], q_gpu) and torch.equal(out["t"], t_gpu)):
        fail("spn_geometry: the graph replay differs from the eager call")
    q_gpu, t_gpu = q_gpu.cpu(), t_gpu.cpu()
    if not (torch.isfinite(q_gpu).all() and torch.isfinite(t_gpu).all()):
        fail("spn_geometry: non-finite pose")
    dq = (q_gpu * torch.sign((q_gpu * q_cpu).sum(1, keepdim=True)) - q_cpu).abs().max().item()
    dt = (t_gpu - t_cpu).abs().max().item()
    print(f"phase spn_geometry: B={B}, pose from a {SPN_CLASSES}-class weight head (top "
          f"{SPN_NEIGHBORS}): card vs CPU |dq| {dq:.2e} (tol {TOL_SPN_CARD[0]:g}), |dt| "
          f"{dt:.2e} m (tol {TOL_SPN_CARD[1]:g}); no host sync; the graph replay equals the "
          "eager call bit for bit", flush=True)
    if dq > TOL_SPN_CARD[0] or dt > TOL_SPN_CARD[1]:
        fail("spn_geometry: the card disagrees with the CPU")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        spn_pose(*dev_args, SPN_NEIGHBORS)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    ms = time_ms(lambda: graphed(*dev_args), reps=20)
    eager_ms = time_ms(lambda: spn_pose(*dev_args, SPN_NEIGHBORS), reps=5, hold=False)
    print(f"phase spn_geometry: spn_pose at batch {B}: {kernels} device kernels a call "
          f"(torch.profiler); device time {ms:.3f} ms (CUDA graph replay, device held); "
          f"called eagerly {eager_ms:.3f} ms (host-paced)", flush=True)


def quat_bins(q, q_class, n: int):
    """The nearest ``n`` attitude classes of each quaternion in q (B, 4) and
    their weights, by the port's ``data/preprocess.py::get_quat_bins``, one
    row per q."""
    import numpy as np

    from speedplusbaseline_tpu_torch.data import get_quat_bins

    bins = [get_quat_bins(qi, q_class.astype(np.float64), n) for qi in q]
    return np.stack([c for c, _ in bins]), np.stack([w for _, w in bins])


def write_images(base: str, rs, n_images: int):
    """``n_images`` random 1920x1200 JPEGs under base/images; their names."""
    import cv2
    import numpy as np

    os.makedirs(os.path.join(base, "images"), exist_ok=True)
    names = []
    for i in range(n_images):
        small = rs.randint(0, 256, (30, 48, 3), dtype=np.uint8)
        img = cv2.resize(small, (1920, 1200), interpolation=cv2.INTER_CUBIC)
        name = f"img{i:06d}.jpg"
        cv2.imwrite(os.path.join(base, "images", name), img,
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
        names.append(name)
    return names


def write_csv(path: str, rows) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for row in rows:
            f.write(", ".join(str(v) for v in row) + "\n")


def write_dataset(root: str, model: str, n_rows: int, n_images: int = 48, seed: int = 0) -> None:
    """The CSVs of ``model`` + 1920x1200 JPEGs in the layout
    data/csv_dataset.py reads, and camera.json: the train CSV of ``n_rows``
    rows and the ``lightbox.csv`` test CSV of EVAL_ROWS rows whose pose, box
    (and KRN keypoints) are the Tango points projected at random poses. KRN's
    train rows have random boxes and keypoints; SPN's are projected poses
    too, with their nearest SPN_NEIGHBORS attitude classes and weights."""
    import numpy as np

    from speedplusbaseline_tpu_torch.io_utils import load_attitude_classes

    rs = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "speedplus"), exist_ok=True)
    with open(os.path.join(root, "speedplus", "camera.json"), "w") as f:
        json.dump(CAMERA, f)
    base = os.path.join(root, "speedplus", "synthetic")
    names = write_images(base, rs, n_images)
    splits = f"splits_{model}"

    def pose_rows(n):
        q, t = random_poses(rs, n)
        uv = project(q, t)
        box = tight_boxes(uv)
        if model == "krn":
            labels = uv.reshape(n, -1)
        else:
            classes, weights = quat_bins(q, load_attitude_classes(), SPN_NEIGHBORS)
            labels = np.concatenate([classes, weights], 1)
        return [[f"synthetic/images/{names[r % n_images]}"] + box[r].tolist() + q[r].tolist()
                + t[r].tolist() + labels[r].tolist() for r in range(n)]

    if model == "krn":
        rows = []
        for r in range(n_rows):
            cx, cy = rs.uniform(500, 1420), rs.uniform(400, 800)
            half = rs.uniform(100, 300)
            kx = rs.uniform(cx - half, cx + half, 11)
            ky = rs.uniform(cy - half, cy + half, 11)
            q = rs.randn(4)
            q /= np.linalg.norm(q)
            t = [rs.uniform(-0.3, 0.3), rs.uniform(-0.2, 0.2), rs.uniform(3, 6)]
            rows.append([f"synthetic/images/{names[r % n_images]}", kx.min(), kx.max(),
                         ky.min(), ky.max()] + q.tolist() + t
                        + np.stack([kx, ky], 1).reshape(-1).tolist())
    else:
        rows = pose_rows(n_rows)
    write_csv(os.path.join(base, splits, "train.csv"), rows)
    write_csv(os.path.join(root, "speedplus", "lightbox", splits, "lightbox.csv"),
              pose_rows(EVAL_ROWS))


# Per model: (phase name, input side, the flags beyond the common ones, the
# loss terms of a step). SPN's classes are the default --attitude_class's
# fallback, assets/attitude_classes.npy.
MAIN = {"krn": ("main", S, [], ("loss_x", "loss_y")),
        "spn": ("spn_main", SPN_S, ["--num_classes", str(SPN_CLASSES)], ("loss_c", "loss_r"))}


def phase_main(dev, model: str, steps: int):
    """The styled trainer of ``model`` from disk at full width, batch 48,
    AdamW, bf16, validating EVAL_ROWS rows after its epoch, then the test CLI
    on its model_best.pt; the two evaluations must agree. Returns the kernel
    launches of the training run."""
    import numpy as np
    import torch

    from speedplusbaseline_tpu_torch import train
    from speedplusbaseline_tpu_torch.ops import _build

    phase, side, extra, losses = MAIN[model]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        write_dataset(tmp, model, steps * B)
        print(f"phase {phase}: dataset of {steps * B} rows written in "
              f"{time.time() - t0:.1f} s", flush=True)
        common = ["--dataroot", tmp, "--model_name", model, "--input_shape", str(side),
                  str(side), "--use_fp16", "--num_workers", "8", "--eval_batch_size",
                  str(B)] + extra
        argv = common + ["--savedir", os.path.join(tmp, "save"),
                         "--logdir", os.path.join(tmp, "log"), "--batch_size", str(B),
                         "--optimizer", "adamw", "--lr", "0.001", "--weight_decay", "0.01",
                         "--randomize_texture", "--texture_ratio", "1.0",
                         "--max_epochs", "1", "--start_over", "--test_epoch", "1"]
        _build.reset_launches()
        t0 = time.time()
        records = train.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(_build.launches)
        print("", flush=True)
        if len(records) != steps:
            fail(f"{phase} ran {len(records)} steps, expected {steps}")
        loss = [sum(r[k] for k in losses) for r in records]
        if not all(np.isfinite(loss)):
            fail(f"{phase}: non-finite loss in {loss}")
        if not all(r["styled"] for r in records):
            fail(f"{phase}: texture_ratio 1.0 left a step unstyled")
        for f in ("checkpoint.pt", "model_best.pt"):
            if not os.path.exists(os.path.join(tmp, "save", f)):
                fail(f"{phase}: no {f} written")
        if (launches["ghiasi_resblock"] < B1_CALLS_PER_STEP * steps
                or launches["instance_norm_film"] < 6 * steps):
            fail(f"{phase}: kernel launches {launches} too few for {steps} styled steps")
        ms = [r["ms"] for r in records[1:]]
        step_ms = statistics.median(ms)
        print(f"phase {phase}: {steps} styled {model} steps at {side}^2, losses "
              f"{[round(v, 4) for v in loss]} ({' + '.join(losses)}), launches {launches}, "
              f"wall {wall:.1f} s incl. set-up", flush=True)
        print(f"phase {phase}: step ms after the first {[round(v, 2) for v in ms]}; median "
              f"{step_ms:.2f} ms = {B * 1000 / step_ms:.1f} img/s (from disk, "
              f"8 loader threads)", flush=True)
        check_validation_and_test_cli(phase, tmp, common, losses, EVAL_ROWS, "trainer")
    return launches


def check_validation_and_test_cli(phase: str, tmp: str, common, losses, rows: int,
                                  trainer: str) -> None:
    """After a training CLI's run that validated ``rows`` rows into
    tmp/log: its dumps, its train/ loss scalars and its Valid/ scalars (the
    dumps' means); then the test CLI on tmp/save/model_best.pt with the
    ``common`` flags must give the same numbers."""
    import numpy as np
    import torch

    from speedplusbaseline_tpu_torch import test
    from speedplusbaseline_tpu_torch.ops import _build

    valid = check_eval(os.path.join(tmp, "log"), f"{trainer}'s validation", phase, rows)
    with open(os.path.join(tmp, "log", "scalars.jsonl")) as f:
        tags = {r["tag"]: r["value"] for r in map(json.loads, f)}
    if not {f"train/{k}" for k in losses} <= set(tags):
        fail(f"{phase}: the train/ loss scalars {losses} are missing from {sorted(tags)}")
    for name, tag in VALID_TAGS.items():
        # the dumps are printed to 1e-5; the meters average f32 batch means
        if tag not in tags or not math.isclose(tags[tag], valid[name].mean(), rel_tol=1e-6,
                                               abs_tol=1e-5):
            fail(f"{phase}: {trainer}'s validation: scalar {tag!r} missing or not the "
                 "dumps' mean")

    # The test CLI on the trained weights: the same rows, the same numbers.
    _build.reset_launches()
    t0 = time.time()
    meters = test.main(common + ["--savedir", os.path.join(tmp, "save"),
                                 "--logdir", os.path.join(tmp, "log_test"),
                                 "--resultfn", "results.txt", "--pretrained",
                                 os.path.join(tmp, "save", "model_best.pt")])
    torch.cuda.synchronize()
    wall = time.time() - t0
    test_launches = dict(_build.launches)
    tested = check_eval(os.path.join(tmp, "log_test"), "test CLI", phase, rows)
    with open(os.path.join(tmp, "log_test", "results.txt")) as f:
        results = f.read().splitlines()
    if [r.split(":")[0] for r in results] != list(VALID_TAGS):
        fail(f"{phase}: results.txt holds {results}")
    for name in VALID_TAGS:
        if not math.isclose(meters[name].avg, tags[VALID_TAGS[name]], rel_tol=1e-4):
            fail(f"{phase}: test CLI {name} {meters[name].avg} != {trainer}'s validation "
                 f"{tags[VALID_TAGS[name]]}")
    print(f"phase {phase}: test CLI on model_best.pt: {results}; agrees with the "
          f"{trainer}'s validation (rel 1e-4; dumps max diff "
          f"{max(np.abs(tested[k] - valid[k]).max() for k in DUMPS):.2e}); launches "
          f"{test_launches}, wall {wall:.1f} s incl. set-up", flush=True)


def phase_grl(dev) -> None:
    """The gradient reversal on the card, one batch of 2 at 224^2 in f32:
    d loss_source / d backbone map through RevGrad at GRL_ALPHA equals
    -GRL_ALPHA times the same gradient through the domain classifier alone."""
    import torch

    from speedplusbaseline_tpu_torch.models import RevGrad, bce_with_logits

    torch.manual_seed(0)
    model = RevGrad(11, (S, S)).to(dev, memory_format=torch.channels_last).train()
    x = torch.rand(2, 3, S, S, device=dev, generator=torch.Generator(device=dev).manual_seed(5))
    x = x.contiguous(memory_format=torch.channels_last)
    maps = []
    hook = model.net.base.register_forward_hook(lambda mod, inp, out: maps.append(out[0]))
    try:
        _, dom = model(x, GRL_ALPHA)
    finally:
        hook.remove()
    (g_rev,) = torch.autograd.grad(bce_with_logits(dom, torch.ones_like(dom)), maps[0])
    leaf = maps[0].detach().requires_grad_()
    dom_plain = model.domain_classifier(leaf.float())
    (g,) = torch.autograd.grad(bce_with_logits(dom_plain, torch.ones_like(dom_plain)), leaf)
    scale = (GRL_ALPHA * g).abs().max().item()
    err = (g_rev + GRL_ALPHA * g).abs().max().item() / scale
    print(f"phase grl: d loss_source / d backbone map {tuple(g.shape)} through RevGrad at "
          f"alpha {GRL_ALPHA} vs -{GRL_ALPHA} x through the domain classifier alone: max "
          f"rel err {err:.2e} (tol {TOL_GRL:g}; gradient scale {scale:.3e})", flush=True)
    if not (math.isfinite(err) and scale > 0 and err <= TOL_GRL):
        fail("grl: the reversed gradient is not -alpha times the domain gradient")


def phase_dann(dev):
    """The adapt CLI from disk at full width on data the port generated and
    labelled, then the test CLI with --perform_dann on its model_best.pt.
    Returns the kernel launches of the adapt run (B1 and B2 must be 0: the
    DANN step has no restyle)."""
    import numpy as np
    import torch

    from speedplusbaseline_tpu_torch import adapt, preprocess
    from speedplusbaseline_tpu_torch.data import generate_fake_speedplus
    from speedplusbaseline_tpu_torch.ops import _build

    losses = ("loss_pose", "loss_source", "loss_target")
    steps = DANN_ROWS // DANN_B
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        generate_fake_speedplus(tmp, num_train=DANN_ROWS, num_test=DANN_ROWS, width=640,
                                height=400, device=dev)
        for domain, jsonfile, csv in (("synthetic", "train.json", "splits_krn/train.csv"),
                                      ("lightbox", "test.json", "splits_krn/lightbox.csv")):
            preprocess.main(["--dataroot", tmp, "--domain", domain, "--jsonfile", jsonfile,
                             "--csvfile", csv])
        print(f"phase dann: the port's generator and preprocess CLI wrote 2 x {2 * DANN_ROWS} "
              f"frames of 640x400 and their CSVs in {time.time() - t0:.1f} s", flush=True)
        # The README adapt recipe (224^2, RMSprop, f32), one epoch.
        common = ["--dataroot", tmp, "--perform_dann", "--num_workers", "8"]
        argv = common + ["--savedir", os.path.join(tmp, "save"),
                         "--logdir", os.path.join(tmp, "log"), "--batch_size", str(DANN_B),
                         "--max_epochs", "1", "--test_epoch", "1", "--start_over"]
        _build.reset_launches()
        t0 = time.time()
        records = adapt.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(_build.launches)
        print("", flush=True)
        if len(records) != steps:
            fail(f"dann ran {len(records)} steps, expected {steps}")
        if not all(np.isfinite(r[k]) for r in records for k in losses):
            fail(f"dann: non-finite loss in {records}")
        for f in ("checkpoint.pt", "model_best.pt"):
            if not os.path.exists(os.path.join(tmp, "save", f)):
                fail(f"dann: no {f} written")
        if any(launches.values()):
            fail(f"dann: the DANN step has no restyle, but the kernels launched {launches}")
        ms = [r["ms"] for r in records[1:]]
        print(f"phase dann: {steps} DANN steps at {S}^2, batch {DANN_B} + {DANN_B}, RMSprop, "
              f"f32: alpha {[round(r['alpha'], 4) for r in records]}, losses "
              f"{[[round(r[k], 4) for k in losses] for r in records]} ({', '.join(losses)}), "
              f"launches {launches}, wall {wall:.1f} s incl. set-up", flush=True)
        print(f"phase dann: step ms after the first {[round(v, 2) for v in ms]}; median "
              f"{statistics.median(ms):.2f} ms (from disk, 8 loader threads)", flush=True)
        check_validation_and_test_cli("dann", tmp, common, losses, DANN_ROWS, "adapt CLI")
    return launches


def torchvision_mobilenet_v2(g):
    """A seeded state_dict in torchvision ``mobilenet_v2``'s layout: the stem
    features.0, the 17 inverted residuals, the final 1280-channel conv
    (features.18) and the classifier, with ``num_batches_tracked``."""
    import torch

    from speedplusbaseline_tpu_torch.models.mobilenetv2 import _IR_SETTINGS

    sd = {}

    def conv(name, o, i, k):
        sd[f"{name}.weight"] = torch.randn(o, i, k, k, generator=g) * (2.0 / (i * k * k)) ** 0.5

    def bn(name, c):
        sd[f"{name}.weight"] = 1.0 + 0.1 * torch.randn(c, generator=g)
        sd[f"{name}.bias"] = 0.1 * torch.randn(c, generator=g)
        sd[f"{name}.running_mean"] = 0.1 * torch.randn(c, generator=g)
        sd[f"{name}.running_var"] = 0.5 + torch.rand(c, generator=g)
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)

    conv("features.0.0", 32, 3, 3)
    bn("features.0.1", 32)
    in_ch, idx = 32, 1
    for t, c, n, _ in _IR_SETTINGS:
        for _ in range(n):
            hidden, base, i = in_ch * t, f"features.{idx}.conv", int(t != 1)
            if t != 1:
                conv(f"{base}.0.0", hidden, in_ch, 1)
                bn(f"{base}.0.1", hidden)
            conv(f"{base}.{i}.0", hidden, 1, 3)
            bn(f"{base}.{i}.1", hidden)
            conv(f"{base}.{i + 1}", c, hidden, 1)
            bn(f"{base}.{i + 2}", c)
            in_ch, idx = c, idx + 1
    conv("features.18.0", 1280, 320, 1)
    bn("features.18.1", 1280)
    sd["classifier.1.weight"] = torch.randn(1000, 1280, generator=g) * 0.01
    sd["classifier.1.bias"] = torch.zeros(1000)
    return sd


def bvlc_alexnet(rs):
    """A seeded ``bvlc_alexnet.npy`` dict: per conv [HWIO kernel, bias]; the
    grouped conv2, conv4 and conv5 hold I/g input channels."""
    import numpy as np

    shapes = {"conv1": (11, 11, 3, 96), "conv2": (5, 5, 48, 256), "conv3": (3, 3, 256, 384),
              "conv4": (3, 3, 192, 384), "conv5": (3, 3, 192, 256)}
    return {name: [(rs.randn(*s) * (2.0 / np.prod(s[:3])) ** 0.5).astype(np.float32),
                   (rs.randn(s[-1]) * 0.1).astype(np.float32)] for name, s in shapes.items()}


def checkpoint_transformer(seed: int):
    """A seeded ``checkpoint_transformer.pth`` payload: the Ghiasi
    generator's state_dict under the reference's ``layers.N.*`` keys."""
    import torch

    from speedplusbaseline_tpu_torch.models.ghiasi import Ghiasi

    torch.manual_seed(seed)
    sd = {k.replace("layer", "layers.", 1): v for k, v in Ghiasi().state_dict().items()}
    return {"state_dict_ghiasi": sd}


def checkpoint_stylepredictor(seed: int):
    """A seeded ``checkpoint_stylepredictor.pth`` payload: the reference's
    names, He-scaled convs (so that the embedding still depends on the image
    after about 50 layers), BN statistics away from 0 / 1,
    ``num_batches_tracked``."""
    import torch

    from speedplusbaseline_tpu_torch.models.style_predictor import StylePredictor

    torch.manual_seed(seed)
    sd = {}
    for k, v in StylePredictor().state_dict().items():
        if k.endswith("conv.weight"):
            v = torch.randn(v.shape) * (2.0 / v[0].numel()) ** 0.5
        elif k.endswith(("running_mean", "bn.bias")):
            v = 0.1 * torch.randn(v.shape)
        elif k.endswith("running_var"):
            v = 0.5 + torch.rand(v.shape)
        sd[k] = v
        if k.endswith("running_var"):
            sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return {"state_dict_stylepredictor": sd}


class _Capture:
    """Wraps the train CLI's ``train_epoch`` and ``_style_augmentor`` for
    one run: the model's state_dict when the first epoch starts (before the
    first step) and the style augmentor it built. Restores both on exit."""

    def __init__(self, train):
        self.train, self.model_at_start, self.aug = train, None, None

    def __enter__(self):
        t = self.train
        self.epoch, self.style = t.train_epoch, t._style_augmentor

        def epoch(n, cfg, state, *a, **k):
            if self.model_at_start is None:
                self.model_at_start = {key: v.detach().cpu().clone()
                                       for key, v in state.model.state_dict().items()}
            return self.epoch(n, cfg, state, *a, **k)

        def style(*a, **k):
            self.aug = self.style(*a, **k)
            return self.aug

        t.train_epoch, t._style_augmentor = epoch, style
        return self

    def __exit__(self, *exc):
        self.train.train_epoch, self.train._style_augmentor = self.epoch, self.style


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def phase_pretrained(dev, card: str):
    """The train CLI from disk on converted pretrained assets: seeded
    torchvision-layout MobileNetV2, bvlc_alexnet and checkpoint_transformer
    weights, converted by the convert_weights CLI into an assets directory
    (with the repo's eval and style-embedding assets) that
    SPEEDPLUS_ASSETS_DIR names; then 3 styled KRN steps at 224^2 and 2
    styled SPN steps at 227^2, batch 48, bf16. Checks the two log lines,
    that the base / conv1-5 before the first step are the converted
    tensors bit for bit, that B1's HWIO buffers hold the converted Ghiasi
    convs, that B1 and B2 launched and the losses are finite; then the
    generator on the converted weights, kernels against plain. Returns the
    kernel launches of both runs."""
    import shutil

    import numpy as np
    import torch

    from speedplusbaseline_tpu_torch import convert_weights, train
    from speedplusbaseline_tpu_torch.augment.styleaug import load_ghiasi_params
    from speedplusbaseline_tpu_torch.convert import flax_to_state_dict, read_flax_msgpack
    from speedplusbaseline_tpu_torch.io_utils import default_assets_dir
    from speedplusbaseline_tpu_torch.models import weight_convert
    from speedplusbaseline_tpu_torch.ops import _build

    launches = {}
    log = _Lines()
    wc_logger = logging.getLogger(weight_convert.__name__)
    wc_logger.addHandler(log)
    env = os.environ.get("SPEEDPLUS_ASSETS_DIR")
    with tempfile.TemporaryDirectory() as tmp:
        repo_assets, assets = default_assets_dir(), os.path.join(tmp, "assets")
        os.makedirs(assets)
        for f in ("tango_points.npy", "attitude_classes.npy", "style_embedding_pbn_cov.npy",
                  "style_embedding_pbn_mean.npy", "style_embedding_speedplus_mean.npy"):
            shutil.copy(os.path.join(repo_assets, f), assets)
        g = torch.Generator().manual_seed(31)
        mnv2 = torchvision_mobilenet_v2(g)
        transformer = checkpoint_transformer(32)
        bvlc = bvlc_alexnet(np.random.RandomState(33))
        torch.save(mnv2, os.path.join(tmp, "mobilenet_v2.pth"))
        torch.save(transformer, os.path.join(tmp, "checkpoint_transformer.pth"))
        np.save(os.path.join(assets, "bvlc_alexnet.npy"), bvlc, allow_pickle=True)
        for target, src, out in (("mobilenet_v2", "mobilenet_v2.pth",
                                  "mobilenetv2_backbone.msgpack"),
                                 ("ghiasi", "checkpoint_transformer.pth",
                                  "ghiasi_params.msgpack")):
            convert_weights.main([target, "--src", os.path.join(tmp, src), "--out",
                                  os.path.join(assets, out)])
        raw = read_flax_msgpack(os.path.join(assets, "mobilenetv2_backbone.msgpack"))
        backbone = flax_to_state_dict(raw["params"], raw["batch_stats"])
        direct = weight_convert.convert_mobilenet_v2(mnv2)
        if backbone.keys() != direct.keys() or not all(torch.equal(backbone[k], direct[k])
                                                       for k in direct):
            fail("pretrained: the backbone file differs from convert_mobilenet_v2's tensors")
        ghiasi_sd = load_ghiasi_params(os.path.join(assets, "ghiasi_params.msgpack"))
        expected = {"krn": {f"base.{k}": v for k, v in backbone.items()},
                    "spn": weight_convert.convert_bvlc_alexnet(bvlc)}
        os.environ["SPEEDPLUS_ASSETS_DIR"] = assets
        try:
            for model, side, steps, extra, losses, line in (
                    ("krn", S, 3, [], ("loss_x", "loss_y"),
                     "MobileNetV2 ImageNet backbone loaded from"),
                    ("spn", SPN_S, 2, ["--num_classes", str(SPN_CLASSES)], ("loss_c", "loss_r"),
                     "bvlc_alexnet conv1-5 loaded from")):
                root = os.path.join(tmp, model)
                write_dataset(root, model, steps * B)
                argv = ["--dataroot", root, "--model_name", model, "--input_shape", str(side),
                        str(side), "--use_fp16", "--num_workers", "8", "--savedir",
                        os.path.join(root, "save"), "--logdir", os.path.join(root, "log"),
                        "--batch_size", str(B), "--optimizer", "adamw", "--lr", "0.001",
                        "--weight_decay", "0.01", "--randomize_texture", "--texture_ratio",
                        "1.0", "--max_epochs", "1", "--start_over"] + extra
                log.lines.clear()
                wc_logger.setLevel(logging.INFO)
                _build.reset_launches()
                t0 = time.time()
                with _Capture(train) as seen:
                    records = train.main(argv)
                torch.cuda.synchronize()
                wall = time.time() - t0
                n = dict(_build.launches)
                print("", flush=True)
                if not any(m.startswith(line) for m in log.lines):
                    fail(f"pretrained {model}: no log line {line!r} in {log.lines}")
                start = seen.model_at_start
                bad = [k for k, v in expected[model].items() if not torch.equal(start[k], v)]
                if bad:
                    fail(f"pretrained {model}: {len(bad)} tensors before the first step differ "
                         f"from the converted ones, e.g. {bad[:3]}")
                res = [(f"layer{i}", j) for i in range(3, 8) for j in (1, 2)]
                for layer, j in res:
                    hwio = getattr(getattr(seen.aug.ghiasi, layer), f"w{j}_hwio").cpu()
                    if not torch.equal(hwio, ghiasi_sd[f"{layer}.conv{j}.weight"]
                                       .permute(2, 3, 1, 0)):
                        fail(f"pretrained {model}: B1's {layer}.w{j}_hwio is not the "
                             "converted conv")
                aug_sd = seen.aug.ghiasi.state_dict()
                if not all(torch.equal(aug_sd[k].cpu(), v) for k, v in ghiasi_sd.items()):
                    fail(f"pretrained {model}: the generator's weights are not the converted ones")
                if len(records) != steps:
                    fail(f"pretrained {model} ran {len(records)} steps, expected {steps}")
                loss = [sum(r[k] for k in losses) for r in records]
                if not all(np.isfinite(loss)):
                    fail(f"pretrained {model}: non-finite loss in {loss}")
                if (n["ghiasi_resblock"] < B1_CALLS_PER_STEP * steps
                        or n["instance_norm_film"] < 6 * steps):
                    fail(f"pretrained {model}: kernel launches {n} too few for {steps} styled "
                         "steps")
                print(f"phase pretrained: {model} at {side}^2 from the converted assets: "
                      f"{line} ...; {len(expected[model])} tensors before the first step equal "
                      f"the converted ones bit for bit; B1's {len(res)} HWIO buffers hold the "
                      f"converted Ghiasi convs; {steps} styled steps, losses "
                      f"{[round(v, 4) for v in loss]} ({' + '.join(losses)}), launches {n}, "
                      f"wall {wall:.1f} s incl. set-up", flush=True)
                for k, v in n.items():
                    launches[k] = launches.get(k, 0) + v
        finally:
            wc_logger.removeHandler(log)
            if env is None:
                os.environ.pop("SPEEDPLUS_ASSETS_DIR", None)
            else:
                os.environ["SPEEDPLUS_ASSETS_DIR"] = env
    phase_ghiasi(dev, ghiasi_sd, "converted checkpoint_transformer weights")
    return launches


# The embedding CLI on the card against --no_cuda: the embeddings and their
# mean within this share of the largest embedding (f32 on both; the same
# convs summed in another order through about 50 layers); the covariance
# within what that allows (embed_tols).
TOL_EMBED = 1e-5
EMBED_FILES = ("embeddings_speedplus.npy", "style_embedding_speedplus_mean.npy",
               "embedding_covariance_speedplus.npy")
STYLE_IMAGES, STYLE_BATCH, STYLE_HW = 64, 8, (320, 480)


def embed_tols(emb, share: float):
    """Tolerances of the three embedding files from the reference embeddings
    ``emb`` (N, 100): ``share`` of the largest for the embeddings and their
    mean (d); for the covariance, what an error of d in each embedding
    allows: a deviation from the mean moves by at most 2d, so each product
    of two by at most 4 d |dev| + 4 d^2, over N / (N - 1)."""
    import numpy as np

    d = share * float(np.abs(emb).max())
    dev = float(np.abs(emb - emb.mean(axis=0)).max())
    n = emb.shape[0]
    return d, d, (4 * d * dev + 4 * d * d) * n / (n - 1)


def style_predictor_kernels(forward, calls: int = 3, rows: int = 8) -> None:
    """Print the device kernels of the StylePredictor's forward by device
    time (torch.profiler over ``calls`` calls): ms and launches a batch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            forward()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    events.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in events) / 1e3 / calls
    print(f"  style_predictor: device busy {busy:.3f} ms a batch of {STYLE_BATCH} "
          f"(torch.profiler, {calls} calls), {sum(e.count for e in events) // calls} kernels; "
          f"the {rows} largest:", flush=True)
    for e in events[:rows]:
        print(f"    {e.self_device_time_total / 1e3 / calls:8.3f} ms  {e.count // calls:4d}x  "
              f"{e.key[:90]}", flush=True)


def phase_style_predictor(dev, card: str):
    """The embedding CLI at its defaults (320x480, batch 8, f32) over 64
    generated 640x400 frames, with a seeded checkpoint_stylepredictor.pth
    converted by the convert_weights CLI, on the card and with --no_cuda:
    the three files must agree. Then the StylePredictor's device time per
    batch of 8 (CUDA events) and the CLI's img/s. Returns the kernel
    launches of the card run (B1 and B2 have no part in it)."""
    import numpy as np
    import torch

    from speedplusbaseline_tpu_torch import convert_weights, embedding
    from speedplusbaseline_tpu_torch.data import generate_fake_speedplus
    from speedplusbaseline_tpu_torch.models.style_predictor import StylePredictor
    from speedplusbaseline_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory() as tmp:
        images = os.path.join(tmp, "images")
        t0 = time.time()
        generate_fake_speedplus(images, num_train=STYLE_IMAGES, num_test=0, width=640,
                                height=400, domains=("synthetic",), device=dev)
        print(f"phase style_predictor: {STYLE_IMAGES} frames of 640x400 written in "
              f"{time.time() - t0:.1f} s", flush=True)
        pth, ckpt = os.path.join(tmp, "sp.pth"), os.path.join(tmp, "style_predictor.msgpack")
        torch.save(checkpoint_stylepredictor(34), pth)
        convert_weights.main(["style_predictor", "--src", pth, "--out", ckpt])
        common = ["--data_dir", images, "--checkpoint", ckpt]
        _build.reset_launches()
        t0 = time.time()
        emb = embedding.main(common + ["--out_dir", os.path.join(tmp, "card")])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(_build.launches)
        t0 = time.time()
        embedding.main(common + ["--out_dir", os.path.join(tmp, "cpu"), "--no_cuda"])
        cpu_wall = time.time() - t0
        if emb.shape != (STYLE_IMAGES, 100) or not np.isfinite(emb).all():
            fail(f"style_predictor: embeddings {emb.shape}, finite {np.isfinite(emb).all()}")
        files = {f: [np.load(os.path.join(tmp, d, f)) for d in ("card", "cpu")]
                 for f in EMBED_FILES}
        tols = embed_tols(files[EMBED_FILES[0]][1], TOL_EMBED)
        errs = {}
        for f, tol in zip(EMBED_FILES, tols):
            got, ref = files[f]
            errs[f] = err = float(np.abs(got - ref).max())
            print(f"  style_predictor {f}: card vs --no_cuda max_abs_err {err:.3e} (tol "
                  f"{tol:.3e}; largest value {float(np.abs(ref).max()):.3e})", flush=True)
            if got.shape != ref.shape or not err <= tol:
                fail(f"style_predictor: {f} differs between the card and the CPU")
        spread = float(emb.std(axis=0).max())
        print(f"  style_predictor: the embeddings' largest std across the {STYLE_IMAGES} "
              f"images {spread:.3e}", flush=True)
        if not spread > 10 * errs[EMBED_FILES[0]]:
            fail("style_predictor: the embeddings hardly depend on the image")
        if any(launches.values()):
            fail(f"style_predictor: B1 and B2 have no part in it, but launched {launches}")

        model = StylePredictor()
        model.load_state_dict(embedding.load_style_predictor(ckpt))
        model = model.to(dev).eval()
        x = torch.rand(STYLE_BATCH, 3, *STYLE_HW, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(8))

        def forward():
            with torch.inference_mode():
                return model(x)

        ms = time_ms(forward, reps=20)
        style_predictor_kernels(forward)
    print(f"phase style_predictor: embedding CLI at {STYLE_HW[0]}x{STYLE_HW[1]}, batch "
          f"{STYLE_BATCH}, f32 (TF32 off) on {card}: {STYLE_IMAGES} images in {wall:.2f} s = "
          f"{STYLE_IMAGES / wall:.1f} img/s incl. model set-up and image decode (--no_cuda "
          f"{cpu_wall:.2f} s); StylePredictor forward {ms:.3f} ms a batch of {STYLE_BATCH} "
          f"= {STYLE_BATCH * 1000 / ms:.1f} img/s of device time (CUDA events, device held); "
          f"launches {launches}", flush=True)
    return launches


def phase_resident_dann(dev) -> None:
    """The DANN step on resident batches of 16 + 16 at 224^2, RMSprop, in f32
    (the README adapt recipe) and in bf16: host clock and device busy time."""
    import torch

    from speedplusbaseline_tpu_torch import profile_step

    for fp16 in (False, True):
        state, step, batch = profile_step.build_dann(dev, fp16)
        ms = [profile_step.time_step(state, step, batch, False) for _ in range(2)]
        label = f"dann {'bf16' if fp16 else 'f32'}"
        busy = profile_step.profile(state, step, batch, False, table=False, label=label)
        print(f"phase resident: {label} step {[round(x, 2) for x in ms]} ms on the host clock; "
              f"device busy {busy:.2f} ms a step (batch {DANN_B} + {DANN_B}, {S}^2, RMSprop)",
              flush=True)
        del state, step, batch
        torch.cuda.empty_cache()


# meter name -> the trainer's scalar tag; DUMPS: meter name -> per-row dump.
VALID_TAGS = {"eR": "Valid/err_q [deg]", "eT": "Valid/err_t [m]",
              "speed (raw)": "Valid/speed (raw) [-]", "speed (thr)": "Valid/speed (thr) [-]"}
DUMPS = {"eR": "err_q.txt", "eT": "err_t.txt", "speed (raw)": "speed_raw.txt",
         "speed (thr)": "speed_mod.txt"}


def check_eval(logdir: str, what: str, phase: str, n_rows: int = EVAL_ROWS):
    """The four dumps of one evaluation: ``n_rows`` finite lines each.
    Returns meter name -> the rows."""
    import numpy as np

    out = {}
    for name, fname in DUMPS.items():
        with open(os.path.join(logdir, fname)) as f:
            rows = np.array([float(v) for v in f.read().split()])
        if rows.shape != (n_rows,) or not np.isfinite(rows).all():
            fail(f"{phase}: {what}: {fname} holds {rows.shape[0]} rows, "
                 f"{int(np.isfinite(rows).sum())} finite; expected {n_rows}")
        out[name] = rows
    print(f"phase {phase}: {what}: {n_rows} rows in each dump, all finite; means "
          f"{ {k: round(float(v.mean()), 5) for k, v in out.items()} }", flush=True)
    return out


def phase_eval(dev, model_name: str):
    """The eval step of ``model_name`` on one device-resident batch of 48 at
    its full size, bf16: the forward and the geometry (pose + score) as
    device time, and the whole step with its one readback on the host
    clock."""
    import numpy as np
    import torch

    from speedplusbaseline_tpu_torch.config import default_cfg
    from speedplusbaseline_tpu_torch.engine import (images_to_float, make_krn_eval_step,
                                                    make_spn_eval_step, spn_pose)
    from speedplusbaseline_tpu_torch.engine.steps import CudaGraphed
    from speedplusbaseline_tpu_torch.geometry import keypoints_to_pose
    from speedplusbaseline_tpu_torch.io_utils import (load_attitude_classes,
                                                      load_tango_3d_keypoints)
    from speedplusbaseline_tpu_torch.metrics import speed_score_batched
    from speedplusbaseline_tpu_torch.models import get_model

    phase, side = ("eval", S) if model_name == "krn" else ("spn_eval", SPN_S)
    torch.manual_seed(0)
    model = get_model(default_cfg(model_name=model_name, input_shape=(side, side),
                                  num_classes=SPN_CLASSES))
    model = model.to(dev, memory_format=torch.channels_last).eval()
    rs = np.random.RandomState(4)
    q, t = random_poses(rs, B)
    uv = project(q, t)
    box = eval_crop(uv)[2] if model_name == "krn" else tight_boxes(uv)
    batch = {"image": torch.from_numpy(rs.randint(0, 256, (B, side, side, 3), dtype=np.uint8)),
             "bbox": torch.from_numpy(box), "q_gt": torch.from_numpy(q),
             "t_gt": torch.from_numpy(t)}
    batch = {k: v.to(dev) for k, v in batch.items()}
    P, K, dist = (torch.as_tensor(a, dtype=torch.float32).to(dev) for a in (
        load_tango_3d_keypoints(), CAMERA["cameraMatrix"], CAMERA["distCoeffs"]))
    if model_name == "krn":
        step = make_krn_eval_step(P, K, dist, dev, fp16=True)
        pose = lambda a: keypoints_to_pose(*a[:2], a[2], P, K, dist)  # noqa: E731
    else:
        q_class = torch.from_numpy(load_attitude_classes()).to(dev)
        step = make_spn_eval_step(q_class, P, K, dist, SPN_NEIGHBORS, dev, fp16=True)
        pose = lambda a: spn_pose(a[1], a[2], q_class, P, K, dist, SPN_NEIGHBORS)  # noqa: E731
    x = images_to_float(batch["image"])

    def forward():
        with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
            return model(x)

    heads = [h.float() for h in forward()]

    def pose_and_score(*a):
        q_pr, t_pr = pose(a)
        return speed_score_batched(t_pr, q_pr, a[4], a[3])

    geometry = CudaGraphed(pose_and_score)
    geo_args = (*heads, batch["bbox"], batch["q_gt"], batch["t_gt"])
    fwd_ms, geo_ms = time_ms(forward, reps=10), time_ms(lambda: geometry(*geo_args), reps=10)
    step_ms = time_ms(lambda: step(model, batch), reps=10)
    keys = ("err_q", "err_t", "speed_raw", "speed_mod", "acc")
    for _ in range(2):
        out = step(model, batch)
        torch.stack([out[k] for k in keys]).cpu()
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        out = step(model, batch)
        torch.stack([out[k] for k in keys]).cpu()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    geo = "keypoints_to_pose" if model_name == "krn" else "spn_pose"
    print(f"phase {phase}: {model_name} eval step at batch {B}, {side}^2, bf16: device time "
          f"forward {fwd_ms:.3f} ms + geometry ({geo} + score, graph replay) "
          f"{geo_ms:.3f} ms, whole step "
          f"{step_ms:.3f} ms = {B * 1000 / step_ms:.1f} img/s of device time; with its "
          f"readback on the host clock median {wall_ms:.3f} ms = {B * 1000 / wall_ms:.1f} "
          f"img/s (10 steps: {[round(w, 2) for w in walls]})", flush=True)


def phase_resident(dev, model_name: str):
    """Styled and plain train steps of ``model_name`` on one device-resident
    batch, in turns (host clock), and each one's device busy time
    (torch.profiler)."""
    import torch

    from speedplusbaseline_tpu_torch import profile_step

    state, step, batch = profile_step.build(dev, model_name)
    out = {}
    for styled in (True, False, False, True):
        out.setdefault(styled, []).append(profile_step.time_step(state, step, batch, styled))
    busy = {styled: profile_step.profile(state, step, batch, styled, table=False)
            for styled in (True, False)}
    side = profile_step.SIZE[model_name]
    for styled, v in out.items():
        print(f"phase resident: {model_name} {'styled' if styled else 'plain'} step "
              f"{[round(x, 2) for x in v]} ms = {B * 1000 / min(v):.1f} img/s on the host "
              f"clock; device busy {busy[styled]:.2f} ms a step (batch {B}, {side}^2, bf16, "
              "AdamW)", flush=True)
    del state, step, batch
    torch.cuda.empty_cache()


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        from speedplusbaseline_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"the port is not beside this script: {e}")
    if "jax" in sys.modules:
        fail("jax was imported")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = card_line()
    print(f"phase device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    t0 = time.time()
    _build.build_all()
    print(f"phase build: {time.time() - t0:.1f} s, nvcc sm_90a, {_build.build_dir()}",
          flush=True)
    for name in _build.SOURCES:
        entry = "?"
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1][:64]
            elif "registers" in line or "spill" in line and " 0 bytes spill" not in line:
                print(f"  {name}: {entry}: {line.strip()}")
    hgmma = tensor_core_instructions("resblock")
    smem = _build.load("resblock").gk_resblock_smem_bytes(*B1_SHAPE[1:3])
    print(f"phase build: libresblock.so holds {hgmma} HGMMA instructions (cuobjdump -sass); "
          f"B1's f32 conv takes {smem} bytes of shared memory per block at {B1_SHAPE[1:3]}",
          flush=True)
    if hgmma == 0:
        fail("B1 holds no tensor-core (HGMMA) instruction")

    report = phase_kernels(dev)
    from speedplusbaseline_tpu_torch.augment.styleaug import load_ghiasi_params
    from speedplusbaseline_tpu_torch.io_utils import default_assets_dir

    phase_ghiasi(dev, load_ghiasi_params(os.path.join(default_assets_dir(),
                                                      "ghiasi_params.msgpack")), "asset weights")
    phase_geometry(dev)
    phase_spn_geometry(dev)
    launches = {"krn": phase_main(dev, "krn", 6), "spn": phase_main(dev, "spn", 4)}
    phase_grl(dev)
    launches["dann"] = phase_dann(dev)
    launches["pretrained"] = phase_pretrained(dev, card)
    launches["style_predictor"] = phase_style_predictor(dev, card)
    for model in ("krn", "spn"):
        phase_resident(dev, model)
        phase_eval(dev, model)
    phase_resident_dann(dev)
    if "jax" in sys.modules:
        fail("jax was imported")

    src = {"instance_norm_film": ("speedplusbaseline_tpu_torch/csrc/instancenorm.cu",
                                  "speedplusbaseline_tpu/ops/pallas_instancenorm.py:71"),
           "ghiasi_resblock": ("speedplusbaseline_tpu_torch/csrc/resblock.cu",
                               "speedplusbaseline_tpu/ops/pallas_resblock.py:110")}
    kernels = []
    for name, (source, replaces) in src.items():
        r = report[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": sum(n[name] for n in launches.values()),
                        "launches_by_path": {m: n[name] for m, n in launches.items()},
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "bound_basis": r["bound_basis"],
                        "bound_ms_bf16_tensor_core": r["bound_ms_bf16_tensor_core"],
                        "spn": r["spn"], **({"sites": r["sites"]} if "sites" in r else {})})
    print("kernel times are per styled KRN step (224^2; B2: its six sites; B1: five calls), "
          "bf16, and under \"spn\" per styled SPN step (227^2); launches count the five "
          "paths (6 KRN and 4 SPN styled steps, 4 DANN steps, which have no restyle, 3 KRN and "
          "2 SPN styled steps on converted pretrained assets, the StylePredictor's embedding "
          "CLI, which has none), launches_by_path each; B1's bound_ms counts "
          "its split-bf16 passes, bound_ms_bf16_tensor_core one bf16 pass of its f32 work")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
