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
                their bound; E1, the edge convs (layer0 and layer10, bf16),
                at odd shapes and at both cells' (KRN 192 x 224^2, SPN 48 x
                227^2 / 228^2), timed beside their bound, their plain
                version and F.pad + F.conv2d; then the whole Ghiasi generator on the card, in
                f32 and in bf16, against the plain f32 version on the CPU
                (phase ghiasi), and the bf16 generator on the flax-init
                weights of each seed of JAX_GHIASI_BF16, with the kernels
                and with their plain versions, held to JAX's bf16 generator
                at the same weights, each kernel call against its plain
                version on the same input;
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
 11. data     -- the from-disk data path: a dataset of one 1920x1200 JPEG a
                row (288 train + 100 test), cached at 512 px by the
                cache_dataset CLI; the loader alone for one epoch (batch 48,
                224^2, 8 threads) from full frames and from the cache through
                cv2 (and through the native decode core, where the machine
                can build it: NATIVE_ON_CARD); the styled KRN trainer (6
                steps) from the cache with its validation and the test CLI,
                as in phase main; every cached eval crop against the
                full-frame one; a 2-epoch run with --profile_dir whose trace
                must name B1's and B2's device kernels and each span of the
                styled KRN training path (KRN_STYLED_SPANS);
 12. resident, eval, spn_eval -- per model, the styled and plain train steps
                on a resident batch (host clock, and device busy time by
                torch.profiler), and the eval step (forward, geometry) as
                device time and on the host clock; the DANN step on resident
                batches of 16 + 16 in f32 and in bf16;
 13. ddp      -- data parallelism on the one card: two ranks (spawned
                processes, one process group for the three models) over
                gloo with CUDA tensors each take one f32
                step (SGD, lr 1e-2) of the styled KRN trainer (224^2, global
                batch 48), the styled SPN trainer (227^2, 5000 classes) and
                the DANN step (16 + 16) on their halves of the global batch,
                against one process's step on the whole batch (parameters
                within 1e-4), with each rank's B1 / B2 launches and the ms
                of a step over gloo and in one process; then one process
                over NCCL at world 1 runs the collective path (with and
                without it: device ms a step; the NCCL kernels the profiler
                sees). NCCL between cards cannot be shown on one card;
 14. ghiasi_phase -- the phase-space Ghiasi lowering against the plain one
                (224^2 and 227^2 on the input padded to 228, batch 48, f32
                and bf16, the shipped weights), each lowering's device ms a
                restyle by CUDA events and by torch.profiler with the share
                of its two 9x9 convs, and a styled KRN step with each;
 15. quality  -- every quality driver (speedplusbaseline_tpu_torch/quality/)
                through its module at a small size on the card, its CLI
                arms in this process: KRN memorization (96 frames at 224^2,
                validated on the train split: the best SPEED score under
                half the first; the driver as a process beside the rest),
                the DANN A/B, the style-aug A/B's arm C (B1 and B2 must
                launch), the transfer A/B with the boot arm's
                trunk at step 0 equal to the donor's bit for bit, and SPN
                conv1-5 through dump_spn_convs and maybe_load_pretrained bit
                for bit; each driver's final JSON line;
 16. toy_ghiasi -- the trainable generator and the toy-Ghiasi trainer
                (``train_toy_ghiasi``): one MSE loss's gradients for every
                parameter at the trainer's shape (batch 8, 64^2, f32) through
                B1 / B2 and through their plain versions on the card, each
                layer's relative L2 error and worst error over its largest
                gradient; the
                trainer CLI at its defaults (600 Adam steps) into a temporary
                --out, its MSE every 50 steps, ms a step, its B1 / B2 launches
                (at least 5 and 6 a step) and a final MSE of at most
                TOY_MSE_MAX; the written file's keys and shapes against the
                shipped asset's; tests/test_styleaug_quality.py's four
                behaviour checks on the trained weights through the port's
                StyleAugmentor on the card;
 17. spn_stall -- the SPN memorization probe (``quality.probe_spn_memorize``)
                on one batch of 48 crops at 227^2 against 500 attitude bins
                for 200 steps at a held lr, whose loss_c must fall under
                2.5; the live-ReLU shares of two seeds at steps 0 and 64
                (``quality.spn_seed_sweep.live_run``), printed; B1 and B2
                launch 0 times;
 18. perf     -- the measuring modules (speedplusbaseline_tpu_torch/perf/)
                at a small size, each through its CLI in this process:
                bench_host_loader (32 images), bench_e2e (96 rows of
                1920x1200, 2 epochs, full frames and the RoI cache),
                ab_bf16_out's four arms and ab_spn_styled's two (10 timed
                steps each, through the ``--arm`` path); each JSON line's
                numbers finite and positive, and every A/B arm's B1 / B2
                launches 5 / 6 a styled step in the plain lowering and 5 / 2
                in the phase lowering;
 19. bench    -- the bench (``python -m speedplusbaseline_tpu_torch.bench``)
                at its defaults as a subprocess: its one JSON line must hold
                the root bench.py's keys and the port's, every number finite
                and positive (the native host rate null where NATIVE_ON_CARD
                is false), the card line and the lowering; its krn and spn
                children's B1 / B2 launches 5 / 6 times the styled steps that
                ``bench.krn_styled_steps`` / ``spn_styled_steps`` count, and
                no launch in the others.
Each phase prints its seconds as it ends. Then one JSON line with every
phase's seconds and the total, one with every kernel's numbers, the card
line, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
result lines. Imports nothing of JAX.
"""
from __future__ import annotations

import collections
import importlib
import json
import logging
import math
import os
import signal
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
# E1, the edge convs (csrc/edgeconv.cu): (layer, Cin, Cout), and the (B, H, W)
# of each at the benchmark cells' shapes: KRN at batch 192, SPN's 227^2
# layer0 and 228^2 layer10 at batch 48.
E1_LAYERS = (("layer0", 3, 32), ("layer10", 32, 3))
E1_SHAPES = {"krn": ((192, S, S), (192, S, S)), "spn": ((B, 227, 227), (B, 228, 228))}
# E2, the mid convs (csrc/midconv.cu): (layer, Cin, Cout, stride, upsample),
# and the (B, H, W) input of each at the benchmark cells' shapes: KRN's 224^2
# at batch 192, SPN's 227 -> 114 -> 57 (B1) -> 114 at batch 48.
E2_LAYERS = (("layer1", 32, 64, 2, 1), ("layer2", 64, 128, 2, 1), ("layer8", 128, 64, 1, 2),
             ("layer9", 64, 32, 1, 2))
E2_SHAPES = {"krn": ((192, S, S), (192, S // 2, S // 2), (192, S // 4, S // 4),
                     (192, S // 2, S // 2)),
             "spn": ((B, 227, 227), (B, 114, 114), (B, 57, 57), (B, 114, 114))}
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
# The bf16 generator's worst element at batch 48 (phase ghiasi_phase): a
# few of its 7.2 M outputs pass 2^-6 (PERF.md §6).
TOL_PHASE_BF16 = 2.0 ** -5
# The bf16 generator on flax-init weights (``flax_init_ghiasi(s)``) and
# phase ghiasi's inputs, where no fixed bound fits: JAX's own bf16
# generator passes 2^-6 at some seeds. J(s) = (max, mean) of |bf16 - f32| of
# JAX's bf16 generator on its Pallas path (the function its TPU main path
# computes) against its f32 one, on the CPU; tests/test_torch_ghiasi_bf16.py
# holds these to JAX within 2%. The card's bf16 generator is at fault at a
# seed where its max passes GHIASI_BF16_RULE[0] x J's max or its mean
# GHIASI_BF16_RULE[1] x J's mean.
JAX_GHIASI_BF16 = {0: (1.6654e-02, 1.5194e-03), 1: (1.9580e-02, 1.2705e-03),
                   2: (1.9231e-02, 1.7370e-03), 7: (2.6581e-02, 2.2803e-03),
                   32: (2.3206e-02, 1.8013e-03)}
GHIASI_BF16_RULE = (1.5, 1.25)
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
# Phase data: the cache's side, the styled steps from the cache, and the
# loader's four configurations (name, --cache_dir, --use_native_loader).
# The cached paths' eval crops against the full-frame path: the crop box in
# original pixels is within 1 + 1/scale px of the full-frame one, where scale
# is the row's cache scale (crop_params truncates each edge to a whole pixel
# of the image it crops: one original pixel in the full frame, 1/scale of
# them in the cache); each crop's mean |difference| from the full frame
# cropped at the same box is within 0.02 of full scale (the cache's
# downscale, its JPEG re-encode and the two resizes).
CACHE_SIZE, DATA_STEPS = 512, 6
# The H100 machine the port is checked on has neither libjpeg's headers nor
# its library (``#include <jpeglib.h>`` fails, ``ldconfig -p`` lists no
# libjpeg), so the native decode core cannot be built there, and
# --use_native_loader raises RuntimeError with the compiler's message. With
# NATIVE_ON_CARD False, phase data leaves the loader's two native
# configurations out and trains from the cache alone.
NATIVE_ON_CARD = False
LOADER_CONFIGS = tuple(c for c in (("full-frame cv2", False, False), ("native", False, True),
                                   ("cache", True, False), ("cache + native", True, True))
                       if NATIVE_ON_CARD or not c[2])
TOL_EVAL_CROP = 0.02
# Phase toy_ghiasi: the kernel path's gradients against the plain path's on
# the card, per layer (layerN): the relative L2 error of its gradients, and
# the worst |difference| over its largest gradient. B1's split-bf16 forward
# is a few 1e-6 (relative L2) off the plain block at this shape, and at the
# trainer's start the gradients amplify an input change about 500x: the
# phase prints the plain path on x * (1 + 1e-5 noise) beside the kernels
# (3e-3 to 6e-3 relative L2, 2e-3 to 2.4e-2 worst over largest on an H100
# 80GB HBM3 at 700 W), and B1 alone and B2 alone against plain; the kernels
# read 7-9e-4 and 1e-3 to 6.5e-3 there, nearly all of it B1's. A wrong or
# missing gradient is off by order 1. The trainer's final MSE: 1.5 x the JAX
# script's 0.0076 (BASELINE.md:316). The behaviour checks' thresholds are
# tests/test_styleaug_quality.py's.
TOL_TOY_GRAD = {"relative L2": 5e-3, "worst / largest": 2e-2}
TOY_MSE_MAX = 0.0114
TOY_STEPS, TOY_B, TOY_S = 600, 8, 64
# Phase perf: the rows (one 1920x1200 frame each) and epochs of bench_e2e,
# the images of bench_host_loader, the timed steps of each A/B arm, and B1's
# and B2's launches a styled step in each Ghiasi lowering.
PERF_E2E_IMAGES, PERF_E2E_EPOCHS, PERF_LOADER_IMAGES, PERF_AB_STEPS = 96, 2, 32, 10
PERF_LAUNCHES = {"plain": {"ghiasi_resblock": 5, "instance_norm_film": 6, "reflect_conv9x9": 2,
                           "reflect_conv3x3": 4},
                 "phase": {"ghiasi_resblock": 5, "instance_norm_film": 2, "reflect_conv9x9": 0,
                           "reflect_conv3x3": 0}}
# Device kernels of B1 and B2 by name, as a profiler trace holds them.
B1_KERNEL, B2_KERNELS = "conv3x3_tc_kernel", ("in_cluster_kernel", "in_apply_kernel")
# The program's spans (io_utils/spans.py) a styled KRN training epoch records.
KRN_STYLED_SPANS = ("speedplus.step", "speedplus.augment", "speedplus.restyle",
                    "speedplus.forward", "speedplus.backward", "speedplus.clip",
                    "speedplus.optimizer", "speedplus.readback", "speedplus.loader_wait")


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


def e1_rows(dev, g):
    """E1 against its plain version at odd shapes and both cells', bf16,
    then per styled step of each cell (layer0 + layer10): kernel, plain and
    F.pad + F.conv2d (the library path the port no longer takes in bf16 on
    the card) ms beside the bound (bytes: x read and out written once)."""
    import torch
    import torch.nn.functional as F

    from speedplusbaseline_tpu_torch.ops import edgeconv as ec

    print("phase kernels: E1 reflect_conv9x9 vs reflect_conv9x9_plain", flush=True)

    def args(cin, cout, shape):
        x = torch.rand(*shape, cin, device=dev, generator=g).to(torch.bfloat16)
        w = torch.randn(cout, cin, 9, 9, device=dev, generator=g) / math.sqrt(81 * cin)
        b = torch.randn(cout, device=dev, generator=g) * 0.1
        return x, w.to(torch.bfloat16), b.to(torch.bfloat16)

    err = 0.0
    shapes = [(2, 5, 7), (3, 37, 61)] + [s for pair in E1_SHAPES.values() for s in pair]
    for layer, cin, cout in E1_LAYERS:
        for shape in shapes:
            x, w, b = args(cin, cout, shape)
            err = max(err, compare(f"E1 {layer} {shape} bf16", ec.reflect_conv9x9(x, w, b),
                                   ec.reflect_conv9x9_plain(x, w, b), TOL["bfloat16"]))
    per = {}
    for model, pair in E1_SHAPES.items():
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
        for (layer, cin, cout), shape in zip(E1_LAYERS, pair):
            x, w, b = args(cin, cout, shape)
            x_nchw = x.permute(0, 3, 1, 2)
            ms = time_ms(lambda: ec.reflect_conv9x9(x, w, b))
            pms = time_ms(lambda: ec.reflect_conv9x9_plain(x, w, b), 5)
            lms = time_ms(lambda: F.conv2d(F.pad(x_nchw, (4,) * 4, mode="reflect"), w, b), 5)
            bound = max(ec.bytes_moved(shape, cin, cout) / HBM_BYTES_PER_S,
                        ec.flops(shape, cin, cout) / BF16_TENSOR_FLOPS) * 1e3
            print(f"  E1 {model} {layer} {shape} {cin} -> {cout} bf16: kernel {ms:.4f} ms, "
                  f"bound {bound:.4f} ms (bytes), {ms / bound:.2f}x bound; plain {pms:.4f} ms, "
                  f"F.pad + F.conv2d {lms:.4f} ms", flush=True)
            for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms), ("bound_ms", bound)):
                tot[k] += v
        per[model] = tot
        print(f"phase kernels: E1 per {model} styled step: kernel {tot['ms']:.4f} ms, bound "
              f"{tot['bound_ms']:.4f} ms ({tot['bound_ms'] / tot['ms']:.0%} of bound)", flush=True)
    return {"max_abs_err": err, "bound_by": "bytes",
            "bound_basis": "one read of x and one write of out at the HBM rate",
            "bound_ms_bf16_tensor_core": None, **per["krn"], "spn": per["spn"]}


def e2_rows(dev, g):
    """E2 against its plain version at odd shapes and both cells', bf16,
    then per styled step of each cell (layers 1, 2, 8, 9): kernel, plain and
    F.interpolate + F.pad + F.conv2d (the library path the port no longer
    takes in bf16 on the card) ms beside the bound (layers 8 and 9:
    operations; layers 1 and 2: bytes, x read and out written once)."""
    import torch
    import torch.nn.functional as F

    from speedplusbaseline_tpu_torch.ops import midconv as mc

    print("phase kernels: E2 reflect_conv3x3 vs reflect_conv3x3_plain", flush=True)

    def args(cin, cout, shape):
        x = torch.rand(*shape, cin, device=dev, generator=g).to(torch.bfloat16)
        w = torch.randn(cout, 3, 3, cin, device=dev, generator=g) / math.sqrt(9 * cin)
        b = torch.randn(cout, device=dev, generator=g) * 0.1
        return x, w.to(torch.bfloat16), b

    err = 0.0
    for i, (layer, cin, cout, st, up) in enumerate(E2_LAYERS):
        for shape in [(2, 2, 3), (2, 5, 7), (3, 37, 61)] + [s[i] for s in E2_SHAPES.values()]:
            x, w, b = args(cin, cout, shape)
            err = max(err, compare(f"E2 {layer} {shape} bf16", mc.reflect_conv3x3(x, w, b, st, up),
                                   mc.reflect_conv3x3_plain(x, w, b, st, up), TOL["bfloat16"]))
    per = {}
    for model, shapes in E2_SHAPES.items():
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
        for (layer, cin, cout, st, up), shape in zip(E2_LAYERS, shapes):
            x, w, b = args(cin, cout, shape)
            x_nchw, w_oihw, b16 = x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2), b.bfloat16()

            def library():
                xu = F.interpolate(x_nchw, scale_factor=up, mode="nearest") if up > 1 else x_nchw
                return F.conv2d(F.pad(xu, (1,) * 4, mode="reflect"), w_oihw, b16, st)
            ms = time_ms(lambda: mc.reflect_conv3x3(x, w, b, st, up))
            pms = time_ms(lambda: mc.reflect_conv3x3_plain(x, w, b, st, up), 5)
            lms = time_ms(library, 5)
            by_ops = mc.flops(shape, cin, cout, st, up) / BF16_TENSOR_FLOPS * 1e3
            by_bytes = mc.bytes_moved(shape, cin, cout, st, up) / HBM_BYTES_PER_S * 1e3
            bound = max(by_ops, by_bytes)
            print(f"  E2 {model} {layer} {shape} {cin} -> {cout} stride {st} upsample {up} bf16: "
                  f"kernel {ms:.4f} ms, bound {bound:.4f} ms "
                  f"({'operations' if by_ops > by_bytes else 'bytes'}), {ms / bound:.2f}x bound; "
                  f"plain {pms:.4f} ms, F.interpolate + F.pad + F.conv2d {lms:.4f} ms",
                  flush=True)
            for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms), ("bound_ms", bound)):
                tot[k] += v
        per[model] = tot
        print(f"phase kernels: E2 per {model} styled step: kernel {tot['ms']:.4f} ms, bound "
              f"{tot['bound_ms']:.4f} ms ({tot['bound_ms'] / tot['ms']:.0%} of bound)", flush=True)
    return {"max_abs_err": err, "bound_by": "operations (layers 8, 9), bytes (layers 1, 2)",
            "bound_basis": "2 x 9 x Cin x Cout an output pixel at the bf16 tensor-core peak, "
                           "or one read of x and one write of out at the HBM rate, the larger",
            "bound_ms_bf16_tensor_core": None, **per["krn"], "spn": per["spn"]}


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
    report["reflect_conv9x9"] = e1_rows(dev, g)
    report["reflect_conv3x3"] = e2_rows(dev, g)
    for model, b2, b1 in (("krn", tot, per["krn"]), ("spn", spn_tot, per["spn"])):
        ms, bound = b2["ms"] + b1["ms"], b2["bound_ms"] + b1["bound_ms"]
        print(f"phase kernels: B1 + B2 per {model} styled step (batch {B}): kernel {ms:.4f} ms, "
              f"bound {bound:.4f} ms ({bound / ms:.0%} of bound)", flush=True)
    return report


def ghiasi_inputs():
    """Phase ghiasi's inputs, on the CPU: x (2, 3, S, S) in [0, 1] and the
    style (2, 100)."""
    import torch

    g = torch.Generator().manual_seed(1)
    x = torch.rand(2, 3, S, S, generator=g)
    return x, torch.randn(2, 100, generator=g) * 0.5


def flax_init_ghiasi(seed: int):
    """The Ghiasi generator's state dict at flax's default init, drawn with
    numpy's ``RandomState(seed)`` in the order of the port's state dict:
    each conv and dense kernel a normal of variance 1 / fan_in truncated at
    two standard deviations (``lecun_normal``; out-of-range draws drawn
    again), every bias 0. numpy's legacy stream is the same in every
    version, where ``torch.manual_seed(s); Ghiasi()`` is not: torch's
    ``trunc_normal_`` draws other weights from one seed in other torch
    versions, so the card's and the CPU's weights would differ."""
    import numpy as np
    import torch

    from speedplusbaseline_tpu_torch.models.ghiasi import Ghiasi

    rs = np.random.RandomState(seed)
    sd = {}
    for k, v in Ghiasi().state_dict().items():
        if k.endswith("bias"):
            sd[k] = torch.zeros_like(v)
            continue
        w = rs.standard_normal(v.shape)
        while (bad := np.abs(w) > 2.0).any():
            w[bad] = rs.standard_normal(int(bad.sum()))
        std = (1.0 / v[0].numel()) ** 0.5 / 0.87962566103423978
        sd[k] = torch.from_numpy((w * std).astype(np.float32))
    return sd


def ghiasi_bf16_fault(seed: int, max_err: float, mean_err: float) -> bool:
    """Whether the bf16 generator's (max, mean) |bf16 - f32| at the flax-init
    weights of ``seed`` breaks the rule against JAX's (JAX_GHIASI_BF16)."""
    jmax, jmean = JAX_GHIASI_BF16[seed]
    return max_err > GHIASI_BF16_RULE[0] * jmax or mean_err > GHIASI_BF16_RULE[1] * jmean


def phase_ghiasi(dev, sd, weights: str):
    """The whole generator with the state dict ``sd`` (``weights`` names it):
    kernels on the card, in f32 and in bf16 (the main path's dtype), vs the
    plain f32 version on the CPU."""
    import torch

    from speedplusbaseline_tpu_torch.models.ghiasi import Ghiasi

    net_cpu = Ghiasi().eval()
    net_cpu.load_state_dict(sd)
    x, st = ghiasi_inputs()
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


def phase_ghiasi_flax_init(dev):
    """The bf16 generator on flax-init weights (``flax_init_ghiasi(s)``) for
    each seed s of JAX_GHIASI_BF16, on phase ghiasi's inputs,
    against the plain f32 generator on the CPU: K(s) with B1 and B2 on the
    card, Q(s) with their plain versions on the card in their place
    (``_PlainGhiasi``, for that one call), each as max, mean
    and elements over 2^-6 of |bf16 - f32|, beside JAX's J(s); then each
    kernel call of the K run (B2 at layers 0-2 and 8-10, B1 at layers 3-7)
    against its plain version on the same bf16 input, recorded by patching
    the wrappers. Fails if K(s) breaks the rule against J(s)
    (``ghiasi_bf16_fault``), if a call is outside TOL["bfloat16"] of its
    plain version, or if the K run did not launch B1 / B2 5 / 6 times or
    the Q run launched either."""
    import torch

    from speedplusbaseline_tpu_torch.models import ghiasi as gm
    from speedplusbaseline_tpu_torch.ops import _build
    from speedplusbaseline_tpu_torch.ops.instancenorm import instance_norm_film_plain
    from speedplusbaseline_tpu_torch.ops.resblock import ghiasi_resblock_plain

    x, st = ghiasi_inputs()
    xd, std = x.to(dev), st.to(dev)
    ops = {"instance_norm_film": (gm.instance_norm_film, instance_norm_film_plain),
           "ghiasi_resblock": (gm.ghiasi_resblock, ghiasi_resblock_plain)}
    atol, rtol = TOL["bfloat16"]
    faults, table = [], {}

    def run(net):
        with torch.no_grad():
            return net(xd, std).float().cpu()

    def stats(got, ref):
        err = (got - ref).abs()
        return [err.max().item(), err.mean().item(), int((err > 2.0 ** -6).sum())]

    for seed in sorted(JAX_GHIASI_BF16):
        net = gm.Ghiasi().eval()
        net.load_state_dict(flax_init_ghiasi(seed))
        with torch.no_grad():
            ref = net(x, st)
        net_gpu = gm.Ghiasi(torch.bfloat16).to(dev).eval()
        net_gpu.load_state_dict(net.state_dict())
        calls = []

        def recorder(name):
            def call(*args, **kw):
                out = ops[name][0](*args, **kw)
                calls.append((name, args, kw, out))
                return out
            return call

        n0 = dict(_build.launches)
        for name in ops:
            setattr(gm, name, recorder(name))
        try:
            k = stats(run(net_gpu), ref)
        finally:
            for name, (kernel, _) in ops.items():
                setattr(gm, name, kernel)
        n1 = dict(_build.launches)
        with _PlainGhiasi():
            q = stats(run(net_gpu), ref)
        launched = [{n: b[n] - a[n] for n in a} for a, b in ((n0, n1), (n1, _build.launches))]
        if launched != [{"instance_norm_film": 6, "ghiasi_resblock": 5, "reflect_conv9x9": 2,
                         "reflect_conv3x3": 4},
                        {"instance_norm_film": 0, "ghiasi_resblock": 0, "reflect_conv9x9": 0,
                         "reflect_conv3x3": 0}]:
            faults.append(f"seed {seed}: the K and Q runs launched {launched}")
        sites = {}
        for layer, (name, args, kw, out) in enumerate(calls):
            plain = ops[name][1](*args, **kw).float()
            err = (out.float() - plain).abs()
            sites[f"layer{layer}"] = {
                "kernel": "B1" if name == "ghiasi_resblock" else "B2",
                "max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
                "share_differing": (err > 0).float().mean().item(),
                "largest_plain": plain.abs().max().item()}
            if (err > atol + rtol * plain.abs()).any():
                faults.append(f"seed {seed}: {name} at layer{layer} is outside "
                              f"{TOL['bfloat16']} of its plain version")
        j = JAX_GHIASI_BF16[seed]
        table[seed] = {"J": list(j), "K": k, "Q": q, "sites": sites}
        print(f"phase ghiasi: flax init seed {seed}, bf16 vs CPU plain f32 (max / mean / "
              f"elements over 2^-6 of {ref.numel()}): K (card kernels) {k[0]:.4e} / "
              f"{k[1]:.4e} / {k[2]}, {k[0] / j[0]:.3f}x / {k[1] / j[1]:.3f}x JAX's "
              f"{j[0]:.4e} / {j[1]:.4e}; Q (plain versions on the card) {q[0]:.4e} / "
              f"{q[1]:.4e} / {q[2]}", flush=True)
        print("  kernel vs plain on the same bf16 input: " + "; ".join(
            f"{layer} {s['kernel']} max {s['max_abs_err']:.3e} (largest |plain| "
            f"{s['largest_plain']:.3g}), mean {s['mean_abs_err']:.3e}, "
            f"{s['share_differing']:.4%} differ" for layer, s in sites.items()), flush=True)
        if ghiasi_bf16_fault(seed, k[0], k[1]):
            faults.append(f"seed {seed}: K {k[0]:.4e} / {k[1]:.4e} breaks the rule against "
                          f"JAX's {j[0]:.4e} / {j[1]:.4e} ({GHIASI_BF16_RULE[0]}x max, "
                          f"{GHIASI_BF16_RULE[1]}x mean)")
    print(json.dumps({"ghiasi_bf16_flax_init": table}), flush=True)
    if faults:
        fail("ghiasi flax init: " + "; ".join(faults))


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
    launches of the training run and its step times (train_from_disk)."""
    phase = MAIN[model][0]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        write_dataset(tmp, model, steps * B)
        print(f"phase {phase}: dataset of {steps * B} rows written in "
              f"{time.time() - t0:.1f} s", flush=True)
        return train_from_disk(phase, tmp, model, steps, [])


def train_from_disk(phase: str, tmp: str, model: str, steps: int, extra):
    """The styled trainer (``train.main``) of ``model`` on the dataset in
    tmp with the ``extra`` flags, then check_validation_and_test_cli with
    them. Returns the training run's kernel launches and its times in ms:
    the median step after the first ("step"), the epoch's wall a step
    ("epoch") and the epoch's wall after its first step, a step ("after_first";
    the first step holds the process's first calls to cuDNN and the kernels)."""
    import numpy as np
    import torch

    from speedplusbaseline_tpu_torch import train
    from speedplusbaseline_tpu_torch.ops import _build

    side, flags, losses = MAIN[model][1:]
    common = ["--dataroot", tmp, "--model_name", model, "--input_shape", str(side),
              str(side), "--use_fp16", "--num_workers", "8", "--eval_batch_size",
              str(B)] + flags + extra
    argv = common + ["--savedir", os.path.join(tmp, "save"),
                     "--logdir", os.path.join(tmp, "log"), "--batch_size", str(B),
                     "--optimizer", "adamw", "--lr", "0.001", "--weight_decay", "0.01",
                     "--randomize_texture", "--texture_ratio", "1.0",
                     "--max_epochs", "1", "--start_over", "--test_epoch", "1"]
    epoch_s = []
    train_epoch = train.train_epoch

    def timed_epoch(*args, **kwargs):
        t0 = time.perf_counter()
        out = train_epoch(*args, **kwargs)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
        return out

    train.train_epoch = timed_epoch
    try:
        _build.reset_launches()
        t0 = time.time()
        records = train.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(_build.launches)
    finally:
        train.train_epoch = train_epoch
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
    times = {"step": step_ms, "epoch": epoch_s[0] * 1000 / steps,
             "after_first": (epoch_s[0] * 1000 - records[0]["ms"]) / (steps - 1)}
    print(f"phase {phase}: {steps} styled {model} steps at {side}^2, losses "
          f"{[round(v, 4) for v in loss]} ({' + '.join(losses)}), launches {launches}, "
          f"wall {wall:.1f} s incl. set-up", flush=True)
    print(f"phase {phase}: step ms after the first {[round(v, 2) for v in ms]}; median "
          f"{step_ms:.2f} ms = {B * 1000 / step_ms:.1f} img/s (from disk, "
          f"8 loader threads); the epoch's wall {times['epoch']:.2f} ms a step, "
          f"{times['after_first']:.2f} ms a step after the first", flush=True)
    check_validation_and_test_cli(phase, tmp, common, losses, EVAL_ROWS, "trainer")
    return launches, times


def mean_abs_diff(a, b) -> float:
    """Mean |a - b| of two uint8 images, in units of full scale."""
    import numpy as np

    return float(np.abs(a.astype(np.float32) - b.astype(np.float32)).mean() / 255)


def full_frame_crop(path: str, box):
    """The RGB crop of the full frame at ``box`` [xmin, xmax, ymin, ymax]
    (original pixels, rounded), resized to S x S as the cv2 path resizes."""
    import cv2

    img = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    x0, x1, y0, y1 = (int(round(float(v))) for v in box)
    return cv2.resize(img[y0:y1, x0:x1], (S, S), interpolation=cv2.INTER_LINEAR)


def phase_data(dev, main_times):
    """The from-disk data path: the cache_dataset CLI caches a dataset of
    one 1920x1200 JPEG a row; the loader alone in LOADER_CONFIGS; the styled
    KRN trainer from the cache (through the native core where NATIVE_ON_CARD)
    with its validation and the test CLI; the cached eval crops against the
    full-frame ones; a 2-epoch run with --profile_dir whose trace must name
    B1, B2 and KRN_STYLED_SPANS. Returns the trainer's kernel launches."""
    import cv2
    import numpy as np
    import torch
    from PIL import Image

    from speedplusbaseline_tpu_torch import cache_dataset, train
    from speedplusbaseline_tpu_torch.config import default_cfg
    from speedplusbaseline_tpu_torch.data import KRNDataset, make_dataloader
    from speedplusbaseline_tpu_torch.data.cache import load_manifest
    from speedplusbaseline_tpu_torch.ops import _build

    rows = DATA_STEPS * B
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        write_dataset(tmp, "krn", rows, n_images=rows)  # one frame a row, as SPEED+
        print(f"phase data: dataset of {rows} rows, one 1920x1200 JPEG each, written in "
              f"{time.time() - t0:.1f} s", flush=True)
        cache_dir = os.path.join(tmp, "cache")
        t0 = time.time()
        for domain, csv in (("synthetic", "train.csv"), ("lightbox", "lightbox.csv")):
            cache_dataset.main(["--dataroot", tmp, "--domain", domain, "--csv",
                                f"splits_krn/{csv}", "--cache_dir", cache_dir,
                                "--cache_size", str(CACHE_SIZE)])
        build_s = time.time() - t0
        pixels = [np.prod(Image.open(e[0]).size) for domain in ("synthetic", "lightbox")
                  for e in load_manifest(cache_dir, "speedplus", domain).values()]
        print(f"phase data: RoI cache of {len(pixels)} frames built in {build_s:.1f} s by the "
              f"cache_dataset CLI (--cache_size {CACHE_SIZE}): mean {np.mean(pixels):.0f} "
              f"cached pixels a frame = {np.mean(pixels) / (1920 * 1200):.4f} of 1920x1200",
              flush=True)

        def cfg(cache: bool, native: bool, **kw):
            return default_cfg(dataroot=tmp, input_shape=(S, S), batch_size=B, num_workers=8,
                               cache_dir=cache_dir if cache else "", use_native_loader=native,
                               **kw)

        rates, serial, decode = {}, {}, {}
        for name, cache, native in LOADER_CONFIGS:
            loader = make_dataloader(cfg(cache, native), dev)  # builds the core first
            loader.set_epoch(1)
            t0 = time.perf_counter()
            n = sum(batch["image"].shape[0] for batch in loader.host_batches())
            rates[name] = n / (time.perf_counter() - t0)
            if n != rows:
                fail(f"data: the {name} loader gave {n} images, expected {rows}")
            ds = loader.dataset
            t0 = time.perf_counter()
            for i in range(2 * B):
                ds.__getitem__(i, epoch=1)
            serial[name] = (time.perf_counter() - t0) * 1000 / (2 * B)
            if not native:  # the cv2 decode alone, as the dataset's imread makes it
                rels = [str(ds.csv.iloc[i][0]).strip() for i in range(2 * B)]
                paths = [ds.cache[r][0] if cache else os.path.join(ds.root, r) for r in rels]
                t0 = time.perf_counter()
                for path in paths:
                    cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
                decode[name] = (time.perf_counter() - t0) * 1000 / (2 * B)
        print(f"phase data: loader alone (host_batches, pinned, no device step), one epoch of "
              f"{rows} images at {S}^2, batch {B}, 8 threads, os.cpu_count() = "
              f"{os.cpu_count()}: " + ", ".join(f"{k} {v:.1f} img/s" for k, v in rates.items())
              + f"; one thread, {2 * B} samples: " + ", ".join(
                  f"{k} {v:.3f} ms a sample ({1000 / v:.1f} img/s), of it the decode "
                  f"{decode[k]:.3f} ms" if k in decode else f"{k} {v:.3f} ms a sample"
                  for k, v in serial.items()), flush=True)

        extra = ["--cache_dir", cache_dir] + ["--use_native_loader"] * NATIVE_ON_CARD
        launches, times = train_from_disk("data", tmp, "krn", DATA_STEPS, extra)
        via = "through the native core" if NATIVE_ON_CARD else "through cv2"
        print(f"phase data: from the cache {via}: median step {times['step']:.2f} ms, the "
              f"epoch's wall {times['epoch']:.2f} ms a step, {times['after_first']:.2f} ms a "
              f"step after the first; phase main's full frames through cv2 in this call: "
              f"{main_times['step']:.2f}, {main_times['epoch']:.2f} and "
              f"{main_times['after_first']:.2f} ms", flush=True)

        full = KRNDataset(cfg(False, False), is_train=False, is_source=False)
        for name, cache, native in (c for c in LOADER_CONFIGS if c[1]):
            cached = KRNDataset(cfg(cache, native), is_train=False, is_source=False)
            box_err, box_tol, crop_err, same_box_err = [], [], [], []
            for i in range(len(full)):
                a, b = full[i], cached[i]
                rel = str(full.csv.iloc[i][0]).strip()
                box_err.append(np.abs(a["bbox"] - b["bbox"]).max())
                box_tol.append(1.0 + 1.0 / min(cached.cache[rel][3:]))
                crop_err.append(mean_abs_diff(a["image"], b["image"]))
                same_box_err.append(mean_abs_diff(
                    full_frame_crop(os.path.join(full.root, rel), b["bbox"]), b["image"]))
            print(f"phase data: {len(full)} eval crops, {name} against full-frame cv2: crop "
                  f"box in original pixels max |d| {max(box_err):.3f} px, "
                  f"{sum(e > 2.0 for e in box_err)} rows over 2 px, every row within its "
                  f"1 + 1/scale (largest {max(box_tol):.3f} px): "
                  f"{all(e <= t for e, t in zip(box_err, box_tol))}; a crop's mean |d| max "
                  f"{max(crop_err):.4f}, mean {np.mean(crop_err):.4f} of full scale; against "
                  f"the full frame cropped at the cached path's own box max "
                  f"{max(same_box_err):.4f}, mean {np.mean(same_box_err):.4f} (tol "
                  f"{TOL_EVAL_CROP})", flush=True)
            if any(e > t for e, t in zip(box_err, box_tol)):
                fail(f"data: a {name} eval crop box is off the full-frame one by more than "
                     "the cache's quantization")
            if max(same_box_err) >= TOL_EVAL_CROP:
                fail(f"data: the {name} eval crops are not the full frame's")

        # --profile_dir: 2 epochs of 2 steps; the trace is of the second.
        splits = os.path.join(tmp, "speedplus", "synthetic", "splits_krn")
        with open(os.path.join(splits, "train.csv")) as f:
            head = f.readlines()[:2 * B]
        with open(os.path.join(splits, "train_profile.csv"), "w") as f:
            f.writelines(head)
        prof_dir = os.path.join(tmp, "prof")
        _build.reset_launches()
        train.main(["--dataroot", tmp, "--input_shape", str(S), str(S), "--use_fp16",
                    "--num_workers", "8", "--batch_size", str(B), "--optimizer", "adamw",
                    "--randomize_texture", "--texture_ratio", "1.0", "--max_epochs", "2",
                    "--train_csv", "train_profile.csv", "--savedir", os.path.join(tmp, "ps"),
                    "--logdir", os.path.join(tmp, "pl"), "--profile_dir", prof_dir] + extra)
        torch.cuda.synchronize()
        print("", flush=True)
        traces = os.listdir(prof_dir) if os.path.isdir(prof_dir) else []
        if traces != ["trace_epochs2-2.json"]:
            fail(f"data: --profile_dir holds {traces}, expected trace_epochs2-2.json")
        path = os.path.join(prof_dir, traces[0])
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e["name"] for e in events if str(e.get("cat", "")).lower() == "kernel"]
        b1 = sum(B1_KERNEL in k for k in kernels)
        b2 = sum(any(n in k for n in B2_KERNELS) for k in kernels)
        print(f"phase data: --profile_dir, 2 epochs of 2 styled steps: {os.path.basename(path)}, "
              f"{os.path.getsize(path) / 1e6:.1f} MB, {len(kernels)} device kernels, of them "
              f"{b1} B1 ({B1_KERNEL}) and {b2} B2 ({' / '.join(B2_KERNELS)}); launches of the "
              f"run {dict(_build.launches)}", flush=True)
        if b1 == 0 or b2 == 0:
            fail("data: the profiler's trace names no B1 or no B2 device kernel")
        spans = collections.Counter(e["name"] for e in events
                                    if e.get("cat") == "user_annotation"
                                    and e["name"].startswith("speedplus."))
        print(f"phase data: --profile_dir, the program's spans {dict(sorted(spans.items()))}",
              flush=True)
        missing = [name for name in KRN_STYLED_SPANS if not spans[name]]
        if missing:
            fail(f"data: the profiler's trace holds none of the spans {missing}")
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


def torch_default_init(model, seed: int):
    """``model`` with torch's own default init drawn from ``seed``. The
    seeded stand-ins for the reference's PyTorch checkpoints start as a
    PyTorch module does, not as the port's models (flax's init)."""
    import torch
    import torch.nn as nn

    torch.manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.reset_parameters()
    return model


def checkpoint_transformer(seed: int):
    """A seeded ``checkpoint_transformer.pth`` payload: the Ghiasi
    generator's state_dict under the reference's ``layers.N.*`` keys."""
    from speedplusbaseline_tpu_torch.models.ghiasi import Ghiasi

    sd = {k.replace("layer", "layers.", 1): v
          for k, v in torch_default_init(Ghiasi(), seed).state_dict().items()}
    return {"state_dict_ghiasi": sd}


def checkpoint_stylepredictor(seed: int):
    """A seeded ``checkpoint_stylepredictor.pth`` payload: the reference's
    names, He-scaled convs (so that the embedding still depends on the image
    after about 50 layers), BN statistics away from 0 / 1,
    ``num_batches_tracked``."""
    import torch

    from speedplusbaseline_tpu_torch.models.style_predictor import StylePredictor

    sd = {}
    for k, v in torch_default_init(StylePredictor(), seed).state_dict().items():
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
    """Wraps the train CLI's ``train_epoch`` and ``style_augmentor`` for
    one run: the model's state_dict when the first epoch starts (before the
    first step) and the style augmentor it built. Restores both on exit."""

    def __init__(self, train):
        self.train, self.model_at_start, self.aug = train, None, None

    def __enter__(self):
        t = self.train
        self.epoch, self.style = t.train_epoch, t.style_augmentor

        def epoch(n, cfg, state, *a, **k):
            if self.model_at_start is None:
                self.model_at_start = {key: v.detach().cpu().clone()
                                       for key, v in state.model.state_dict().items()}
            return self.epoch(n, cfg, state, *a, **k)

        def style(*a, **k):
            self.aug = self.style(*a, **k)
            return self.aug

        t.train_epoch, t.style_augmentor = epoch, style
        return self

    def __exit__(self, *exc):
        self.train.train_epoch, self.train.style_augmentor = self.epoch, self.style


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


# Phase ddp: two ranks over gloo on one card, each with half of the global
# batch, against one process; parameters within TOL_DDP worst absolute, the
# JAX package's DP tests' bound for one SGD step (lr 1e-2, no momentum) in
# f32, and BatchNorm's running statistics within TOL_DDP of their scale.
# The bound means something only if the step moves more than it. The ranks'
# gap from the one process's update is at most DDP_REL of that update's L2
# norm, which a halved, unreduced or skipped update (a gap of half the update
# or more) cannot pass; and the one process's worst move is DDP_MOVE times
# TOL_DDP, so that a halved update fails the worst-absolute bound as well.
DDP_WORLD, DDP_MODELS, TOL_DDP, DDP_REPS = 2, ("krn", "spn", "dann"), 1e-4, 3
DDP_MOVE, DDP_REL = 2.0, 0.1


def ddp_setup(model: str, dev):
    """(state, step) of one f32 train step of ``model`` at full width on
    ``dev``: the styled KRN trainer at 224^2 and batch 48, the styled SPN
    trainer at 227^2 with 5000 classes and batch 48, the DANN step at 16 +
    16; SGD at lr 1e-2 without momentum, as the JAX package's DP tests;
    seeded weights and a seeded global batch, of which a rank of a process
    group keeps its rows. ``step(state)`` runs one step and returns its loss
    terms."""
    import numpy as np
    import torch

    from speedplusbaseline_tpu_torch.augment.styleaug import style_augmentor
    from speedplusbaseline_tpu_torch.config import default_cfg
    from speedplusbaseline_tpu_torch.engine import TrainState
    from speedplusbaseline_tpu_torch.engine.steps import make_dann_train_step, make_train_step
    from speedplusbaseline_tpu_torch.parallel import global_batch, rank_world

    side = SPN_S if model == "spn" else S
    n = DANN_B if model == "dann" else B
    cfg = default_cfg(model_name="spn" if model == "spn" else "krn", dann=model == "dann",
                      input_shape=(side, side), num_classes=SPN_CLASSES, batch_size=n,
                      optimizer="sgd", lr=1e-2, momentum=0.0, weight_decay=0.0)
    torch.manual_seed(0)
    state = TrainState.for_config(cfg, dev)
    world = rank_world()[1] if rank_world() else 1
    rows = global_batch(n // world)[1]
    rs = np.random.RandomState(1)

    def part(a):
        return torch.from_numpy(a[rows]).to(dev)

    def images():
        return rs.randint(0, 256, (n, side, side, 3), dtype=np.uint8)

    if model == "dann":
        src = {"image": part(images()), "keypts": part(rs.rand(n, 2, 11).astype(np.float32))}
        tgt = {"image": part(images())}
        dann = make_dann_train_step(cfg, dev)
        return state, lambda st: dann(st, src, tgt, np.float32(0.5))
    batch = {"image": part(images())}
    if model == "krn":
        batch["keypts"] = part(rs.rand(n, 2, 11).astype(np.float32))
    else:
        y_classes = np.zeros((n, SPN_CLASSES), np.float32)
        y_weights = np.zeros((n, SPN_CLASSES), np.float32)
        for i in range(n):
            idx = rs.choice(SPN_CLASSES, SPN_NEIGHBORS, replace=False)
            y_classes[i, idx] = 1.0 / SPN_NEIGHBORS
            y_weights[i, idx] = rs.dirichlet(np.ones(SPN_NEIGHBORS))
        batch.update(y_classes=part(y_classes), y_weights=part(y_weights))
    step = make_train_step(cfg, dev, style_augmentor(cfg, dev))  # f32: cfg has no --use_fp16
    return state, lambda st: step(st, batch, True)


def ddp_ranks(device: str):
    """One rank of phase ddp on ``device``: ``ddp_rank`` for each of
    DDP_MODELS in turn, in one process group. Returns {model: its result}."""
    import torch

    from speedplusbaseline_tpu_torch.config import full_f32

    full_f32()
    out = {}
    for model in DDP_MODELS:
        out[model] = ddp_rank(model, torch.device(device))
        torch.cuda.empty_cache()
    return out


def ddp_rank(model: str, dev):
    """One step of ddp_setup(model) on this rank's rows of the global batch
    on ``dev``, with its B1 / B2 launches printed. Returns (rank 0's state
    after the step, the launches summed over the ranks, the loss terms,
    step_times of DDP_REPS more steps)."""
    import torch
    import torch.distributed as dist

    from speedplusbaseline_tpu_torch.ops import _build
    from speedplusbaseline_tpu_torch.parallel import rank_world

    state, step = ddp_setup(model, dev)
    _build.reset_launches()
    losses = {k: float(v) for k, v in step(state).items()}
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    rank, world = rank_world()
    print(f"phase ddp: {model} rank {rank} of {world} ({dist.get_backend()} on {dev}): "
          f"B1 {launches['ghiasi_resblock']}, B2 {launches['instance_norm_film']} launches "
          "in its step", flush=True)
    out = {k: v.to("cpu", torch.float32, copy=True) for k, v in state.model.state_dict().items()}
    counts = torch.tensor([launches[k] for k in _build.launches], dtype=torch.float64,
                          device=dev)
    dist.all_reduce(counts)
    return out, dict(zip(_build.launches, counts.tolist())), losses, step_times(state, step)


def step_times(state, step):
    """(device busy ms, ms between CUDA events without a hold) a step of
    ``step(state)``, each over DDP_REPS steps: gloo's collectives wait on
    the host, so there the events time the whole step."""
    return (busy_ms(lambda: step(state), DDP_REPS),
            time_ms(lambda: step(state), reps=DDP_REPS, hold=False))


def ddp_nccl_rank():
    """Phase ddp's NCCL process: a process group of world 1 over NCCL on
    cuda:0 runs the collective path of the styled KRN step (global
    BatchNorm, the loss's gather, the gradient all_reduce). Returns (device
    busy ms, ms between CUDA events) a step with the collectives, the NCCL
    kernels and the count of memory copies the profiler saw in one step,
    and the same two times after the group is destroyed, without them."""
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from speedplusbaseline_tpu_torch.config import full_f32

    full_f32()
    dev = torch.device("cuda", 0)
    state, step = ddp_setup("krn", dev)
    with_ms = step_times(state, step)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(state)
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    nccl = sorted({e.key for e in device if "nccl" in e.key.lower()})
    copies = sum(e.count for e in device if "memcpy" in e.key.lower())
    dist.destroy_process_group()
    without_ms = step_times(state, step)
    return with_ms, nccl, copies, without_ms


def phase_ddp(dev):
    """Data parallelism on the one card: for each of DDP_MODELS, one
    process's f32 step on the whole global batch, then two ranks over gloo
    with CUDA tensors, spawned once for the three models, each take the same
    step on their halves of it, held to the one process's; then one
    process over NCCL at world 1 runs the collective path. Prints each
    step's ms with and without the collectives. Returns the ranks' B1 / B2
    launches, summed."""
    import numpy as np
    import torch

    from speedplusbaseline_tpu_torch.ops import _build
    from speedplusbaseline_tpu_torch.parallel import spawn

    print("phase ddp: one card serves both ranks (cuda:0, gloo with CUDA tensors); NCCL "
          "between cards (N > 1) is not run by this phase and not shown", flush=True)
    total = dict.fromkeys(_build.launches, 0)
    one = {}
    for model in DDP_MODELS:
        t0 = time.time()
        state, step = ddp_setup(model, dev)
        init = {k: v.to("cpu", torch.float32, copy=True)
                for k, v in state.model.state_dict().items()}
        _build.reset_launches()
        losses = {k: float(v) for k, v in step(state).items()}
        torch.cuda.synchronize()
        one_launches = dict(_build.launches)
        ref = {k: v.to("cpu", torch.float32, copy=True)
               for k, v in state.model.state_dict().items()}
        params = {k for k, _ in state.model.named_parameters()}
        one[model] = (init, losses, one_launches, ref, params, step_times(state, step),
                      time.time() - t0)
        del state, step
        torch.cuda.empty_cache()
    t0 = time.time()
    ranks = spawn(ddp_ranks, (str(dev),), DDP_WORLD, "gloo")
    print(f"phase ddp: {DDP_WORLD} ranks ran {', '.join(DDP_MODELS)} in one process group "
          f"in {time.time() - t0:.1f} s", flush=True)
    for model in DDP_MODELS:
        init, losses, one_launches, ref, params, one_ms, one_s = one[model]
        got, launches, rank_losses, ms = ranks[model]
        launches = {k: int(v) for k, v in launches.items()}
        for k, v in launches.items():
            total[k] += v
        worst = max((got[k] - ref[k]).abs().max().item() for k in params)
        move = max((ref[k] - init[k]).abs().max().item() for k in params)
        rel = (sum(((got[k] - ref[k]) ** 2).sum().item() for k in params)
               / sum(((ref[k] - init[k]) ** 2).sum().item() for k in params)) ** 0.5
        stats = [k for k in ref if k not in params]
        worst_stat = max(((got[k] - ref[k]).abs().max() / max(1.0, ref[k].abs().max())).item()
                         for k in stats) if stats else 0.0
        still = [k for k in ref if k.endswith("running_var")
                 and (torch.equal(got[k], init[k]) or torch.equal(ref[k], init[k]))]
        print(f"phase ddp: {model}: {DDP_WORLD} ranks against one process: parameters worst "
              f"|d| {worst:.3e} against the one process's worst move {move:.3e} (at least "
              f"{DDP_MOVE:g} x tol), |d| / |move| over all parameters {rel:.3e} (tol "
              f"{DDP_REL:g}), running statistics worst |d| / scale {worst_stat:.3e} "
              f"(tol {TOL_DDP:g}); losses {rank_losses} against {losses}; launches "
              f"{launches} against one process's {one_launches}; a step's device busy "
              f"time {ms[0]:.2f} ms on rank 0 over gloo, {one_ms[0]:.2f} ms in one process "
              f"(torch.profiler), between CUDA events {ms[1]:.2f} and {one_ms[1]:.2f} ms "
              f"({DDP_REPS} steps each); one process {one_s:.1f} s", flush=True)
        if not all(np.isfinite(list(rank_losses.values()))):
            fail(f"ddp: {model}: non-finite loss {rank_losses}")
        if worst > TOL_DDP or worst_stat > TOL_DDP or rel > DDP_REL:
            fail(f"ddp: {model}: {DDP_WORLD} ranks differ from one process")
        if move < DDP_MOVE * TOL_DDP:
            fail(f"ddp: {model}: one step moves the parameters by {move:.3e} at most, "
                 f"too little to tell the ranks' step from none at tol {TOL_DDP:g}")
        if still:
            fail(f"ddp: {model}: the step left running variances as they were: {still}")
        if launches != {k: v * DDP_WORLD for k, v in one_launches.items()}:
            fail(f"ddp: {model}: the ranks launched {launches}, one process {one_launches}")
    (with_busy, with_ms), nccl, copies, (without_busy, without_ms) = spawn(
        ddp_nccl_rank, (), 1, "nccl")
    print(f"phase ddp: NCCL at world 1, styled krn f32 step: device busy {with_busy:.3f} ms "
          f"with the collective path, {without_busy:.3f} ms without (torch.profiler, "
          f"{DDP_REPS} steps); between CUDA events {with_ms:.3f} and {without_ms:.3f} ms; "
          f"NCCL kernels in one step: {nccl or 'none seen by the profiler'}; memory copies "
          f"in it: {copies}", flush=True)
    return total


def busy_ms(fn, calls: int = 3) -> float:
    """Device busy ms a call of ``fn``: the device kernels torch.profiler
    records over ``calls`` calls after one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1000 / calls


def phase_ghiasi_phase(dev, sd):
    """The phase-space lowering against the plain one on the card: at 224^2
    and at 227^2 (the plain lowering on the input reflect-padded to 228),
    batch 48, f32 and bf16, the shipped weights ``sd``. Device time per
    restyle of each lowering by CUDA events and by torch.profiler, with the
    share of the two reflect-pad + 9x9 convs (layers 0 and 10) in each. Then
    a styled KRN step (224^2, batch 48, bf16, AdamW) with each lowering from
    the same weights and batch: finite losses, both printed (the two
    restyles differ within bf16 rounding, held above), and B1 five times and
    B2 twice (layers 1 and 2) in the phase-space step. Returns those
    launches."""
    import torch
    import torch.nn.functional as F

    from speedplusbaseline_tpu_torch import profile_step
    from speedplusbaseline_tpu_torch.models.ghiasi import Ghiasi, _conv, _nhwc, reflect_pad
    from speedplusbaseline_tpu_torch.ops import _build
    from speedplusbaseline_tpu_torch.ops import phase_conv as pc

    card = card_line()
    g = torch.Generator(device=dev).manual_seed(5)
    for side in (S, SPN_S):
        x = torch.rand(B, 3, side, side, device=dev, generator=g)
        st = torch.randn(B, 100, device=dev, generator=g) * 0.5
        pad = -side % 4
        xp = F.pad(x, (0, pad, 0, pad), mode="reflect")
        nets = {}
        for dtype in (torch.float32, torch.bfloat16):
            for phase in (False, True):
                nets[phase, dtype] = Ghiasi(dtype, phase_space=phase).to(dev).eval()
                nets[phase, dtype].load_state_dict(sd)
        with torch.no_grad():
            ref = nets[False, torch.float32](xp, st).float()
            compare(f"ghiasi_phase: phase-space Ghiasi ({B}, 3, {side}, {side}) f32 vs the "
                    "plain f32 lowering" + (f" of the input padded to {side + pad}" if pad else ""),
                    nets[True, torch.float32](x, st), ref, (1e-4, 1e-4))
            # bf16 against the f32 reference, each lowering: the phase one's
            # worst element within TOL_PHASE_BF16, its mean error within
            # twice the plain lowering's.
            err = {phase: (nets[phase, torch.bfloat16](x if phase else xp, st).float() - ref).abs()
                   for phase in (False, True)}
            over = {phase: int((e > TOL_GHIASI_BF16[0]).sum()) for phase, e in err.items()}
            print(f"  ghiasi_phase: ({B}, 3, {side}, {side}) bf16 against the plain f32 "
                  f"lowering: plain max {err[False].max().item():.3e} mean "
                  f"{err[False].mean().item():.3e}; phase-space max "
                  f"{err[True].max().item():.3e} mean {err[True].mean().item():.3e}; elements "
                  f"over {TOL_GHIASI_BF16[0]:g}: plain {over[False]}, phase-space {over[True]} "
                  f"of {err[True].numel()}", flush=True)
            if (err[True].max() > TOL_PHASE_BF16
                    or err[True].mean() > 2 * err[False].mean()):
                fail(f"ghiasi_phase: the bf16 phase-space lowering at {side}^2 is off")
            for dtype in (torch.float32, torch.bfloat16):
                h = side + pad
                a = torch.rand(B, 32, h, h, device=dev, generator=g).to(dtype).contiguous(
                    memory_format=torch.channels_last)
                xd = x.to(dtype).contiguous(memory_format=torch.channels_last)
                plain, phase = nets[False, dtype], nets[True, dtype]
                # the phase lowering's layer0 reads the input padded to 4k
                x4 = pc.space_to_depth2(_nhwc(xp.to(dtype)))
                a4 = pc.space_to_depth2(_nhwc(a))
                b0, b10 = plain.layer0.conv.bias, plain.layer10.conv.bias
                stages = {
                    False: (lambda: plain(xd, st),
                            lambda: (_conv(plain.layer0.conv, reflect_pad(xd, 4)),
                                     _conv(plain.layer10.conv, reflect_pad(a, 4)))),
                    True: (lambda: phase(xd, st),
                           lambda: (pc.conv9x9_phase(x4, None, b0, phase_w=phase.phase_w0),
                                    pc.conv9x9_phase_dp(a4, None, b10,
                                                        phase_w=phase.phase_w10)))}
                for lowering, (whole, convs) in stages.items():
                    ev, ev9 = time_ms(whole, reps=10), time_ms(convs, reps=10)
                    pr, pr9 = busy_ms(whole), busy_ms(convs)
                    print(f"phase ghiasi_phase: {'phase-space' if lowering else 'plain'} "
                          f"lowering, ({B}, 3, {side}, {side}) {str(dtype)[6:]}: "
                          f"{ev:.3f} ms a restyle by CUDA events, {pr:.3f} ms by "
                          f"torch.profiler; the 9x9 convs (layers 0 and 10, with their "
                          f"pads) {ev9:.3f} ms = {100 * ev9 / ev:.1f}% (events), "
                          f"{pr9:.3f} ms = {100 * pr9 / pr:.1f}% (profiler); {card}",
                          flush=True)
        del nets
        torch.cuda.empty_cache()

    out = {}
    for phase in (False, True):
        torch.manual_seed(0)
        state, step, batch = profile_step.build(dev, "krn", phase_space=phase)
        _build.reset_launches()
        losses = {k: float(v) for k, v in step(state, batch, True).items()}
        torch.cuda.synchronize()
        launches = dict(_build.launches)
        host = [profile_step.time_step(state, step, batch, True) for _ in range(2)]
        busy = profile_step.profile(state, step, batch, True, table=False,
                                    label=f"{'phase-space' if phase else 'plain'} styled krn")
        out[phase] = (losses, launches)
        print(f"phase ghiasi_phase: styled krn step ({B}, {S}^2, bf16, AdamW) with the "
              f"{'phase-space' if phase else 'plain'} lowering: first-step losses {losses}, "
              f"B1/B2 launches {launches}; host clock {[round(v, 2) for v in host]} ms, "
              f"device busy {busy:.2f} ms a step; {card}", flush=True)
        del state, step, batch
        torch.cuda.empty_cache()
    losses, launches = out[True]
    if not all(math.isfinite(v) for v in losses.values()):
        fail(f"ghiasi_phase: the phase-space styled step's losses {losses}")
    if launches != {"ghiasi_resblock": B1_CALLS_PER_STEP, "instance_norm_film": 2,
                    "reflect_conv9x9": 0, "reflect_conv3x3": 0}:
        fail(f"ghiasi_phase: one phase-space styled step launched {launches}")
    return launches


# meter name -> the trainer's scalar tag; DUMPS: meter name -> per-row dump.
VALID_TAGS = {"eR": "Valid/err_q [deg]", "eT": "Valid/err_t [m]",
              "speed (raw)": "Valid/speed (raw) [-]", "speed (thr)": "Valid/speed (thr) [-]"}
DUMPS = {"eR": "err_q.txt", "eT": "err_t.txt", "speed (raw)": "speed_raw.txt",
         "speed (thr)": "speed_mod.txt"}


class _Stderr:
    """Sends file descriptor 2 (this process's and its subprocesses') to a
    file for the block; ``text`` holds what was written, which is then
    written to the real stderr too."""

    def __init__(self, path: str):
        self.path, self.text = path, ""

    def __enter__(self):
        sys.stderr.flush()
        self.saved, self.file = os.dup(2), open(self.path, "w")
        os.dup2(self.file.fileno(), 2)
        return self

    def __exit__(self, *exc):
        sys.stderr.flush()
        os.dup2(self.saved, 2)
        os.close(self.saved)
        self.file.close()
        with open(self.path) as f:
            self.text = f.read()
        sys.stderr.write(self.text)
        sys.stderr.flush()


def check_summary(name: str, summary: dict) -> None:
    bad = {k: v for k, v in summary.items() if isinstance(v, (int, float))
           and (not math.isfinite(v) or v == -1)}
    if bad:
        fail(f"quality: {name} printed non-finite or missing values {bad}")
    print(f"phase quality: {name} {json.dumps(summary)}", flush=True)


# Phase quality's KRN memorization: 96 frames, 2 steps an epoch, validated on
# the train split every MEMO_TEST_EVERY epochs. From flax's default init SPEED
# first fell under half its epoch-20 value at epoch 200 on an H100 (PERF.md
# §6 PR 11); 260 leaves 30% more steps.
MEMO_EPOCHS, MEMO_TEST_EVERY = 260, 20


def phase_quality(dev):
    """The quality drivers through their modules on the card at a small size
    (renders of 320x200, 224^2, batch 48): KRN memorization by
    convergence_run as a process beside the rest (96 frames, MEMO_EPOCHS
    epochs, validated on the train split every MEMO_TEST_EVERY; the best
    SPEED score must be under half the first); the DANN A/B (96 + 96 frames,
    2 source-only epochs, 1 DANN epoch); the style-aug A/B's
    arm C on that root (2 epochs, 4 styled steps) and its sunlamp scores on
    48 frames; the transfer A/B on the DANN A/B's arm A as the donor (2
    epochs each arm): the
    boot arm logs the load from its assets directory and the scratch arm
    none, and the boot arm starts from the donor's trunk bit for bit;
    dump_spn_convs of a seeded SPN read back by
    maybe_load_pretrained bit for bit. The drivers' CLI arms run in this
    process (``arm_in_process`` in place of ``common.run_arm``), their
    launches counted by ``_build.launches`` around each; the memorization
    run's come through SPEEDPLUS_LAUNCH_LOG. Returns the phase's launches;
    B1 and B2 must have launched on arm C."""
    import torch

    from speedplusbaseline_tpu_torch import train
    from speedplusbaseline_tpu_torch.config import default_cfg
    from speedplusbaseline_tpu_torch.models.build import get_model
    from speedplusbaseline_tpu_torch.models.weight_convert import maybe_load_pretrained
    from speedplusbaseline_tpu_torch.ops import _build
    from speedplusbaseline_tpu_torch.quality import (common, dann_adaptation_run,
                                                     dump_krn_backbone, dump_spn_convs,
                                                     krn_transfer_run, styleaug_ab_run)

    small = ["--render_w", "320", "--render_h", "200"]
    saved = {k: os.environ.get(k) for k in (_build.LAUNCH_LOG_ENV, "SPEEDPLUS_ASSETS_DIR")}
    t_phase = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "launches.jsonl")
        os.environ[_build.LAUNCH_LOG_ENV] = log
        os.environ.pop("SPEEDPLUS_ASSETS_DIR", None)
        # The memorization runs beside the rest of the phase, as a process
        # group of its own (the driver and its train CLI), its output in a file.
        memo_root, memo_out = os.path.join(tmp, "memo"), os.path.join(tmp, "memo.log")
        with open(memo_out, "w") as out:
            memo = subprocess.Popen(
                [sys.executable, "-m", "speedplusbaseline_tpu_torch.quality.convergence_run",
                 "--root", memo_root, "--n_train", "96", "--epochs", str(MEMO_EPOCHS),
                 "--test_every", str(MEMO_TEST_EVERY), "--lr_decay_step", "50", "--test_csv",
                 "train.csv", "--save_epoch", str(MEMO_EPOCHS)] + small,
                stdout=out, stderr=subprocess.STDOUT, start_new_session=True)
        xroot = os.path.join(tmp, "xfer")
        boot_assets = os.path.join(xroot, "boot_assets")
        run_arm, arms, boot_start = common.run_arm, [], []

        def arm_in_process(cli, args, timeout_s=None, env=None):
            """A driver's CLI arm (``common.run_arm``) in this process: ``env``
            is its environment for the call; returns its wall and records its
            B1 / B2 launches in ``arms``. The transfer A/B's boot arm runs
            under _Capture, which reads its model before the first step."""
            module = importlib.import_module(f"speedplusbaseline_tpu_torch.{cli}")
            saved_env, env = dict(os.environ), dict(os.environ if env is None else env)
            t0, before = time.time(), dict(_build.launches)
            os.environ.clear()
            os.environ.update(env)
            try:
                if cli == "train" and env.get("SPEEDPLUS_ASSETS_DIR") == boot_assets:
                    with _Capture(train) as seen:
                        module.main(list(args))
                    boot_start.append(seen.model_at_start)
                else:
                    module.main(list(args))
                torch.cuda.synchronize()
            finally:
                os.environ.clear()
                os.environ.update(saved_env)
            arms.append((cli, list(args), {k: _build.launches[k] - before[k] for k in before}))
            torch.cuda.empty_cache()
            wall = time.time() - t0
            print(f"\n[{cli}] arm finished in {wall:.1f} s (in this process)", flush=True)
            return wall

        common.run_arm = arm_in_process
        try:
            t0 = time.time()
            ab = os.path.join(tmp, "ab")
            check_summary("dann_adaptation_run", dann_adaptation_run.main(
                ["--root", ab, "--n_src", "96", "--n_tgt", "96", "--epochs_src", "2",
                 "--epochs_dann", "1", "--test_every", "1"] + small))
            print(f"phase quality: DANN A/B {time.time() - t0:.1f} s", flush=True)
            before_c = len(arms)
            t0 = time.time()
            n_photo, styleaug_ab_run.N_PHOTO = styleaug_ab_run.N_PHOTO, 48
            try:
                check_summary("styleaug_ab_run", styleaug_ab_run.main(
                    ["--root", ab, "--epochs", "2", "--test_every", "1"] + small))
            finally:
                styleaug_ab_run.N_PHOTO = n_photo
            arm_c = [a for a in arms[before_c:] if "--randomize_texture" in a[1]]
            # Arm C trains in f32 (no --use_fp16): its generator runs B1 and B2,
            # and E1 and E2, which serve bf16 only, not at all.
            if len(arm_c) != 1 or not (arm_c[0][2]["ghiasi_resblock"]
                                       and arm_c[0][2]["instance_norm_film"]) \
                    or arm_c[0][2]["reflect_conv9x9"] or arm_c[0][2]["reflect_conv3x3"]:
                fail(f"quality: arm C's kernel launches {arm_c}: B1 and B2 must launch, "
                     f"E1 and E2 not (f32)")
            print(f"phase quality: style-aug arm C launched {arm_c[0][2]}; "
                  f"{time.time() - t0:.1f} s", flush=True)

            t0 = time.time()
            donor = os.path.join(ab, "save_src", "model_best.pt")
            with _Stderr(os.path.join(tmp, "xfer.err")) as err:
                check_summary("krn_transfer_run", krn_transfer_run.main(
                    ["--root", xroot, "--donor", donor, "--epochs", "2", "--test_every",
                     "1"] + small))
            loads = [x for x in err.text.splitlines()
                     if "MobileNetV2 ImageNet backbone loaded from" in x]
            if len(loads) != 1 or not loads[0].endswith(
                    os.path.join(boot_assets, common.BACKBONE_ASSET)):
                fail(f"quality: the transfer arms' backbone loads {loads}: the boot arm "
                     f"alone must load from {boot_assets}")
            donor_base = dump_krn_backbone.base_state_dict(
                torch.load(donor, map_location="cpu", weights_only=True))
            if len(boot_start) != 1:
                fail(f"quality: the transfer A/B ran {len(boot_start)} boot arms, not 1")
            start = {k[len("base."):]: v for k, v in boot_start[0].items()
                     if k.startswith("base.")}
            if start.keys() != donor_base.keys() or not all(
                    torch.equal(start[k], donor_base[k]) for k in donor_base):
                fail("quality: the boot arm's trunk at step 0 is not the donor's bit for bit")
            print(f"phase quality: transfer chain dump_krn_backbone -> convert_weights -> "
                  f"maybe_load_pretrained: the boot arm alone logged the load and starts "
                  f"from the donor's {len(donor_base)} trunk tensors bit for bit; "
                  f"{time.time() - t0:.1f} s", flush=True)

            spn_cfg = default_cfg(model_name="spn", num_classes=SPN_CLASSES)
            torch.manual_seed(41)
            spn_sd = get_model(spn_cfg).state_dict()
            torch.save(spn_sd, os.path.join(tmp, "spn.pt"))
            spn_assets = os.path.join(tmp, "spn_assets")
            dump_spn_convs.main([os.path.join(tmp, "spn.pt"),
                                 os.path.join(spn_assets, "bvlc_alexnet.npy"),
                                 "--mirror_assets"])
            booted = get_model(spn_cfg)
            if not maybe_load_pretrained(spn_cfg, booted, spn_assets):
                fail("quality: maybe_load_pretrained did not load the dumped SPN convs")
            convs = [k for k in spn_sd if k.startswith(tuple(f"conv{i}." for i in range(1, 6)))]
            got = booted.state_dict()
            if len(convs) != 10 or not all(torch.equal(got[k], spn_sd[k]) for k in convs):
                fail("quality: SPN conv1-5 through dump_spn_convs differ from the checkpoint's")
            print(f"phase quality: dump_spn_convs -> maybe_load_pretrained: SPN's {len(convs)} "
                  "conv1-5 tensors bit for bit", flush=True)

            rc = memo.wait(timeout=600)
            with open(memo_out) as f:
                memo_lines = f.read().splitlines()
            if rc != 0:
                fail(f"quality: the memorization run exited {rc}: {memo_lines[-20:]}")
            print(memo_lines[-1], flush=True)
            check_summary("convergence_run", json.loads(memo_lines[-1]))
            curve = common.curve(os.path.join(memo_root, "log"))
            speeds = [curve[e][common.VALID_TAGS[2]] for e in sorted(curve)]
            if not min(speeds[1:]) < 0.5 * speeds[0]:
                fail(f"quality: KRN memorization did not halve the SPEED score: {speeds}")
            print(f"phase quality: KRN memorization at {S}^2 on 96 frames (train split), SPEED "
                  f"{[round(v, 4) for v in speeds]} at epochs {sorted(curve)}: best "
                  f"{min(speeds[1:]):.4f} < half the first {speeds[0]:.4f}", flush=True)
        finally:
            common.run_arm = run_arm
            if memo.poll() is None:
                os.killpg(memo.pid, signal.SIGKILL)
                memo.wait()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        with open(log) as f:
            runs = [json.loads(x) for x in f]
    launches = {k: sum(r["launches"].get(k, 0) for r in runs) + sum(a[2][k] for a in arms)
                for k in _build.launches}
    print(f"phase quality: {len(arms)} CLI arms in this process, {len(runs)} CLI processes "
          f"(the memorization run), launches {launches}, "
          f"{time.time() - t_phase:.1f} s", flush=True)
    return launches


class _PlainGhiasi:
    """Within it, the generator calls the plain PyTorch version of B1 and / or
    B2 (and of E1 and E2, which only a bf16 generator reaches) in place of
    its wrapper, on the card too."""

    def __init__(self, b1: bool = True, b2: bool = True):
        self.b1, self.b2 = b1, b2

    def __enter__(self):
        from speedplusbaseline_tpu_torch.models import ghiasi
        from speedplusbaseline_tpu_torch.ops import (ghiasi_resblock_plain,
                                                     instance_norm_film_plain,
                                                     reflect_conv3x3_plain,
                                                     reflect_conv9x9_plain)

        self.saved = (ghiasi.ghiasi_resblock, ghiasi.instance_norm_film, ghiasi.reflect_conv9x9,
                      ghiasi.reflect_conv3x3)
        if self.b1:
            ghiasi.ghiasi_resblock = ghiasi_resblock_plain
        if self.b2:
            ghiasi.instance_norm_film = instance_norm_film_plain
        if self.b1 and self.b2:
            ghiasi.reflect_conv9x9 = reflect_conv9x9_plain
            ghiasi.reflect_conv3x3 = reflect_conv3x3_plain

    def __exit__(self, *exc):
        from speedplusbaseline_tpu_torch.models import ghiasi

        (ghiasi.ghiasi_resblock, ghiasi.instance_norm_film, ghiasi.reflect_conv9x9,
         ghiasi.reflect_conv3x3) = self.saved


def asset_content(dev):
    """tests/test_styleaug_quality.py's 64^2 content (2 images), NCHW on ``dev``."""
    import numpy as np
    import torch

    rs = np.random.RandomState(3)
    xy = np.stack(np.meshgrid(np.arange(64), np.arange(64)), -1) / 64.0
    img = 0.5 + 0.35 * np.sin(2 * np.pi * (xy @ np.array([[5.0], [2.0]])))
    img = np.repeat(img[None, :, :, :], 3, axis=-1) + 0.05 * rs.randn(2, 64, 64, 3)
    return torch.from_numpy(np.clip(img, 0, 1).astype(np.float32)).permute(0, 3, 1, 2).to(dev)


def phase_toy_ghiasi(dev, card: str):
    """The trainable generator and the toy trainer on the card (see the module
    docstring, phase 16). Returns the trainer's launches."""
    import torch

    from speedplusbaseline_tpu_torch import train_toy_ghiasi as toy
    from speedplusbaseline_tpu_torch.augment.styleaug import (StyleAugmentor,
                                                              load_ghiasi_params,
                                                              load_style_stats,
                                                              random_style_stats)
    from speedplusbaseline_tpu_torch.convert import read_flax_msgpack
    from speedplusbaseline_tpu_torch.io_utils import default_assets_dir
    from speedplusbaseline_tpu_torch.models.ghiasi import Ghiasi
    from speedplusbaseline_tpu_torch.ops import _build

    t_phase = time.time()
    try:
        stats = load_style_stats(default_assets_dir())
    except FileNotFoundError:
        stats = random_style_stats(0)
    A, mean = (torch.as_tensor(a, device=dev) for a in stats[:2])
    draws = toy.draw_batch(torch.Generator(dev).manual_seed(5), TOY_B, TOY_S)
    x = toy.make_batch(draws)
    emb = toy.embed(draws["z"], A, mean)
    target = toy.style_targets(x, emb)
    torch.manual_seed(0)
    net = Ghiasi().to(dev)
    params = dict(net.named_parameters())
    noise = torch.randn(x.shape, device=dev, generator=torch.Generator(dev).manual_seed(9))
    # path: (plain B1, plain B2, input); the last three only show where a
    # difference comes from and how far the gradients amplify an input change.
    paths = {"kernels": (False, False, x), "plain": (True, True, x),
             "B1 alone": (False, True, x), "B2 alone": (True, False, x),
             "plain on x * (1 + 1e-5 noise)": (True, True, x * (1 + 1e-5 * noise))}
    grads = {}
    for path, (b1, b2, inp) in paths.items():
        before = dict(_build.launches)
        with _PlainGhiasi(b1, b2):
            loss = toy.mse_loss(net, inp, emb, target)
        launched = {k: _build.launches[k] - before[k] for k in before}
        grads[path] = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                           allow_unused=True)))
        expected = {"ghiasi_resblock": 5 * (not b1), "instance_norm_film": 6 * (not b2),
                    "reflect_conv9x9": 0, "reflect_conv3x3": 0}  # the toy generator is f32
        if launched != expected:
            fail(f"toy_ghiasi: the {path} path's forward launched {launched}, not {expected}")
        if path in ("kernels", "plain"):
            print(f"phase toy_ghiasi: {path} path, loss {loss.item():.6f}, forward launches "
                  f"{launched}", flush=True)
    missing = [n for n, g in grads["kernels"].items() if g is None]
    if missing:
        fail(f"toy_ghiasi: no gradient reached {missing}")
    layers = list(dict.fromkeys(n.split(".")[0] for n in params))
    for path in paths:
        if path == "plain":
            continue
        errors = {metric: {} for metric in TOL_TOY_GRAD}
        for layer in layers:
            names = [n for n in params if n.split(".")[0] == layer]
            got, ref = (torch.cat([grads[p][n].flatten() for n in names])
                        for p in (path, "plain"))
            if not torch.isfinite(got).all():
                fail(f"toy_ghiasi: a gradient of {layer} is not finite on the {path} path")
            errors["relative L2"][layer] = ((got - ref).norm() / ref.norm()).item()
            errors["worst / largest"][layer] = ((got - ref).abs().max()
                                                / ref.abs().max()).item()
        for metric, tol in TOL_TOY_GRAD.items():
            bound = f" (tol {tol:g})" if path == "kernels" else ""
            print(f"phase toy_ghiasi: gradients of {len(params)} parameters at ({TOY_B}, 3, "
                  f"{TOY_S}, {TOY_S}) f32 on the card, {path} vs plain, {metric} by layer"
                  f"{bound}: " + ", ".join(f"{k} {v:.2e}" for k, v in errors[metric].items()),
                  flush=True)
            if path == "kernels" and not max(errors[metric].values()) <= tol:
                fail(f"toy_ghiasi: kernel gradients differ from plain ones by "
                     f"{max(errors[metric].values()):.3e} ({metric})")
    del net, params, grads

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ghiasi_params.msgpack")
        _build.reset_launches()
        t0 = time.time()
        result = toy.main(["--out", out])
        wall = time.time() - t0
        launches = dict(_build.launches)
        ms = result["train_s"] * 1e3 / TOY_STEPS
        print(f"phase toy_ghiasi: train_toy_ghiasi at its defaults ({TOY_STEPS} Adam steps, "
              f"batch {TOY_B}, {TOY_S}^2, f32) on {card}: final MSE {result['final_mse']:.5f} "
              f"(limit {TOY_MSE_MAX}), MSE by step {result['mse']}, {ms:.2f} ms a step, "
              f"wall {wall:.1f} s, launches {launches}", flush=True)
        if not result["final_mse"] <= TOY_MSE_MAX:
            fail(f"toy_ghiasi: final MSE {result['final_mse']} above {TOY_MSE_MAX}")
        if (launches["ghiasi_resblock"] < 5 * TOY_STEPS
                or launches["instance_norm_film"] < 6 * TOY_STEPS):
            fail(f"toy_ghiasi: launches {launches}, fewer than 5 B1 and 6 B2 a step")

        def shapes(tree):
            if isinstance(tree, dict):
                return {k: shapes(v) for k, v in tree.items()}
            return tree.shape, str(tree.dtype)

        shipped = os.path.join(default_assets_dir(), "ghiasi_params.msgpack")
        if shapes(read_flax_msgpack(out)) != shapes(read_flax_msgpack(shipped)):
            fail("toy_ghiasi: the written file's keys or shapes differ from the shipped asset's")
        aug = StyleAugmentor(alpha=0.5, stats=stats, device=dev)
        aug.ghiasi.load_state_dict(load_ghiasi_params(out))

    content = asset_content(dev)

    def restyle(seed):
        return aug(content, torch.Generator(dev).manual_seed(seed)).float()

    a, b = restyle(1), restyle(2)
    c0, x0 = a[0].flatten().double(), content[0].flatten().double()
    c0, x0 = c0 - c0.mean(), x0 - x0.mean()
    checks = {"content kept (corr > 0.5)": float(c0 @ x0 / (c0.norm() * x0.norm() + 1e-9)),
              "embedding conditioned (mean |a-b| > 0.01)": float((a - b).abs().mean()),
              "deterministic per generator seed": torch.equal(restyle(7), restyle(7)),
              "changes the image (> 0.01)": float((a - content).abs().mean())}
    print(f"phase toy_ghiasi: the trained weights through StyleAugmentor on the card: "
          f"{checks}", flush=True)
    if not (torch.isfinite(a).all() and a.shape == content.shape):
        fail("toy_ghiasi: the restyle is not finite or not of the content's shape")
    values = list(checks.values())
    if not (values[0] > 0.5 and values[1] > 0.01 and values[2] and values[3] > 0.01):
        fail(f"toy_ghiasi: a behaviour check failed: {checks}")
    print(f"phase toy_ghiasi: {time.time() - t_phase:.1f} s", flush=True)
    return launches


# Phase spn_stall: the memorization probe on one fixed batch (SPN at 227^2,
# 500 classes, batch 48, AdamW lr 1e-3 wd 0.01 held, dropout on, clip by
# value) must bring loss_c under STALL_PROBE_MAX within STALL_PROBE_STEPS
# steps: JAX's probe reaches the n-hot entropy floor ln 5 = 1.61 in under
# 100 steps at 5000 classes (BASELINE.md:355). Then the live-ReLU shares of
# STALL_LIVE_SEEDS at STALL_LIVE_STEPS, printed, and Run S's stall rate of
# PERF.md §6, printed (the rate is a training-quality record, not a check).
STALL_PROBE_STEPS, STALL_PROBE_MAX, STALL_FRAMES = 200, 2.5, 96
STALL_LIVE_SEEDS, STALL_LIVE_STEPS = (2, 1), (0, 64)
# Run S's stall rate over its first 4 epochs (quality.spn_seed_sweep and
# tests/jax_spn_stall.py; PERF.md §6).
SPN_STALL_RATE = ("the port 4 of 12 seeds (2021, 0-10; 5 of 16 with 11-14) on an NVIDIA H100 "
                  "80GB HBM3 at 700 W, JAX 3 of 6 (2021, 0-4) on a CPU; Fisher exact p 0.627")


def phase_spn_stall(dev):
    """The port's SPN memorization probe (``quality.probe_spn_memorize``)
    on one batch of 48 crops of a 96-frame 320x200 root labelled against
    500 attitude bins, and the live-ReLU shares (``quality.spn_seed_sweep``)
    of two seeds trained as the train CLI does on that root, the lr held.
    This path restyles nothing: B1 and B2 must launch 0 times. Returns the
    launches."""
    from speedplusbaseline_tpu_torch.ops import _build
    from speedplusbaseline_tpu_torch.config import parse_cfg
    from speedplusbaseline_tpu_torch.quality import (convergence_run, probe_spn_memorize,
                                                     spn_seed_sweep as sweep)

    t_phase = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        convergence_run.prepare(tmp, STALL_FRAMES, 320, 200, "spn", True, sweep.NUM_CLASSES,
                                dev)
        print(f"phase spn_stall: {STALL_FRAMES} frames rendered, labelled and cached in "
              f"{time.time() - t_phase:.1f} s", flush=True)
        flags = sweep.run_s_flags(tmp, 2021, 1, os.path.join(tmp, "probe"))
        _build.reset_launches()
        t0 = time.time()
        recs = probe_spn_memorize.main(flags + ["--lr_decay_step", "10000",
                                                "--steps", str(STALL_PROBE_STEPS)])
        wall = time.time() - t0
        last = recs[-1]
        print(f"phase spn_stall: probe, 1 batch of 48, {STALL_PROBE_STEPS} steps: loss_c "
              f"{[round(r['loss_c'], 4) for r in recs]} at steps {[r['step'] for r in recs]}, "
              f"{1e3 * wall / STALL_PROBE_STEPS:.2f} ms a step on the host clock", flush=True)
        if not (math.isfinite(last["loss_c"]) and last["loss_c"] < STALL_PROBE_MAX):
            fail(f"spn_stall: the probe's loss_c {last['loss_c']} did not fall under "
                 f"{STALL_PROBE_MAX} in {STALL_PROBE_STEPS} steps")
        epochs = max(STALL_LIVE_STEPS) * 48 // STALL_FRAMES
        for seed in STALL_LIVE_SEEDS:
            cfg = parse_cfg(sweep.run_s_flags(tmp, seed, epochs, os.path.join(tmp, "live"))
                            + ["--lr_decay_step", "10000"])
            shares, loss_c = sweep.live_run(cfg, STALL_LIVE_STEPS)
            if sorted(shares) != sorted(STALL_LIVE_STEPS):
                fail(f"spn_stall: live shares at steps {sorted(shares)}, wanted "
                     f"{STALL_LIVE_STEPS}")
            for step in STALL_LIVE_STEPS:
                print(f"phase spn_stall: seed {seed} step {step:3d} live ReLU units "
                      + " ".join(f"{n} {shares[step][n]:.3f}" for n in sweep.LIVE_LAYERS),
                      flush=True)
            if not all(math.isfinite(v) for v in loss_c):
                fail(f"spn_stall: seed {seed} loss_c {loss_c}")
            print(f"phase spn_stall: seed {seed} loss_c by epoch (2 steps each) "
                  f"{[round(v, 4) for v in loss_c[::4]]} (every 4th)", flush=True)
        launches = dict(_build.launches)
    if any(launches.values()):
        fail(f"spn_stall: the path restyles nothing, but the kernels launched {launches}")
    print(f"phase spn_stall: Run S stall rate (recorded, first 4 epochs): {SPN_STALL_RATE}; "
          f"launches {launches}; {time.time() - t_phase:.1f} s", flush=True)
    return launches


def positive_numbers(what: str, record: dict, keys, phase: str = "perf") -> None:
    """Each of ``keys`` in ``record`` is a finite number above 0."""
    for k in keys:
        v = record.get(k)
        if not (isinstance(v, (int, float)) and math.isfinite(v) and v > 0):
            fail(f"{phase}: {what}'s {k} is {v!r}, wanted a finite positive number")


def phase_perf(card: str):
    """The measuring modules (speedplusbaseline_tpu_torch/perf/) on the card
    at a small size, each through its CLI's ``main`` in this process:
    bench_host_loader over PERF_LOADER_IMAGES images; bench_e2e over
    PERF_E2E_IMAGES rows for PERF_E2E_EPOCHS epochs, both modes, on a root
    that write_dataset filled with frames of phase main's kind (the module's
    own renderer, which draws each frame's markers at full resolution and
    takes most of the module's time at its defaults, runs in
    tests/test_torch_perf.py); ab_bf16_out's four arms and ab_spn_styled's
    two with --n PERF_AB_STEPS, each through its CLI's ``--arm`` path (the
    path each arm's child takes under the CLI's parent; the parent's
    ``run_child`` is phase bench's). Each JSON line must hold its keys with
    finite positive numbers and the card line. Counted by
    ``_build.launches`` around each call, every A/B arm launches B1 / B2
    PERF_LAUNCHES times a styled step of its lowering (plain: 5 / 6, phase:
    5 / 2), and the two benches launch neither. Returns the phase's
    launches."""
    import torch

    from speedplusbaseline_tpu_torch.ops import _build
    from speedplusbaseline_tpu_torch.perf import (ab_bf16_out, ab_spn_styled, bench_e2e,
                                                  bench_host_loader)

    t_phase = time.time()
    launches = dict.fromkeys(_build.launches, 0)

    def run(module, argv):
        """``module.main(argv)``'s record and its B1 / B2 launches."""
        t0, before = time.time(), dict(_build.launches)
        record = module.main(argv)
        n = {k: _build.launches[k] - before[k] for k in before}
        for k, v in n.items():
            launches[k] += v
        if record.get("card") != card:
            fail(f"perf: {module.__name__} {argv}'s card {record.get('card')!r}, not {card!r}")
        print(f"phase perf: {module.__name__.rsplit('.', 1)[1]} {' '.join(argv)} "
              f"({time.time() - t0:.1f} s): launches {n}", flush=True)
        return record, n

    loader, n = run(bench_host_loader, [str(PERF_LOADER_IMAGES)])
    positive_numbers("bench_host_loader", loader, (
        "python_img_s_per_worker", "cached_img_s_per_worker", "dataloader_img_s",
        "host_cores"))
    if (loader["native_img_s_per_worker"] is None) == NATIVE_ON_CARD:
        fail(f"perf: bench_host_loader's native rate {loader['native_img_s_per_worker']} "
             f"with NATIVE_ON_CARD {NATIVE_ON_CARD}")
    if any(n.values()):
        fail(f"perf: bench_host_loader launched {n}; only the A/B arms restyle")

    with tempfile.TemporaryDirectory() as tmp:
        write_dataset(tmp, "krn", PERF_E2E_IMAGES, n_images=PERF_E2E_IMAGES)
        e2e, n = run(bench_e2e, [str(PERF_E2E_IMAGES), str(PERF_E2E_EPOCHS), "both", tmp])
    positive_numbers("bench_e2e", e2e, ("e2e_from_disk_img_s", "e2e_cached_img_s",
                                        "cache_build_s", "host_cores", "num_workers"))
    if e2e["native"] != NATIVE_ON_CARD:
        fail(f"perf: bench_e2e ran the native core: {e2e['native']}")
    if any(n.values()):
        fail(f"perf: bench_e2e launched {n}; only the A/B arms restyle")

    arms = {}
    for module in (ab_bf16_out, ab_spn_styled):
        name = module.__name__.rsplit(".", 1)[1]
        for arm in module.ARMS:
            record, n = run(module, ["--arm", arm, "--n", str(PERF_AB_STEPS)])
            positive_numbers(f"{name} {arm}", record, ("styled_step_ms", "device_busy_ms",
                                                       "steps"))
            want = {k: v * record["steps"] for k, v in PERF_LAUNCHES[record["lowering"]].items()}
            if n != want:
                fail(f"perf: arm {arm} ({record['lowering']} lowering, {record['steps']} "
                     f"styled steps) launched {n}, wanted {want}")
            arms[arm] = record
    torch.cuda.empty_cache()
    print(f"phase perf: arms (styled step ms on the host clock, device busy ms) "
          + ", ".join(f"{a} {r['styled_step_ms']:.2f} / {r['device_busy_ms']:.2f}"
                      for a, r in arms.items())
          + f"; launches {launches}; {time.time() - t_phase:.1f} s", flush=True)
    return launches


# Phase bench: the keys of the bench's line that hold no number (the native
# host rate is null where NATIVE_ON_CARD is false) and the seconds it may take.
BENCH_TEXT_KEYS = {"metric": "krn_train_images_per_sec_per_chip", "unit": "img/s",
                   "baseline_is_estimate": True}
BENCH_TIMEOUT_S = 900


def phase_bench(card: str):
    """The bench at its defaults, as a subprocess on the card (KRN at 224^2
    gated at texture_ratio 0.5, the eval step, the AdamW DANN step, the plain
    and styled SPN steps, each in a child process, and the host rates). Its
    last line must hold every number finite and positive, the card line and
    the default (plain) lowering. Through SPEEDPLUS_LAUNCH_LOG, the krn and
    spn children launch B1 / B2 PERF_LAUNCHES times their styled steps, as
    ``bench.krn_styled_steps`` and ``spn_styled_steps`` count them, and the
    other processes launch neither. Returns the phase's launches."""
    from speedplusbaseline_tpu_torch import bench
    from speedplusbaseline_tpu_torch.ops import _build

    here = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "launches.jsonl")
        cmd = [sys.executable, "-m", "speedplusbaseline_tpu_torch.bench"]
        out = subprocess.run(cmd, cwd=here, env=dict(os.environ, SPEEDPLUS_LAUNCH_LOG=log),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             timeout=BENCH_TIMEOUT_S)
        lines = out.stdout.splitlines()
        if out.returncode != 0 or not lines or not lines[-1].startswith("{"):
            fail(f"bench: exited with {out.returncode}:\n" + "\n".join(lines[-60:]))
        with open(log) as f:
            logged = [json.loads(x) for x in f]
    line = json.loads(lines[-1])
    print("\n".join(ln for ln in lines[:-1] if "device busy" in ln), flush=True)
    print(f"phase bench: {time.time() - t_phase:.1f} s: {lines[-1]}", flush=True)
    for k, v in BENCH_TEXT_KEYS.items():
        if line.get(k) != v:
            fail(f"bench: {k} is {line.get(k)!r}, not {v!r}")
    if line.get("card") != card or line.get("lowering") != "plain":
        fail(f"bench: card {line.get('card')!r} (wanted {card!r}), lowering "
             f"{line.get('lowering')!r} (wanted the default, plain)")
    native = line.get("host_native_img_s_per_worker", "missing")
    if (native is None) == NATIVE_ON_CARD:
        fail(f"bench: the native host rate is {native!r} with NATIVE_ON_CARD {NATIVE_ON_CARD}")
    numbers = [k for k in line if k not in BENCH_TEXT_KEYS and k not in (
        "card", "lowering", "host_rate_spread", "host_native_lt_python")
        and not (k == "host_native_img_s_per_worker" and native is None)]
    positive_numbers("the line", line, numbers, "bench")
    for path, spread in line["host_rate_spread"].items():
        positive_numbers(f"host_rate_spread {path}", dict(enumerate(spread)), (0, 1), "bench")

    per_step = PERF_LAUNCHES[line["lowering"]]
    styled = {"krn": bench.krn_styled_steps(), "spn": bench.spn_styled_steps()}
    launches = dict.fromkeys(_build.launches, 0)
    measured = set()
    for entry in logged:
        argv = entry["argv"]
        measure = argv[argv.index("--measure") + 1] if "--measure" in argv else None
        measured.add(measure)
        want = {k: v * styled.get(measure, 0) for k, v in per_step.items()}
        if entry["launches"] != want:
            fail(f"bench: {argv} launched {entry['launches']}, wanted {want} "
                 f"({styled.get(measure, 0)} styled steps)")
        for name, n in entry["launches"].items():
            launches[name] += n
    if measured != {None, *bench.MEASURES}:
        fail(f"bench: the launch log holds the processes {measured}")
    print(f"phase bench: styled steps {styled}; launches {launches}", flush=True)
    return launches


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


def phase_build() -> None:
    """nvcc builds the kernels; their ptxas lines and B1's HGMMA count."""
    from speedplusbaseline_tpu_torch.ops import _build

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


def main() -> None:
    t_start = time.time()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        from speedplusbaseline_tpu_torch.config import full_f32
        from speedplusbaseline_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"the port is not beside this script: {e}")
    if "jax" in sys.modules:
        fail("jax was imported")
    dev = torch.device("cuda", 0)
    full_f32()

    seconds = {}

    def timed(name, fn, *args):
        """``fn(*args)``, its seconds added to the phase ``name``."""
        t = time.time()
        out = fn(*args)
        seconds[name] = seconds.get(name, 0.0) + time.time() - t
        print(f"phase {name}: {time.time() - t:.1f} s", flush=True)
        return out

    card = timed("device", card_line)
    print(f"phase device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    timed("build", phase_build)
    report = timed("kernels", phase_kernels, dev)
    from speedplusbaseline_tpu_torch.augment.styleaug import load_ghiasi_params
    from speedplusbaseline_tpu_torch.io_utils import default_assets_dir

    asset = load_ghiasi_params(os.path.join(default_assets_dir(), "ghiasi_params.msgpack"))
    timed("ghiasi", phase_ghiasi, dev, asset, "asset weights")
    timed("ghiasi", phase_ghiasi_flax_init, dev)
    timed("geometry", phase_geometry, dev)
    timed("spn_geometry", phase_spn_geometry, dev)
    launches, main_times = timed("main", phase_main, dev, "krn", 6)
    launches = {"krn": launches, "spn": timed("spn_main", phase_main, dev, "spn", 4)[0]}
    timed("grl", phase_grl, dev)
    launches["dann"] = timed("dann", phase_dann, dev)
    launches["pretrained"] = timed("pretrained", phase_pretrained, dev, card)
    launches["style_predictor"] = timed("style_predictor", phase_style_predictor, dev, card)
    launches["data"] = timed("data", phase_data, dev, main_times)
    for model in ("krn", "spn"):
        timed("resident", phase_resident, dev, model)
        timed("eval" if model == "krn" else "spn_eval", phase_eval, dev, model)
    timed("resident", phase_resident_dann, dev)
    launches["ddp"] = timed("ddp", phase_ddp, dev)
    launches["ghiasi_phase"] = timed("ghiasi_phase", phase_ghiasi_phase, dev, asset)
    launches["quality"] = timed("quality", phase_quality, dev)
    launches["toy_ghiasi"] = timed("toy_ghiasi", phase_toy_ghiasi, dev, card)
    launches["spn_stall"] = timed("spn_stall", phase_spn_stall, dev)
    launches["perf"] = timed("perf", phase_perf, card)
    launches["bench"] = timed("bench", phase_bench, card)
    if "jax" in sys.modules:
        fail("jax was imported")

    src = {"instance_norm_film": ("speedplusbaseline_tpu_torch/csrc/instancenorm.cu",
                                  "speedplusbaseline_tpu/ops/pallas_instancenorm.py:71"),
           "ghiasi_resblock": ("speedplusbaseline_tpu_torch/csrc/resblock.cu",
                               "speedplusbaseline_tpu/ops/pallas_resblock.py:110"),
           "reflect_conv9x9": ("speedplusbaseline_tpu_torch/csrc/edgeconv.cu",
                               "none: XLA's convs of speedplusbaseline_tpu/models/ghiasi.py"),
           "reflect_conv3x3": ("speedplusbaseline_tpu_torch/csrc/midconv.cu",
                               "none: XLA's convs of speedplusbaseline_tpu/models/ghiasi.py")}
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
    print("kernel times are per styled KRN step (224^2; B2: its six sites; B1: five calls; "
          "E1: layer0 + layer10, E2: layers 1, 2, 8, 9, both at the KRN cell's batch 192), "
          "bf16, and under \"spn\" per styled SPN step (227^2); launches count the "
          "paths (6 KRN and 4 SPN styled steps, 4 DANN steps, which have no restyle, 3 KRN and "
          "2 SPN styled steps on converted pretrained assets, the StylePredictor's embedding "
          "CLI, which has none, 6 styled KRN steps from the RoI cache, the ddp ranks' styled "
          "KRN and SPN steps and DANN steps, two ranks each, 1 styled KRN step with the "
          "phase-space lowering, the quality drivers' CLI processes, of which the style-aug "
          "arm C restyles 4 steps, the toy-Ghiasi trainer's 600 steps, the SPN stall probe, "
          "which restyles nothing, the perf modules' A/B arms, whose steps all restyle, the "
          "bench's krn and spn children, whose styled steps restyle), "
          "launches_by_path "
          "each; B1's bound_ms counts "
          "its split-bf16 passes, bound_ms_bf16_tensor_core one bf16 pass of its f32 work")
    seconds["total"] = time.time() - t_start
    print(json.dumps({"phase_seconds": seconds}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
