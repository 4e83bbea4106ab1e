#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``speedplusbaseline_tpu_torch``)
on one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device  -- the card's name and power limit (nvidia-smi);
  2. build   -- nvcc builds the hand-written kernels from csrc/, and
                cuobjdump counts the tensor-core (HGMMA) instructions of B1;
  3. kernels -- each kernel against its plain PyTorch version on the same
                inputs (TF32 off), f32 and bf16, at the main path's shapes,
                with times (CUDA events), bounds and library-call times; B2
                on both of its paths, with the path, cut and time of each
                site and the card's cluster occupancy; then
                the whole Ghiasi generator on the card, in f32 and in bf16,
                against the plain f32 version on the CPU;
  4. main    -- the styled KRN trainer (``train.main``) at 224^2, batch 48,
                AdamW, bf16, on a generated dataset of 1920x1200 JPEGs, with
                the launch counters set to 0 just before and read just after;
                then the styled and plain train steps timed on a resident
                batch.
Then one JSON line with every kernel's numbers, the card line, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
result lines. Imports nothing of JAX.
"""
from __future__ import annotations

import json
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
# B1's tensor-core passes per call from bf16 x: conv 1 x*w_hi + x*w_lo, conv 2
# a_hi*w_hi + a_hi*w_lo + a_lo*w_hi (split-bf16 operands, csrc/resblock.cu).
B1_PASSES = 5
# Clock cycles of the sleep kernel that holds the device while time_ms
# enqueues its calls (about 6 ms at the H100's 1.755 GHz boost clock).
HOLD_CYCLES = 10_000_000
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 2.0 ** -6)}  # (atol, rtol)
TOL_B1_F32 = (5e-4, 1e-4)  # K = 1152-term sums of split-bf16 products, in another order
# The bf16 generator against the f32 one: bf16 activations through ten layers
# and a sigmoid in [0, 1]. 2^-6 is four bf16 ulps at the top of [0.5, 1), about
# twice what phase "kernels" reads on an H100.
TOL_GHIASI_BF16 = (2.0 ** -6, 0.0)


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
    (without it: the method of the port's earlier PERF.md figures)."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
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


def phase_kernels(dev):
    import torch
    import torch.nn.functional as F

    from speedplusbaseline_tpu_torch.ops import instancenorm as inf
    from speedplusbaseline_tpu_torch.ops import resblock as rb

    g = torch.Generator(device=dev).manual_seed(0)
    dtypes = (torch.float32, torch.bfloat16)
    report = {}

    # B2: every site shape, an odd one, and shapes of the two-pass path (no
    # 16-byte split; a plane just past what 16 cluster blocks hold); input
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
    tot = {"ms": 0.0, "paced_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    sites, configs = [], set()
    for layer, shape, film, relu in B2_SITES:
        p = inf.plan_on_card(shape, torch.bfloat16, dev)
        x = torch.rand(shape, device=dev, generator=g).to(torch.bfloat16)
        gam = torch.randn(shape[0], shape[3], device=dev, generator=g) if film else None
        bet = torch.randn(shape[0], shape[3], device=dev, generator=g) if film else None
        x_nchw = x.permute(0, 3, 1, 2)
        calls = dict(inf.path_calls)
        ms = time_ms(lambda: inf.instance_norm_film(x, gam, bet, relu=relu))
        ran = {k: v - calls[k] for k, v in inf.path_calls.items() if v != calls[k]}
        if list(ran) != [p.path]:
            fail(f"B2 {layer}: planned the {p.path} path, ran {ran}")
        paced = time_ms(lambda: inf.instance_norm_film(x, gam, bet, relu=relu), hold=False)
        pms = time_ms(lambda: inf.instance_norm_film_plain(x, gam, bet, relu=relu))
        lms = time_ms(lambda: F.instance_norm(x_nchw, eps=1e-5))
        bound = max(inf.bytes_moved(shape, torch.bfloat16, film) / HBM_BYTES_PER_S,
                    inf.flops(shape) / F32_FLOPS) * 1e3
        cut = (f"K={p.k}, {p.block_bytes} B/block, {p.threads} threads" if p.path == "cluster"
               else f"{p.nchunks} chunks of {p.rows_per_chunk} rows")
        print(f"  B2 {layer} {shape} bf16 film={film} relu={relu}: {p.path} ({cut}): kernel "
              f"{ms:.4f} ms, bound {bound:.4f} ms (bytes), {ms / bound:.2f}x bound; "
              f"enqueue-paced {paced:.4f} ms; plain {pms:.4f} ms, F.instance_norm "
              f"{lms:.4f} ms", flush=True)
        sites.append({"layer": layer, "shape": list(shape), "path": p.path, "k": p.k,
                      "block_bytes": p.block_bytes, "ms": ms, "bound_ms": bound,
                      "x_bound": ms / bound, "paced_ms": paced})
        if p.path == "cluster":
            configs.add((p.k, p.threads, p.smem_bytes))
        for k, v in (("ms", ms), ("paced_ms", paced), ("plain_ms", pms), ("library_ms", lms),
                     ("bound_ms", bound)):
            tot[k] += v
    for k, threads, smem in sorted(configs):
        n = inf.max_active_clusters(dev.index or 0, torch.bfloat16, k, threads, smem)
        print(f"  B2 cudaOccupancyMaxActiveClusters: {n} clusters of {k} blocks x {threads} "
              f"threads x {smem} B shared memory (bf16)", flush=True)
    print(f"  B2 per styled step: kernel {tot['ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
          f"({tot['bound_ms'] / tot['ms']:.0%} of bound); enqueue-paced {tot['paced_ms']:.4f} "
          "ms", flush=True)
    report["instance_norm_film"] = {"max_abs_err": err_b2, "bound_by": "bytes",
                                    "bound_basis": "one read of x and one write of y at "
                                                   "the HBM rate",
                                    "bound_ms_bf16_tensor_core": None, "sites": sites, **tot}

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

    for shape in (B1_SHAPE, (2, 57, 57, 128), (2, 8, 8, 128), (2, 9, 9, 128), (1, 13, 6, 40)):
        args = block_args(shape)
        for dt in dtypes:
            x = torch.randn(shape, device=dev, generator=g).to(dt)
            tol = TOL_B1_F32 if dt == torch.float32 else TOL["bfloat16"]
            err_b1 = max(err_b1, compare(f"B1 {shape} {str(dt)[6:]}",
                                         rb.ghiasi_resblock(x, *args),
                                         rb.ghiasi_resblock_plain(x, *args), tol))
    args = block_args(B1_SHAPE)
    x = torch.randn(B1_SHAPE, device=dev, generator=g).to(torch.bfloat16)
    ms = time_ms(lambda: rb.ghiasi_resblock(x, *args), 10)
    pms = time_ms(lambda: rb.ghiasi_resblock_plain(x, *args), 10)
    by_split = rb.flops(B1_SHAPE, B1_PASSES) / BF16_TENSOR_FLOPS * 1e3
    by_bytes = rb.bytes_moved(B1_SHAPE, torch.bfloat16) / HBM_BYTES_PER_S * 1e3
    by_tc = max(rb.flops(B1_SHAPE) / BF16_TENSOR_FLOPS * 1e3, by_bytes)
    by_f32 = rb.flops(B1_SHAPE) / F32_FLOPS * 1e3
    print(f"  B1 {B1_SHAPE} bf16: kernel {ms:.4f} ms/call, plain {pms:.4f} ms/call, "
          f"bound {max(by_split, by_bytes):.4f} ms (operations: {B1_PASSES} split-bf16 "
          f"passes on the tensor cores; bytes {by_bytes:.4f} ms; one bf16 pass "
          f"{by_tc:.4f} ms; f32 on the CUDA cores {by_f32:.4f} ms)", flush=True)
    n = B1_CALLS_PER_STEP
    report["ghiasi_resblock"] = {"max_abs_err": err_b1, "bound_by": "operations",
                                 "bound_basis": f"{B1_PASSES} split-bf16 passes at the "
                                                "bf16 tensor-core peak",
                                 "ms": n * ms, "plain_ms": n * pms,
                                 "bound_ms": n * max(by_split, by_bytes),
                                 "bound_ms_bf16_tensor_core": n * by_tc, "library_ms": None}
    return report


def phase_ghiasi(dev):
    """The whole generator with the asset weights: kernels on the card, in f32
    and in bf16 (the main path's dtype), vs the plain f32 version on the
    CPU."""
    import torch

    from speedplusbaseline_tpu_torch.augment.styleaug import load_ghiasi_params
    from speedplusbaseline_tpu_torch.io_utils import default_assets_dir
    from speedplusbaseline_tpu_torch.models.ghiasi import Ghiasi

    sd = load_ghiasi_params(os.path.join(default_assets_dir(), "ghiasi_params.msgpack"))
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
        name = f"Ghiasi (2, 3, 224, 224) {str(dtype)[6:]}, card kernels vs CPU plain f32"
        compare(name, got, ref, tol)
        mean_err = (got - ref).abs().mean().item()
        print(f"  {name}: mean_abs_err {mean_err:.3e}", flush=True)


def write_dataset(root: str, n_rows: int, n_images: int = 48, seed: int = 0) -> None:
    """KRN CSV + 1920x1200 JPEGs in the layout data/csv_dataset.py reads."""
    import cv2
    import numpy as np

    rs = np.random.RandomState(seed)
    base = os.path.join(root, "speedplus", "synthetic")
    os.makedirs(os.path.join(base, "images"), exist_ok=True)
    os.makedirs(os.path.join(base, "splits_krn"), exist_ok=True)
    names = []
    for i in range(n_images):
        small = rs.randint(0, 256, (30, 48, 3), dtype=np.uint8)
        img = cv2.resize(small, (1920, 1200), interpolation=cv2.INTER_CUBIC)
        name = f"img{i:06d}.jpg"
        cv2.imwrite(os.path.join(base, "images", name), img,
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
        names.append(name)
    with open(os.path.join(base, "splits_krn", "train.csv"), "w") as f:
        for r in range(n_rows):
            cx, cy = rs.uniform(500, 1420), rs.uniform(400, 800)
            half = rs.uniform(100, 300)
            kx = rs.uniform(cx - half, cx + half, 11)
            ky = rs.uniform(cy - half, cy + half, 11)
            q = rs.randn(4)
            q /= np.linalg.norm(q)
            t = [rs.uniform(-0.3, 0.3), rs.uniform(-0.2, 0.2), rs.uniform(3, 6)]
            row = ([f"synthetic/images/{names[r % n_images]}", kx.min(), kx.max(),
                    ky.min(), ky.max()] + q.tolist() + t
                   + np.stack([kx, ky], 1).reshape(-1).tolist())
            f.write(", ".join(str(v) for v in row) + "\n")


def phase_main(dev, steps: int = 6):
    import numpy as np
    import torch

    from speedplusbaseline_tpu_torch import train
    from speedplusbaseline_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        write_dataset(tmp, steps * B)
        print(f"phase main: dataset of {steps * B} rows written in "
              f"{time.time() - t0:.1f} s", flush=True)
        argv = ["--dataroot", tmp, "--savedir", os.path.join(tmp, "save"),
                "--logdir", os.path.join(tmp, "log"), "--model_name", "krn",
                "--input_shape", str(S), str(S), "--batch_size", str(B),
                "--optimizer", "adamw", "--lr", "0.001", "--weight_decay", "0.01",
                "--randomize_texture", "--use_fp16", "--texture_ratio", "1.0",
                "--max_epochs", "1", "--start_over", "--num_workers", "8"]
        _build.reset_launches()
        t0 = time.time()
        records = train.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(_build.launches)
        print("", flush=True)
        if len(records) != steps:
            fail(f"main path ran {len(records)} steps, expected {steps}")
        losses = [r["loss_x"] + r["loss_y"] for r in records]
        if not all(np.isfinite(losses)):
            fail(f"non-finite loss in {losses}")
        if not all(r["styled"] for r in records):
            fail("texture_ratio 1.0 left a step unstyled")
        if not os.path.exists(os.path.join(tmp, "save", "checkpoint.pt")):
            fail("no checkpoint written")
        if launches["ghiasi_resblock"] < 5 * steps or launches["instance_norm_film"] < 6 * steps:
            fail(f"kernel launches {launches} too few for {steps} styled steps")
        ms = [r["ms"] for r in records[1:]]
        step_ms = statistics.median(ms)
        print(f"phase main: {steps} styled steps, losses {[round(v, 4) for v in losses]}, "
              f"launches {launches}, wall {wall:.1f} s incl. set-up", flush=True)
        print(f"phase main: step ms after the first {[round(v, 2) for v in ms]}; median "
              f"{step_ms:.2f} ms = {B * 1000 / step_ms:.1f} img/s (from disk, "
              f"8 loader threads)", flush=True)
    return launches


def phase_resident(dev):
    """Styled and plain train steps on one device-resident batch, in turns."""
    from speedplusbaseline_tpu_torch import profile_step

    state, step, batch = profile_step.build(dev)
    out = {}
    for styled in (True, False, False, True):
        out.setdefault(styled, []).append(profile_step.time_step(state, step, batch, styled))
    for styled, v in out.items():
        print(f"phase resident: {'styled' if styled else 'plain'} step "
              f"{[round(x, 2) for x in v]} ms = {B * 1000 / min(v):.1f} img/s "
              "(batch 48, 224^2, bf16, AdamW)", flush=True)


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
    phase_ghiasi(dev)
    launches = phase_main(dev)
    phase_resident(dev)
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
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "bound_basis": r["bound_basis"],
                        "bound_ms_bf16_tensor_core": r["bound_ms_bf16_tensor_core"],
                        **({"sites": r["sites"]} if "sites" in r else {})})
    print("kernel times are per styled step (B2: its six sites; B1: five calls), bf16; "
          "B1's bound_ms counts its split-bf16 passes, bound_ms_bf16_tensor_core one "
          "bf16 pass of its f32 work")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
