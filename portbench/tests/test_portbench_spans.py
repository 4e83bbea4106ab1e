"""The readers of the program's spans (``speedplus.*``), on a made-up Chrome
trace of two steps: device ms launched inside the forward, backward and clip
spans (a backward kernel launched from autograd's own thread inside the
loop thread's span; a kernel with no launch event tied to the one before it
on its stream; a kernel beside another on a side stream counted once), host ms in the readback and loader spans (the one open at
the profiler's stop left out, and spans on another thread), and the device's
idle inside the loop thread's step spans."""
from __future__ import annotations

import pytest

from portbench import spec
from portbench import trace as tr
from portbench.runners.train_resident import Context

LOOP, AUTOGRAD, OTHER = 1, 2, 9
NEW = ("forward_ms", "backward_ms", "clip_ms", "readback_wait_ms", "loader_wait_ms",
       "idle_in_step_ms")


def _events():
    ev = []

    def host(name, ts, dur, tid=LOOP):
        ev.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
                   "tid": tid})

    def kernel(ts, dur, corr=None, stream=7):
        ev.append({"ph": "X", "cat": "kernel", "name": "void k<float>(float*)", "ts": ts,
                   "dur": dur, "args": {"correlation": corr, "stream": stream}})

    def launch(ts, corr, tid=LOOP):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                   "dur": 1, "tid": tid, "args": {"correlation": corr}})

    # Step 1: forward, backward, clip, optimizer.
    host("speedplus.step", 0, 100)
    host(tr.STEP_SPAN, 1, 98)
    host("speedplus.forward", 10, 20)
    launch(12, 1)
    kernel(20, 10, corr=1)
    host("speedplus.backward", 30, 30)
    launch(35, 2, tid=AUTOGRAD)
    kernel(40, 12, corr=2)
    kernel(52, 3)  # a library's own launch: tied to the kernel before it
    launch(36, 7, tid=AUTOGRAD)
    kernel(42, 8, corr=7, stream=30)  # beside the one on stream 7: counted once
    host("speedplus.clip", 60, 5)
    launch(61, 3)
    kernel(62, 2, corr=3)
    host("speedplus.optimizer", 65, 25)
    host("Optimizer.step#AdamW.step", 66, 23)
    launch(70, 4)
    kernel(80, 10, corr=4)
    # The readback of the step before and the next batch's fetch.
    host("speedplus.readback", 100, 10)
    host("speedplus.loader_wait", 110, 8)
    host("speedplus.loader_wait", 111, 2, tid=OTHER)  # not the loop's thread
    host("speedplus.step", 90, 45, tid=OTHER)  # nor this
    # Step 2: no clip.
    host("speedplus.step", 120, 50)
    host(tr.STEP_SPAN, 121, 48)
    host("speedplus.forward", 125, 10)
    launch(126, 5)
    kernel(130, 6, corr=5)
    host("speedplus.backward", 135, 30)
    launch(140, 6, tid=AUTOGRAD)
    kernel(150, 10, corr=6)
    # After the last step: a readback, and the fetch the profiler stopped in.
    host("speedplus.readback", 170, 10)
    host("speedplus.loader_wait", 180, 20)
    return ev


def _context(events):
    t = tr.Trace(events)
    steps = t.launched_in(t.spans(tr.STEP_SPAN))
    cell = spec.cell("spn-b48-styled50")
    span = (max(e.ts + e.dur for e in steps) - min(e.ts for e in steps)) if steps else 0.0
    return Context(cell.config, cell.traffic, t, steps, [False, False], [3.0],
                   {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}, tr.union_us(steps), span,
                   LOOP)


@pytest.mark.parametrize("name,value", [
    ("forward_ms", (10 + 6) * 1e-3 / 2),
    ("backward_ms", (12 + 3 + 10) * 1e-3 / 2),
    ("clip_ms", 2 * 1e-3 / 2),
    ("readback_wait_ms", 10 * 1e-3),
    ("loader_wait_ms", 8 * 1e-3),
    # Gaps (30, 40), (55, 62), (64, 80) in step 1 and (136, 150) in step 2;
    # (90, 130) has its middle between the loop's steps.
    ("idle_in_step_ms", (10 + 7 + 16 + 14) * 1e-3 / 2),
])
def test_each_reader_reads_its_span(name, value):
    assert spec.reader(name)(_context(_events())) == pytest.approx(value)


def test_the_harness_readers_read_as_before():
    ctx = _context(_events())
    assert spec.reader("adamw_ms")(ctx) == pytest.approx(10e-3 / 2)
    assert spec.reader("step_busy_ms")(ctx) == pytest.approx(53e-3 / 2)


@pytest.mark.parametrize("name", NEW)
def test_each_reader_reads_nothing_without_the_programs_spans(name):
    events = [e for e in _events() if not e["name"].startswith("speedplus.")]
    assert spec.reader(name)(_context(events)) is None


@pytest.mark.parametrize("name", NEW)
def test_each_reader_reads_nothing_where_no_device_ran(name):
    events = [e for e in _events() if e["cat"] not in tr.DEVICE_CATS]
    assert spec.reader(name)(_context(events)) is None


@pytest.mark.parametrize("name", NEW)
def test_each_new_metric_is_declared_for_the_cell(name):
    entry = next(m for m in spec.benchmark()["per_layer"] if m["name"] == name)
    assert entry["source"] == "program_span" and entry["workloads"] == ["spn-b48-styled50"]
