"""The reduction from a profiler trace to per-layer numbers, on a made-up
Chrome trace: kernels tied to the host span that launched them (by
correlation, or by the kernel before them on their stream where the trace
holds no launch), busy time as a union, idle gaps named by the host, and
B1's and B2's kernels known by name."""
from __future__ import annotations

import pytest

from portbench import trace as tr
from portbench.runners.train_resident import Context
from portbench import spec

B1 = "void (anonymous namespace)::{}<float, true>(float const*)"


def _events():
    ev = []

    def host(name, ts, dur, tid=1):
        ev.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
                   "tid": tid})

    def kernel(name, ts, dur, corr=None, stream=7):
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
                   "args": {"correlation": corr, "stream": stream}})

    def launch(ts, corr, tid=1):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                   "dur": 1, "tid": tid, "args": {"correlation": corr}})

    host(tr.STEP_SPAN, 0, 100)
    host(tr.RESTYLE_SPAN, 5, 40)
    host("Optimizer.step#AdamW.step", 80, 15)
    launch(6, 1)
    kernel(B1.format("split_weights_kernel"), 50, 2, corr=1)
    # Launched through the kernels' own copy of the runtime: no launch event.
    kernel(B1.format("conv3x3_tc_kernel"), 52, 10)
    kernel("void gk::in_finalize_kernel(float2 const*, int)", 62, 1)
    kernel(B1.format("conv3x3_tc_kernel"), 63, 10)
    kernel("void gk::in_finalize_kernel(float2 const*, int)", 73, 1)
    kernel(B1.format("residual_kernel"), 74, 2)
    kernel("void in_stats_kernel<__nv_bfloat16, 8>(x)", 76, 3)
    kernel("void gk::in_finalize_kernel(float2 const*, int)", 79, 1)
    kernel("void in_apply_kernel<__nv_bfloat16, 8>(x)", 80, 3)
    launch(85, 2)
    kernel("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<X>(Y)", 120, 10,
           corr=2)
    host(tr.STEP_SPAN, 200, 50)
    launch(210, 3)
    kernel("void at::native::elementwise_kernel<128, 4>(int)", 230, 10, corr=3)
    launch(300, 4)  # outside every step: not the stretch's
    kernel("void at::native::elementwise_kernel<128, 4>(int)", 300, 10, corr=4)
    return ev


def test_kernels_are_tied_to_the_span_that_launched_them():
    t = tr.Trace(_events())
    steps = t.spans(tr.STEP_SPAN)
    events = t.launched_in(steps)
    assert len(events) == 11
    restyle = t.launched_in(t.spans(tr.RESTYLE_SPAN), events)
    assert [tr.ident(e.name) for e in restyle][:3] == [
        "split_weights_kernel", "conv3x3_tc_kernel", "in_finalize_kernel"]
    assert len(restyle) == 9
    adam = t.launched_in(t.spans("Optimizer.step#AdamW.step"), events)
    assert [e.dur for e in adam] == [10]
    assert tr.union_us(events) == pytest.approx(33 + 10 + 10)
    assert tr.gaps(events) == [(83, 120), (130, 230)]


def test_b1_and_b2_are_known_by_name_and_order():
    t = tr.Trace(_events())
    events = t.launched_in(t.spans(tr.STEP_SPAN))
    b1 = tr.chain(events, ("split_weights_kernel", "conv3x3_tc_kernel", "residual_kernel"),
                  "in_finalize_kernel", "conv3x3_tc_kernel")
    b2 = tr.chain(events, ("in_cluster_kernel", "in_stats_kernel", "in_apply_kernel"),
                  "in_finalize_kernel", "in_stats_kernel")
    assert sum(e.dur for e in b1) == 2 + 10 + 1 + 10 + 1 + 2
    assert sum(e.dur for e in b2) == 3 + 1 + 3


def test_readers_read_the_stretch():
    t = tr.Trace(_events())
    events = t.launched_in(t.spans(tr.STEP_SPAN))
    cell = spec.cell("spn-b48-styled50")
    span = max(e.ts + e.dur for e in events) - min(e.ts for e in events)
    ctx = Context(cell.config, cell.traffic, t, events, [True, False], [3.0, 5.0],
                  {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}, tr.union_us(events), span, 1)
    assert spec.reader("step_busy_ms")(ctx) == pytest.approx(53e-3 / 2)
    assert spec.reader("adamw_ms")(ctx) == pytest.approx(10e-3 / 2)
    assert spec.reader("restyle_ms")(ctx) == pytest.approx(33e-3)
    assert spec.reader("dispatch_ms")(ctx) == 4.0
    assert spec.reader("device_idle_pct")(ctx) == pytest.approx(100 * (1 - 53 / 190))
    # One B1 call and one B2 site is not a restyle's five and six: nothing to read.
    assert spec.reader("b1_roofline")(ctx) is None
    assert spec.reader("b2_roofline")(ctx) is None
    ctx.peak = None
    assert spec.reader("mfu_pct")(ctx) is None


@pytest.mark.parametrize("name,short,ident", [
    ("void at::native::(anonymous namespace)::reflection_pad2d_out_kernel<c10::BFloat16>(a, b)",
     "void at::native::reflection_pad2d_out_kernel<c10::BFloat16>", "reflection_pad2d_out_kernel"),
    (B1.format("conv3x3_tc_kernel"), "void conv3x3_tc_kernel<float, true>", "conv3x3_tc_kernel"),
    ("void gk::in_finalize_kernel(float2 const*, int)", "void gk::in_finalize_kernel",
     "in_finalize_kernel"),
])
def test_kernel_names(name, short, ident):
    assert tr.short_name(name) == short and tr.ident(name) == ident
