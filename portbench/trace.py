"""The profiler's trace of a stretch of steps, and what the readers of the
per-layer metrics read from it.

``Tracer`` runs ``torch.profiler`` (host and device) over the stretch and
writes its Chrome trace to a temporary file, which ``Trace`` reads and
deletes. Device events are the kernels, copies and sets; each is tied to
the host time of its launch through its correlation id. A kernel whose
launch the trace does not hold (a library launching through its own copy of
the runtime) takes the launch time of the device event before it on its
stream, which the same host code issued.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
STEP_SPAN = "portbench.step"
RESTYLE_SPAN = "portbench.restyle"


class Tracer:
    """``start()`` and ``stop()`` around the stretch; ``stop`` returns the
    parsed ``Trace``."""

    def __init__(self):
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self) -> "Trace":
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)
        finally:
            os.remove(path)
        self.prof = None
        return Trace(raw.get("traceEvents", []))


@dataclass
class DeviceEvent:
    name: str
    ts: float  # microseconds
    dur: float
    stream: object
    launch: Optional[float] = None  # host time of the launch
    tid: object = None


@dataclass
class Span:
    name: str
    ts: float
    dur: float
    tid: object

    @property
    def end(self) -> float:
        return self.ts + self.dur


class Trace:
    def __init__(self, events: Iterable[dict]):
        self.device: List[DeviceEvent] = []
        self.host: List[Span] = []
        runtime: Dict[object, Tuple[float, object]] = {}
        corr: Dict[int, object] = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, args = e.get("cat", ""), e.get("args", {}) or {}
            if cat in DEVICE_CATS:
                ev = DeviceEvent(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)),
                                 args.get("stream", e.get("tid")))
                self.device.append(ev)
                corr[id(ev)] = args.get("correlation")
            elif cat in RUNTIME_CATS and "correlation" in args:
                runtime[args["correlation"]] = (float(e["ts"]), e.get("tid"))
            elif cat in HOST_CATS:
                self.host.append(Span(e.get("name", ""), float(e["ts"]),
                                      float(e.get("dur", 0.0)), e.get("tid")))
        self.device.sort(key=lambda ev: ev.ts)
        last: Dict[object, DeviceEvent] = {}
        for ev in self.device:
            hit = runtime.get(corr[id(ev)])
            if hit is not None:
                ev.launch, ev.tid = hit
            elif ev.stream in last:
                ev.launch, ev.tid = last[ev.stream].launch, last[ev.stream].tid
            if ev.launch is not None:
                last[ev.stream] = ev
        self.host.sort(key=lambda s: s.ts)

    def spans(self, name: str) -> List[Span]:
        return [s for s in self.host if s.name == name]

    def launched_in(self, spans: Sequence[Span],
                    events: Optional[Sequence[DeviceEvent]] = None) -> List[DeviceEvent]:
        """The device events launched inside any of ``spans``."""
        events = self.device if events is None else events
        starts = [s.ts for s in spans]
        out = []
        for ev in events:
            if ev.launch is None:
                continue
            i = bisect.bisect_right(starts, ev.launch) - 1
            if i >= 0 and ev.launch <= spans[i].end:
                out.append(ev)
        return out


def union_us(events: Sequence[DeviceEvent]) -> float:
    """Microseconds in which at least one of ``events`` ran."""
    total, end = 0.0, float("-inf")
    for ev in sorted(events, key=lambda e: e.ts):
        lo, hi = max(ev.ts, end), ev.ts + ev.dur
        if hi > lo:
            total += hi - lo
        end = max(end, hi)
    return total


def gaps(events: Sequence[DeviceEvent]) -> List[Tuple[float, float]]:
    """(start, end) of each stretch with none of ``events`` running, between
    the first and the last."""
    out, end = [], None
    for ev in sorted(events, key=lambda e: e.ts):
        if end is not None and ev.ts > end:
            out.append((end, ev.ts))
        end = ev.ts + ev.dur if end is None else max(end, ev.ts + ev.dur)
    return out


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its argument list."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0].strip() or name
    return head[:width]


def top_ops(events: Sequence[DeviceEvent], n: int = 10) -> List[list]:
    """[[name, seconds], ...] of the ``n`` device operations that took most
    time, summed over their calls."""
    by: Dict[str, float] = defaultdict(float)
    for ev in events:
        by[short_name(ev.name)] += ev.dur * 1e-6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_by_host(trace: Trace, events: Sequence[DeviceEvent], tid, n: int = 10) -> List[list]:
    """[[what the host ran, seconds], ...]: each idle gap between ``events``
    is named by the innermost host span on thread ``tid`` around its middle
    (``host:python`` where none is), summed by name, the ``n`` largest."""
    spans = [s for s in trace.host if s.tid == tid]
    starts = [s.ts for s in spans]
    reach, far = [], float("-inf")  # the latest end of spans[:i + 1]
    for s in spans:
        far = max(far, s.end)
        reach.append(far)
    by: Dict[str, float] = defaultdict(float)
    for lo, hi in gaps(events):
        mid = 0.5 * (lo + hi)
        name = "host:python"
        # Spans nest, so the latest-starting one that still runs is innermost.
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if reach[i] < mid:
                break
            if spans[i].end >= mid:
                name = spans[i].name
                break
        by[name] += (hi - lo) * 1e-6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def ident(name: str) -> str:
    """A kernel's bare function name: ``void (anonymous namespace)::f<T>(...)``
    -> ``f``."""
    name = name.replace("(anonymous namespace)::", "")
    head = name.split("(")[0]
    depth, bare = 0, []
    for ch in head:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            bare.append(ch)
    return "".join(bare).strip().split(" ")[-1].split("::")[-1]


def chain(events: Sequence[DeviceEvent], own: Sequence[str], shared: str,
          after: str) -> List[DeviceEvent]:
    """A hand-written kernel's device events: those named in ``own``, and
    each ``shared`` one that runs right after an ``after`` on its stream."""
    out, prev = [], {}
    for ev in sorted(events, key=lambda e: e.ts):
        name = ident(ev.name)
        if name in own or (name == shared and prev.get(ev.stream) == after):
            out.append(ev)
        prev[ev.stream] = name
    return out
