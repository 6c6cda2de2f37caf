"""The traced segments: ``torch.profiler`` traces of a few dispatches,
reduced to what the per-layer metrics and the breakdown read.

The reading follows ``novel_vqa_torch/core/device_bench.parse_trace_events``
(the profiler's Chrome trace: complete events of category ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` are the card's operations, with the
card's own durations), frozen here so that the yardstick does not move
with the program.

:func:`capture` traces the card's activity alone: the metrics' segment,
whose own idle share the device metrics report.  Tracing the host's
operators as well slows the host's issue much more (on an H100, arch1's
training step took 21.9 ms untraced, 39-40 with the card's activity
traced, 52 with the host's too), so only :func:`profile_gaps`, which says
what the host was doing in each gap (the breakdown's ``idle_gaps``),
traces both, in a segment of its own.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import re
import tempfile
import time
from collections import defaultdict
from typing import Callable, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN = "vqabench.traced"


@dataclasses.dataclass
class Trace:
    window_s: float  # the segment's length by the host's clock
    ops: List[Tuple[float, float, str]]  # the card's operations: start, end, name

    @property
    def busy_s(self) -> float:
        """The length of the union of the operations' intervals."""
        return sum(e - s for s, e in _union(self.ops)) / 1e6

    def kernel_seconds(self, pattern: str) -> Tuple[float, int]:
        """Device seconds and count of the operations whose name matches."""
        rx = re.compile(pattern)
        hits = [e - s for s, e, name in self.ops if rx.search(name)]
        return sum(hits) / 1e6, len(hits)

    def top_ops(self, k: int = 10) -> List[list]:
        by = defaultdict(float)
        for s, e, name in self.ops:
            by[name[:120]] += (e - s) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def _union(ops, window=None) -> List[Tuple[float, float]]:
    """The union of the operations' intervals, clipped to ``window``."""
    out: List[List[float]] = []
    for s, e, _ in sorted(ops):
        if window is not None:
            s, e = max(s, window[0]), min(e, window[1])
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _outermost(events):
    """The events no other event contains (one thread's nesting)."""
    out, end = [], -1.0
    for s, e, name in sorted(events, key=lambda x: (x[0], -x[1])):
        if s >= end:
            out.append((s, e, name))
            end = e
    return out


def _finder(events, default: str) -> Callable[[float], str]:
    """The name of the (sorted, disjoint) event that holds time t."""
    starts = [s for s, _, _ in events]

    def at(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        return events[i][2] if i >= 0 and t < events[i][1] else default

    return at


def _events(prof) -> List[dict]:
    """The complete events of a finished profile's Chrome trace, written
    to a temporary directory (``TMPDIR``) and removed."""
    with tempfile.TemporaryDirectory(prefix="vqabench_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return [dict(e, cat=str(e.get("cat", "")).lower())
            for e in trace.get("traceEvents", []) if e.get("ph") == "X"]


def _interval(e: dict) -> Tuple[float, float, str]:
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"]


def capture(body: Callable[[], None]) -> Trace:
    """Run ``body`` with the card's activity traced, then wait for the
    card; the segment's length is the host's clock from the start of
    ``body`` to the card's end.  Without a CUDA card nothing is traced."""
    cuda = torch.cuda.is_available()
    if not cuda:
        t0 = time.perf_counter()
        body()
        return Trace(time.perf_counter() - t0, [])
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        body()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    ops = [_interval(e) for e in _events(prof) if e["cat"] in DEVICE_CATS]
    return Trace(window_s, ops)


def tracer():
    """The program's ``collect`` (``novel_vqa_torch.core.profiling``), or
    None where the port has no tracer."""
    try:
        from novel_vqa_torch.core.profiling import collect
    except ImportError:
        return None
    return collect


def span_seconds(m, name: str):
    """The inclusive host seconds of the program span ``name`` in a run's
    span segment (a reader's ``m.spans``); None where the run has no span
    segment or the span never opened."""
    if m.spans is None or name not in m.spans:
        return None
    return m.spans[name]["total_s"]


def _innermost(ranges, default: str) -> Callable[[float], str]:
    """The name of the innermost of one thread's nested ranges that holds t."""
    ranges = sorted(ranges)

    def at(t: float) -> str:
        best = default
        for s, e, name in ranges:
            if s > t:
                break
            if t < e:
                best = name
        return best

    return at


def profile_gaps(body: Callable[[], None], k: int = 10) -> dict:
    """Run ``body`` with the host's operators and the card's activity
    traced, and return :func:`label_gaps` of the trace.  Inside the
    program's ``collect()`` its spans lie in the trace as ``nvqa.*``
    ranges, and the labels carry them."""
    from torch.profiler import ProfilerActivity, record_function, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        with record_function(SPAN):
            body()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    return label_gaps(_events(prof), k)


def label_gaps(events: List[dict], k: int = 10) -> dict:
    """The card's idle gaps in a profile's complete events, in seconds by
    what the host was doing when each began: ``<harness span>/<innermost
    nvqa.* span>/<host operator>`` (``<harness span>/<host operator>``
    outside every program span; the harness span is :func:`span`'s,
    "harness" outside them, the host operator "python" between
    operators), summed per label: ``{"gaps": the k longest labels,
    "program_share": the share of all idle seconds whose label holds a
    program span, "listed_share": that share of the k listed}``."""
    seg = [e for e in events if e["cat"] == "user_annotation" and e["name"] == SPAN]
    if not seg:
        return {"gaps": [], "program_share": None, "listed_share": None}
    window = _interval(seg[0])[:2]
    tid = seg[0].get("tid")
    ops = [_interval(e) for e in events if e["cat"] in DEVICE_CATS]
    mine = [e for e in events if e.get("tid") == tid]
    host = _outermost([_interval(e) for e in mine if e["cat"] == "cpu_op"])
    notes = [_interval(e) for e in mine if e["cat"] == "user_annotation"]
    harness = _outermost([iv for iv in notes if iv[2].startswith("vqabench.") and iv[2] != SPAN])
    program = _innermost([iv for iv in notes if iv[2].startswith("nvqa.")], "")
    gaps, t = [], window[0]
    for s, e in _union(ops, window):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if window[1] > t:
        gaps.append((t, window[1]))
    span_at, op_at = _finder(harness, "harness"), _finder(host, "python")
    by = defaultdict(float)
    for g0, g1 in gaps:
        inner = program(g0)
        label = f"{span_at(g0)}/{inner}/{op_at(g0)}" if inner else f"{span_at(g0)}/{op_at(g0)}"
        by[label] += (g1 - g0) / 1e6
    ranked = sorted(by.items(), key=lambda kv: -kv[1])
    listed = ranked[:k]

    def share(items):
        total = sum(v for _, v in items)
        return sum(v for n, v in items if "/nvqa." in n) / total if total else None

    return {"gaps": [[n, v] for n, v in listed], "program_share": share(ranked),
            "listed_share": share(listed)}


def span(name: str):
    """A harness span, ``vqabench.<name>``, around a call in the segment of
    :func:`profile_gaps`, whose gaps are labelled by it."""
    from torch.profiler import record_function

    return record_function(f"vqabench.{name}")
