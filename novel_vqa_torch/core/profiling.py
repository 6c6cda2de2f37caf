"""The port's tracer, and the trainers' ``--profile_dir`` and
``--debug_nans`` (port of ``novel_vqa_tpu.core.profiling``'s ``trace``
and ``nan_guard``): ``torch.profiler`` in place of ``jax.profiler``,
``torch.autograd.detect_anomaly`` in place of ``jax_debug_nans``.

The tracer: :func:`span` marks a layer boundary of the program (the
training step's phases, the eval loops' uploads and decodes, the LSTM
encode, the vision stages).  Tracing is off by default, and then a span
costs one check of a module-level variable and records nothing.
:func:`collect` turns it on for a block: each span of the calling thread
is recorded in memory (its name, its parent span, its start and end on
``time.perf_counter_ns``) in the :class:`Record` the block yields, and
where a ``torch.profiler`` is active it also opens
``record_function("nvqa." + name)``, so the span lies in the profiler's
timeline on the clock of the card's operations.  There is no exporter:
``--profile_dir``'s trace carries the mirrored ranges.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

PREFIX = "nvqa."


class Stat(NamedTuple):
    """One span name's sums in a :class:`Record` (nanoseconds)."""

    count: int
    total_ns: int  # inclusive: the spans' durations
    self_ns: int  # the durations less the parts their child spans cover


@dataclasses.dataclass
class Record:
    """The spans one :func:`collect` block recorded, in opening order:
    ``[name, parent index (-1 at the top), start_ns, end_ns]``."""

    thread: int
    spans: List[list] = dataclasses.field(default_factory=list)
    _open: List[int] = dataclasses.field(default_factory=list, repr=False)

    def stats(self) -> Dict[str, Stat]:
        """Each name's count, total and self time."""
        child_ns = [0] * len(self.spans)
        for _, parent, s, e in self.spans:
            if parent >= 0:
                child_ns[parent] += e - s
        out: Dict[str, list] = {}
        for (name, _, s, e), inner in zip(self.spans, child_ns):
            acc = out.setdefault(name, [0, 0, 0])
            acc[0] += 1
            acc[1] += e - s
            acc[2] += e - s - inner
        return {name: Stat(*acc) for name, acc in out.items()}


_active: Optional[Record] = None  # the open record; None: tracing is off


class _Span:
    __slots__ = ("name", "rec", "index", "mirror")

    def __init__(self, name: str, rec: Record):
        self.name, self.rec = name, rec

    def __enter__(self):
        rec = self.rec
        if threading.get_ident() != rec.thread:
            self.index = None
            return self
        self.mirror = None
        if torch.autograd._profiler_enabled():
            from torch.profiler import record_function

            self.mirror = record_function(PREFIX + self.name)
            self.mirror.__enter__()
        self.index = len(rec.spans)
        rec.spans.append([self.name, rec._open[-1] if rec._open else -1,
                          time.perf_counter_ns(), 0])
        rec._open.append(self.index)
        return self

    def __exit__(self, *exc):
        if self.index is None:
            return False
        self.rec.spans[self.index][3] = time.perf_counter_ns()
        self.rec._open.pop()
        if self.mirror is not None:
            self.mirror.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager around one layer boundary's work, recorded while
    a :func:`collect` block of this thread is open (see the module
    docstring); otherwise nothing."""
    if _active is None:
        return _OFF
    return _Span(name, _active)


@contextlib.contextmanager
def collect():
    """Turn tracing on for the block and yield its :class:`Record`.  Inside
    a block that already traces, the open record is yielded and tracing
    stays on after the inner block."""
    global _active
    if _active is not None:
        yield _active
        return
    rec = Record(thread=threading.get_ident())
    _active = rec
    try:
        yield rec
    finally:
        _active = None


@contextlib.contextmanager
def trace(out_dir: str, device: torch.device):
    """A ``torch.profiler`` trace of the enclosed block, with the tracer on
    (its spans as ``nvqa.*`` ranges), written to ``<out_dir>/trace.json``;
    nothing when ``out_dir`` is empty."""
    if not out_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof, collect():
        yield
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


@contextlib.contextmanager
def nan_guard(on: bool):
    """Autograd's anomaly detection around the block when ``on``: a NaN in
    a backward raises, naming the forward op that made it."""
    with torch.autograd.detect_anomaly() if on else contextlib.nullcontext():
        yield
