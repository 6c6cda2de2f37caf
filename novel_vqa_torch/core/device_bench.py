"""Device-time measurement on the card (port of
``novel_vqa_tpu.core.device_bench``).

A host clock around PyTorch calls measures the host's launches unless
it waits for the card, and even then it mixes host and device time.  The
``torch.profiler`` trace records the card's own spans: every CUDA kernel
appears as a complete event (``"cat": "kernel"``) with its device, stream
and duration as the card measured them.  Those spans are the timing source
here, as the ``XLA Modules`` spans of the device plane are in the JAX
package.

This module provides:

  * :func:`measure_device_time`: run any callable N times under the
    profiler (synchronising inside the window) and return the kernels'
    device time by name;
  * :func:`parse_trace_events` / :func:`parse_trace_dir` /
    :func:`parse_trace_ops`: the Chrome-trace parser behind it (kernel
    events only; a CPU run has none, hence no device plane);
  * :func:`graph_device_ms`: the device time per call of a capturable
    ``fn`` (static inputs), from a CUDA graph of ``calls`` calls replayed
    between CUDA events: no host launch cost inside;
  * :func:`profile` and :func:`stage_profile`: device time by kernel name
    and by tracer span (``core/profiling.span``) over one call;
  * :func:`peak_flops`: the card's peak FLOP/s by name (bf16 dense, and
    fp32 beside it); :func:`bound`, the least time for given FLOPs and
    bytes.
"""

from __future__ import annotations

import dataclasses
import glob
import gzip
import json
import os
import statistics
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from novel_vqa_torch.core.profiling import collect

__all__ = [
    "ModuleStat",
    "TraceSummary",
    "DeviceTiming",
    "parse_trace_events",
    "parse_trace_ops",
    "parse_trace_dir",
    "measure_device_time",
    "graph_device_ms",
    "profile",
    "stage_profile",
    "peak_flops",
    "bound",
    "FP32_FLOPS",
    "BF16_FLOPS",
    "HBM_BYTES_PER_S",
]

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W): fp32
# outside the tensor cores, bf16 on the tensor cores, and HBM3 bandwidth
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

# (bf16 dense, fp32) FLOP/s by the CUDA device name's prefix
_PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": (BF16_FLOPS, FP32_FLOPS),
}

# device-side event categories of a torch.profiler chrome trace
_KERNEL_CAT = "kernel"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class ModuleStat:
    name: str
    count: int = 0
    total_us: float = 0.0

    @property
    def total_s(self) -> float:
        return self.total_us / 1e6


@dataclasses.dataclass
class TraceSummary:
    """Device-side kernel executions extracted from one profiler trace."""

    modules: Dict[str, ModuleStat]  # by kernel name
    device_plane: Optional[str]  # e.g. "cuda:0"; None without kernel events

    @property
    def has_device_plane(self) -> bool:
        return self.device_plane is not None

    def module(self, prefix: str) -> Optional[ModuleStat]:
        """Aggregate stat over kernels whose name starts with ``prefix``."""
        agg = ModuleStat(name=prefix)
        for name, st in self.modules.items():
            if name.startswith(prefix):
                agg.count += st.count
                agg.total_us += st.total_us
        return agg if agg.count else None

    def total(self) -> ModuleStat:
        agg = ModuleStat(name="<all kernels>")
        for st in self.modules.values():
            agg.count += st.count
            agg.total_us += st.total_us
        return agg


def _device_and_stream(e: dict) -> Tuple[object, object]:
    args = e.get("args", {})
    return args.get("device", e.get("pid")), args.get("stream", e.get("tid"))


def parse_trace_events(trace: dict) -> TraceSummary:
    """Parse a loaded Chrome trace (``{"traceEvents": [...]}``) as
    ``torch.profiler`` exports it: the complete events of category
    ``kernel`` are the card's kernel executions, each with its device and
    stream in ``args``.  A CPU run has none: ``has_device_plane`` is False,
    and callers fall back to the host clock."""
    modules: Dict[str, ModuleStat] = {}
    plane = None
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or e.get("cat") != _KERNEL_CAT:
            continue
        st = modules.setdefault(e["name"], ModuleStat(name=e["name"]))
        st.count += 1
        st.total_us += float(e.get("dur", 0.0))
        if plane is None:
            plane = f"cuda:{_device_and_stream(e)[0]}"
    return TraceSummary(modules=modules, device_plane=plane)


def _newest_trace(trace_dir: str) -> Optional[str]:
    files: List[str] = []
    for pat in ("*.json", "*.json.gz"):
        files += glob.glob(os.path.join(trace_dir, "**", pat), recursive=True)
    return max(files, key=os.path.getmtime) if files else None


def _load(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def parse_trace_dir(trace_dir: str) -> TraceSummary:
    """Parse the newest ``*.json`` (or ``.json.gz``) trace under ``trace_dir``."""
    path = _newest_trace(trace_dir)
    if path is None:
        return TraceSummary(modules={}, device_plane=None)
    return parse_trace_events(_load(path))


def parse_trace_ops(trace_dir: str, host: bool = False) -> Dict[str, Dict[str, ModuleStat]]:
    """Device spans of the newest trace under ``trace_dir``, grouped by
    stream: ``{"cuda:<d> stream <n>": {kernel or copy name: ModuleStat}}``
    over the kernels, copies and memsets.  ``host=True`` reads the host's
    operator spans instead, by thread (``{"host thread <t>": ...}``): the
    only ones a CPU run has."""
    path = _newest_trace(trace_dir)
    if path is None:
        return {}
    cats = ("cpu_op",) if host else _DEVICE_CATS
    out: Dict[str, Dict[str, ModuleStat]] = {}
    for e in _load(path).get("traceEvents", []):
        if e.get("ph") != "X" or e.get("cat") not in cats:
            continue
        if host:
            group = f"host thread {e.get('tid')}"
        else:
            device, stream = _device_and_stream(e)
            group = f"cuda:{device} stream {stream}"
        st = out.setdefault(group, {}).setdefault(e["name"], ModuleStat(name=e["name"]))
        st.count += 1
        st.total_us += float(e.get("dur", 0.0))
    return out


@dataclasses.dataclass
class DeviceTiming:
    """Result of :func:`measure_device_time`."""

    wall_s: float
    summary: TraceSummary
    n_calls: int  # how many times fn was invoked

    def module_seconds(self, prefix: str) -> Tuple[Optional[float], int]:
        st = self.summary.module(prefix)
        if st is None:
            return None, 0
        return st.total_s, st.count


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def measure_device_time(
    fn: Callable[[], object],
    n_calls: int,
    trace_dir: Optional[str] = None,
) -> DeviceTiming:
    """Invoke ``fn`` ``n_calls`` times under ``torch.profiler`` and parse the
    kernels' device durations from the exported trace
    (``<trace_dir>/trace.json``).  ``torch.cuda.synchronize()`` runs inside
    the window, so every launch of the calls is in the trace.  Any ``fn``
    works (nothing is captured)."""
    from torch.profiler import profile as torch_profile

    trace_dir = trace_dir or tempfile.mkdtemp(prefix="nvqa_devbench_")
    os.makedirs(trace_dir, exist_ok=True)
    t0 = time.perf_counter()
    with torch_profile(activities=_activities()) as prof:
        for _ in range(n_calls):
            fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    return DeviceTiming(wall_s=wall, summary=parse_trace_dir(trace_dir), n_calls=n_calls)


def graph_device_ms(fn, calls: int = 20, reps: int = 20, warmup: int = 3) -> float:
    """Device time per call without the host's launch cost: ``calls`` calls of
    ``fn`` captured in one CUDA graph after warm-up on a side stream (so no
    one-time host set-up runs inside the capture), the graph replayed
    ``reps`` times between CUDA events; the median per call.  ``fn`` must
    be capturable: static inputs, no host sync."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _device_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]


def profile(fn, top: int = 8) -> dict:
    """Device time by kernel name over one call of ``fn`` (after one
    warm-up call), and the device operations it ran (kernels, copies,
    memsets), from torch.profiler; the device-side copies of
    ``record_function`` ranges are left out, which would count their
    kernels twice."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    total = sum(e.device_time_total for e in events)
    events.sort(key=lambda e: -e.device_time_total)
    return {"device_ms_total": total / 1e3, "device_ops": sum(e.count for e in events),
            "top": [{"name": e.key[:80], "ms": e.device_time_total / 1e3, "count": e.count}
                    for e in events[:top]]}


def stage_profile(fn, top: int = 6,
                  stages=("nvqa.extract.", "nvqa.vgg.", "nvqa.inception.")) -> dict:
    """Device ms by stage over one call of ``fn``, from torch.profiler with
    the tracer on: each span range whose name starts with one of ``stages``
    (the extraction forwards': nvqa.extract.prepro, nvqa.vgg.block1..5,
    nvqa.vgg.fc6, nvqa.vgg.fc7; nvqa.inception.stem, .mixed5, .mixed6,
    .mixed7, .pool) sums the device time of the kernels launched inside
    it; beside it the total kernel time and the kernels that take most of
    it."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            collect():
        fn()
        torch.cuda.synchronize()
    by_stage = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
                if e.key.startswith(tuple(stages))
                and e.device_type == torch.autograd.DeviceType.CPU}
    by_name: Dict[str, Tuple[float, int]] = {}
    for e in _device_events(prof):
        ms, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    total = sum(ms for ms, _ in by_name.values())
    return {"device_ms_total": total, "stages_ms": by_stage,
            "stages_share": {k: v / total for k, v in by_stage.items()} if total else {},
            "top": [{"name": n[:80], "ms": ms, "count": c}
                    for n, (ms, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]]}


def peak_flops(device=None, dtype: str = "bfloat16") -> Optional[float]:
    """Peak dense FLOP/s of a CUDA card (a device index, ``torch.device`` or
    its name; default the first card) for ``bfloat16`` (the tensor cores,
    the MFU denominator as in the JAX package) or ``float32`` (outside
    them); None for an unknown card or without one."""
    if dtype not in ("bfloat16", "float32"):
        raise ValueError(f"peak_flops dtype {dtype!r}: 'bfloat16' or 'float32'")
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        name = device
    else:
        if not torch.cuda.is_available():
            return None
        dev = torch.device("cuda", 0) if device is None else torch.device(device)
        if dev.type != "cuda":
            return None
        name = torch.cuda.get_device_name(dev)
    for key, (bf16, fp32) in _PEAK_FLOPS.items():
        if name.startswith(key):
            return bf16 if dtype == "bfloat16" else fp32
    return None


def bound(flops: float, nbytes: float, peak: float = FP32_FLOPS) -> Tuple[float, str]:
    """The least time on an H100 SXM for ``flops`` at ``peak`` and
    ``nbytes`` at HBM3's rate: (ms, "operations" or "bytes", whichever is
    larger)."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
