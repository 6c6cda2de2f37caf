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
    and by ``record_function`` stage over one call;
  * :func:`peak_flops`: the card's peak FLOP/s by name (bf16 dense, the MFU
    denominator, and fp32 beside it); :func:`bound`, the least time for
    given FLOPs and bytes;
  * :func:`summarize`: (FLOPs/step, device seconds, items/step) -> the
    ``{items_per_sec, device_step_ms, mfu}`` record, refusing an MFU > 1
    as trustworthy (copied from the JAX package);
  * the analytic step FLOPs of arch1, arch2 and the text AE (copied).
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
    "summarize",
    "analytic_flops_arch1_step",
    "analytic_flops_arch2_step",
    "analytic_flops_text_ae_step",
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


def stage_profile(fn, top: int = 6, stages=("extract.", "vgg.", "inception.")) -> dict:
    """Device ms by stage over one call of ``fn``, from torch.profiler: each
    ``record_function`` range whose name starts with one of ``stages``
    (the extraction forwards': extract.prepro, vgg.block1..5, vgg.fc6,
    vgg.fc7; inception.stem, .mixed5, .mixed6, .mixed7, .pool) sums the
    device time of the kernels launched inside it; beside it the total
    kernel time and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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


def summarize(
    *,
    flops_per_step: Optional[float],
    device_s: Optional[float],
    n_steps: int,
    items_per_step: float,
    wall_s: float,
    peak: Optional[float],
) -> dict:
    """Build the honest throughput record.

    Primary figures derive from trace device time when available.  Wall-clock
    figures are always included for transparency, but when they would imply
    an MFU above 1.0 (physically impossible) they are marked untrusted and
    never used as the headline value.
    """
    rec: dict = {
        "n_steps": n_steps,
        "items_per_step": items_per_step,
        "wall_s": round(wall_s, 4),
    }
    if flops_per_step:
        rec["flops_per_step"] = flops_per_step

    wall_items = items_per_step * n_steps / wall_s if wall_s > 0 else None
    wall_mfu = (
        flops_per_step * n_steps / wall_s / peak
        if (flops_per_step and peak and wall_s > 0)
        else None
    )
    if wall_items is not None:
        rec["wall_items_per_sec"] = round(wall_items, 2)
    if wall_mfu is not None:
        rec["wall_mfu"] = round(wall_mfu, 4)
        rec["wall_clock_trusted"] = wall_mfu <= 1.0

    if device_s and device_s > 0:
        rec["timing_source"] = "profiler_device_time"
        rec["device_step_ms"] = round(device_s / n_steps * 1e3, 4)
        rec["items_per_sec"] = round(items_per_step * n_steps / device_s, 2)
        if flops_per_step and peak:
            rec["mfu"] = round(flops_per_step * n_steps / device_s / peak, 4)
    elif wall_mfu is None or wall_mfu <= 1.0:
        # no device plane (CPU run): wall-clock is the only figure
        rec["timing_source"] = "wall_clock"
        rec["device_step_ms"] = None
        rec["items_per_sec"] = rec.get("wall_items_per_sec")
        if wall_mfu is not None:
            rec["mfu"] = round(wall_mfu, 4)
    else:
        # wall clock implies >100% MFU and there is no device time: refuse
        rec["timing_source"] = "untrusted"
        rec["device_step_ms"] = None
        rec["items_per_sec"] = None
    return rec


def analytic_flops_arch1_step(cfg, batch_size: int, seq_len: int) -> float:
    """Analytic matmul FLOPs for ONE arch1 fwd+bwd+update train step.

    Counts the matmul terms only (gates, fusion, classifier; fwd + ~2x for
    bwd), which dominate; elementwise/optimizer FLOPs are ignored.  Workload
    per 002_train_vqa_arch1/002_train_baseline.lua:141-157.
    """
    E, H, L = cfg.input_encoding_size, cfg.rnn_size, cfg.rnn_layer
    per_tok = 0.0
    for layer in range(L):
        in_size = E if layer == 0 else H
        per_tok += 2.0 * 4 * H * (in_size + H)  # x@Wi + h@Wh
    lstm = per_tok * seq_len
    fusion = 2.0 * (2 * H * L) * cfg.common_embedding_size + 2.0 * cfg.nhimage * cfg.common_embedding_size
    classifier = 2.0 * cfg.common_embedding_size * cfg.num_output
    fwd = (lstm + fusion + classifier) * batch_size
    return 3.0 * fwd  # bwd ~= 2x fwd


def analytic_flops_arch2_step(cfg, batch_size: int, seq_len: int) -> float:
    """Analytic matmul FLOPs for ONE arch2 fwd+bwd+update train step
    (003_train_vqa_arch2/002_train_baseline.lua: cnn_projection ->
    nn.Encoder over [img, START, w1..wL] -> classifier).

    The encoder runs ``seq_len + 2`` LSTM steps (image tick + START token +
    tokens, misc/Encoder_lstm.lua:170-226); bwd ~= 2x fwd.
    """
    E, H = cfg.input_encoding_size, cfg.rnn_size
    per_tok = 0.0
    for i in range(cfg.num_layers):
        in_size = E if i == 0 else H
        per_tok += 2.0 * 4 * H * (in_size + H)
    enc = per_tok * (seq_len + 2)
    proj = 2.0 * cfg.nhimage * E
    classifier = 2.0 * H * cfg.num_output
    return 3.0 * (enc + proj + classifier) * batch_size


def analytic_flops_text_ae_step(cfg, batch_size: int, seq_len: int) -> float:
    """Analytic matmul FLOPs for ONE text-AE fwd+bwd+update train step
    (001_train_autoencoder/001_train_arch1_text_autoencoder.lua:208-249).

    Encoder: ``seq_len`` LSTM steps; decoder: ``seq_len + 1`` steps of gates
    plus the dominant Linear(H, V+1) projection.  bwd ~= 2x fwd, plus one
    extra decoder forward (the JAX package rematerializes the fused-NLL
    body; the count is kept as the JAX package's, so both report one
    number for one workload)."""
    E, H = cfg.input_encoding_size, cfg.rnn_size
    enc_tok = 0.0
    for i in range(cfg.num_layers):
        in_size = E if i == 0 else H
        enc_tok += 2.0 * 4 * H * (in_size + H)
    enc = enc_tok * seq_len
    dec_tok = 0.0
    for i in range(cfg.decoder_layers):
        in_size = E if i == 0 else H
        dec_tok += 2.0 * 4 * H * (in_size + H)
    dec_tok += 2.0 * H * (cfg.vocab_size + 1)  # logits projection
    dec = dec_tok * (seq_len + 1)
    fwd = (enc + dec) * batch_size
    return 3.0 * fwd + dec * batch_size  # + the recompute of the decoder
