"""One run of one cell: set-up, the measured window, the traced segments,
the check that decides ``correct``, and the result line.

A cell's entry (``entries/<entry>.py``) defines ``Cell(ctx)``, whose
construction is the set-up: it makes the traffic and the weights from the
seed, builds the program's objects, takes the first steps a check needs
and warms up every shape the window uses.  Then the harness calls
``cell.dispatch()`` (one call of the timed path) until ``seconds`` have
passed, waits for the card, and reads the rate over all the work and all
the time of the window.  With ``trace=True`` it then runs three segments
of ``cell.traced_dispatches`` more dispatches each: the card's activity
traced alone, for the per-layer device metrics (``trace.py``); the
program's tracer alone (``novel_vqa_torch.core.profiling.collect``, no
profiler), for the span metrics and the result line's ``spans`` (each
span's count and inclusive and self host ms per step or batch, beside the
segment's host ms); and the host's activity traced as well, with the
program's tracer on, for the breakdown's idle gaps.  Every metric,
end-to-end or per layer, is read by its own reader, ``metrics/<name>.py``.
After the memory peak is read, ``cell.free()`` lets the program's state
go and ``cell.check(mode)`` compares what the timed path produced with
the configuration's plain reference.

The entry contract, besides those three calls: ``units_per_dispatch``
(samples), ``steps_per_dispatch`` (optimizer steps or batches),
``work(first, count)`` (the model FLOPs and each kernel's per-launch
work of dispatches ``first .. first+count-1``, counting from the first
window dispatch) and ``dispatched`` (dispatches so far after set-up).

What a reader's ``read(m)`` gets in ``m``: ``setup_s``, ``window_s``,
``window_peak_bytes``, ``dispatches``, ``steps``, ``units`` and
``host_s`` of the window; ``model_flops`` of its work; ``counters``, the
window's increments of the port's launch counters by name (every integer
``launches`` attribute of a callable in an imported
``novel_vqa_torch.kernels`` module); ``peaks``, the card's (None off the
table); and with ``trace=True`` ``trace`` (the card-only segment's
:class:`trace.Trace`), ``traced`` (its ``dispatches``, ``steps`` and
each kernel's per-launch work) and ``spans`` (per program span name its
``count`` and inclusive and self host seconds, ``total_s`` and
``self_s``, over a segment of ``traced.dispatches``; None without the
program's tracer).  Without ``trace`` those three are None.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import math
import os
import sys
import time
import traceback
import types
from typing import Optional

import torch

from vqabench import peaks as P
from vqabench import spec as S
from vqabench import trace as T

FORBIDDEN = ("jax", "jaxlib", "flax", "novel_vqa_tpu")
KERNELS = "novel_vqa_torch.kernels."


def forbidden_modules():
    """The JAX modules loaded in this process, by whole top-level name."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _reader(name: str) -> types.ModuleType:
    path = S.PACKAGE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"vqabench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counters() -> dict:
    """The port's kernel launch counters: the integer ``launches``
    attribute of every callable defined in a ``novel_vqa_torch.kernels``
    module that this process has already imported, by the callable's name
    (qualified by its module where two modules share it).  Imports
    nothing."""
    out = {}
    for mod_name in sorted(m for m in sys.modules if m.startswith(KERNELS)):
        module = sys.modules[mod_name]
        for name, fn in sorted(vars(module).items()):
            count = getattr(fn, "launches", None)
            if not callable(fn) or getattr(fn, "__module__", None) != mod_name \
                    or not isinstance(count, int):
                continue
            out[name if name not in out else f"{mod_name[len(KERNELS):]}.{name}"] = count
    return out


def _span_seconds(rec) -> dict:
    """A program tracer record's spans by name: count, inclusive and self
    host seconds."""
    return {name: {"count": st.count, "total_s": st.total_ns / 1e9, "self_s": st.self_ns / 1e9}
            for name, st in rec.stats().items()}


def context(bench: S.Bench, workload: str, seed: int, device: str, overrides: Optional[dict]):
    """The cell's workload and configuration with ``overrides`` merged in,
    its environment set, and the ``ctx`` its entry's ``Cell`` takes."""
    cell_spec = S.merge(bench.cells[workload], (overrides or {}).get("cell"))
    config = S.merge(bench.configs[cell_spec["config"]], (overrides or {}).get("config"))
    os.environ.update({k: str(v) for k, v in cell_spec.get("env", {}).items()})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    traffic = cell_spec["traffic"]
    ctx = types.SimpleNamespace(
        cfg=config, traffic=traffic, seed=int(seed), device=torch.device(device),
        ref=importlib.import_module(f"vqabench.refs.{config['reference']}"),
        flops=importlib.import_module(f"vqabench.flops.{config['flops']}"),
        make_traffic=importlib.import_module(f"vqabench.traffic.{traffic['generator']}").make,
    )
    return cell_spec, ctx


def run(workload: str, seed: int, seconds: float, trace: bool, *, t_start: float,
        device: str = "cuda", overrides: Optional[dict] = None, mode: str = "program"):
    """One run; returns (the result dict, the compared numbers as lines).

    ``overrides`` merges into the configuration (``config``) and the
    workload (``cell``), for rehearsals at small sizes; ``mode`` is
    ``program`` or ``control`` (the reference, in a lower precision, in the
    program's place: a calibration, never a benchmark run)."""
    bench = S.load()
    cell_spec, ctx = context(bench, workload, seed, device, overrides)
    if ctx.cfg["dtype"] != "float32_tf32_off":
        raise S.SpecError(f"dtype {ctx.cfg['dtype']!r}: only float32_tf32_off is served")
    dev = ctx.device
    entry = importlib.import_module(f"vqabench.entries.{cell_spec['entry']}")
    t_cell = time.perf_counter()
    cell = entry.Cell(ctx)
    _sync(dev)

    cuda = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    counters0 = _counters()
    first = cell.dispatched
    host_s, n = 0.0, 0
    w0 = time.perf_counter()
    setup_s = w0 - t_start
    while True:
        a = time.perf_counter()
        cell.dispatch()
        b = time.perf_counter()
        host_s += b - a
        n += 1
        if b - w0 >= seconds:
            break
    _sync(dev)
    window_s = time.perf_counter() - w0
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    launches = {k: v - counters0.get(k, 0) for k, v in _counters().items()}
    work = cell.work(first, n)
    ctx_metrics = types.SimpleNamespace(
        setup_s=setup_s, window_s=window_s, window_peak_bytes=window_peak, dispatches=n,
        steps=n * cell.steps_per_dispatch, units=n * cell.units_per_dispatch, host_s=host_s,
        model_flops=work["model_flops"], counters=launches, trace=None, traced=None, spans=None,
        peaks=P.of(torch.cuda.get_device_name(dev) if cuda else None),
    )

    gaps = None
    if trace:
        k = cell.traced_dispatches
        start = cell.dispatched

        def body():
            for _ in range(k):
                cell.dispatch()

        def labelled():
            for _ in range(k):
                with T.span("dispatch"):
                    cell.dispatch()
            with T.span("sync"):
                _sync(dev)

        ctx_metrics.trace = T.capture(body)
        tw = cell.work(start - first, k)
        ctx_metrics.traced = types.SimpleNamespace(
            dispatches=k, steps=k * cell.steps_per_dispatch, kernels=tw["kernels"])
        # the program's spans, after the card-only segment: where a profiler
        # has traced the card once, a host-paced cell's issue can stay slower
        # for the rest of the process, and the spans read that host
        collect = T.tracer()
        if collect is not None:
            a = time.perf_counter()
            with collect() as rec:
                body()
            span_host_s = time.perf_counter() - a
            _sync(dev)
            ctx_metrics.spans = _span_seconds(rec)
        with collect() if collect is not None else contextlib.nullcontext():
            gaps = T.profile_gaps(labelled)["gaps"]
    peak = max(peak, window_peak, torch.cuda.max_memory_allocated(dev) if cuda else 0)
    cell.free()
    if cuda:
        torch.cuda.empty_cache()

    limits = cell_spec["limits"]
    try:
        numbers = cell.check(mode)
        compared = {name: {"value": numbers[name], "limit": lim} for name, lim in limits.items()}
        failed = sum(1 for c in compared.values()
                     if not (isinstance(c["value"], float) and c["value"] <= c["limit"]))
    except Exception as exc:  # a check that cannot be made is a failed check
        traceback.print_exc()
        compared = {"check_error": {"value": f"{type(exc).__name__}: {exc}"[:300], "limit": None}}
        failed = 1

    e2e, layer = bench.metrics_of(workload)
    metrics = {}
    for m in layer if trace else e2e:
        value = _reader(m["name"]).read(ctx_metrics)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device_info = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": failed == 0, "attempted": ctx_metrics.units, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace:
        tr = ctx_metrics.trace
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": gaps}
        if ctx_metrics.spans is not None:
            steps = ctx_metrics.traced.steps
            result["spans"] = {
                "host_ms_per_step": 1e3 * span_host_s / steps,
                "by_name": {name: {"count": st["count"], "ms_per_step": 1e3 * st["total_s"] / steps,
                                   "self_ms_per_step": 1e3 * st["self_s"] / steps}
                            for name, st in sorted(ctx_metrics.spans.items())}}
    result["launches"] = launches
    # set-up before the cell (interpreter, torch, the card) and the cell's own
    result["setup_parts_s"] = {"before_cell": t_cell - t_start, "cell": w0 - t_cell}
    result["checks"] = compared
    lines = [f"check {name} {c['value']} limit {c['limit']}" for name, c in compared.items()]
    return result, lines
