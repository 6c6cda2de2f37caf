"""One run of one cell: set-up, the measured window, the traced segments,
the check that decides ``correct``, and the result line.

A cell's entry (``entries/<entry>.py``) defines ``Cell(ctx)``, whose
construction is the set-up: it makes the traffic and the weights from the
seed, builds the program's objects, takes the first steps a check needs
and warms up every shape the window uses.  Then the harness calls
``cell.dispatch()`` (one call of the timed path) until ``seconds`` have
passed, waits for the card, and reads the rate over all the work and all
the time of the window.  With ``trace=True`` it then traces two segments
of ``cell.traced_dispatches`` more dispatches each: the card's activity
alone, for the per-layer metrics, and then the host's as well, for the
breakdown's idle gaps (``trace.py``).  Every metric, end-to-end or per
layer, is read by its own reader, ``metrics/<name>.py``.
After the memory peak is read, ``cell.free()`` lets the program's state
go and ``cell.check(mode)`` compares what the timed path produced with
the configuration's plain reference.

The entry contract, besides those three calls: ``units_per_dispatch``
(samples), ``steps_per_dispatch`` (optimizer steps or batches),
``work(first, count)`` (the model FLOPs and each kernel's per-launch
work of dispatches ``first .. first+count-1``, counting from the first
window dispatch) and ``dispatched`` (dispatches so far after set-up).
"""

from __future__ import annotations

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


def forbidden_modules():
    """The JAX modules loaded in this process, by whole top-level name."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _merge(base: dict, over: Optional[dict]) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


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
    """The port's kernel launch counters, where it has them."""
    out = {}
    try:
        from novel_vqa_torch.kernels import lstm as K
    except ImportError:
        return out
    for name in ("lstm_seq", "lstm_step"):
        fn = getattr(K, name, None)
        if fn is not None and isinstance(getattr(fn, "launches", None), int):
            out[name] = fn.launches
    return out


def run(workload: str, seed: int, seconds: float, trace: bool, *, t_start: float,
        device: str = "cuda", overrides: Optional[dict] = None, mode: str = "program"):
    """One run; returns (the result dict, the compared numbers as lines).

    ``overrides`` merges into the configuration (``config``) and the
    workload (``cell``), for rehearsals at small sizes; ``mode`` is
    ``program`` or ``control`` (the reference, in a lower precision, in the
    program's place: a calibration, never a benchmark run)."""
    bench = S.load()
    cell_spec = _merge(bench.cells[workload], (overrides or {}).get("cell"))
    config = _merge(bench.configs[cell_spec["config"]], (overrides or {}).get("config"))
    os.environ.update({k: str(v) for k, v in cell_spec.get("env", {}).items()})
    if config["dtype"] != "float32_tf32_off":
        raise S.SpecError(f"dtype {config['dtype']!r}: only float32_tf32_off is served")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    traffic = cell_spec["traffic"]
    ctx = types.SimpleNamespace(
        cfg=config, traffic=traffic, seed=int(seed), device=dev,
        ref=importlib.import_module(f"vqabench.refs.{config['reference']}"),
        flops=importlib.import_module(f"vqabench.flops.{config['flops']}"),
        make_traffic=importlib.import_module(f"vqabench.traffic.{traffic['generator']}").make,
    )
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
        model_flops=work["model_flops"], trace=None, traced=None,
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
        gaps = T.idle_gaps(labelled)
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
    result["launches"] = launches
    # set-up before the cell (interpreter, torch, the card) and the cell's own
    result["setup_parts_s"] = {"before_cell": t_cell - t_start, "cell": w0 - t_cell}
    result["checks"] = compared
    lines = [f"check {name} {c['value']} limit {c['limit']}" for name, c in compared.items()]
    return result, lines
