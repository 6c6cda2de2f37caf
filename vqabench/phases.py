"""Where the host's time goes inside one call of a cell: the program's own
spans (``novel_vqa_torch.core.profiling``), read on the card.

    python3 -m vqabench.phases --workload arch1.train --seed 7 --seconds 20 --rounds 5

Not part of a benchmark run.  It sets the cell up as ``harness.run`` does,
then prints one JSON line with:

  * ``window``: ``--seconds`` of calls with the tracer off, the host clock
    around each call (what ``host_ms_per_step.*`` reads);
  * ``spans``: ``cell.traced_dispatches`` more calls, from an idle card,
    with the tracer on and no profiler: each span's inclusive and self host
    ms per step (an optimizer step or a batch) and per call, and the share
    of the calls' host time that the outermost spans cover;
  * ``on_cost``: ``--rounds`` pairs of ``cell.traced_dispatches`` calls,
    the tracer off and on (the side that goes first alternating, the card
    idle before each), and the median host ms per step of each side;
  * ``idle_gaps``: the card's idle seconds under a profiler of the host and
    the card with the tracer on, labelled ``<harness span>/<innermost
    nvqa.* span>/<host operator>`` (``<harness span>/<host operator>``
    outside every program span), the longest ten, and the share of all
    idle seconds and of the ten listed that carry a program span.

Without the program's tracer (a port older than it) ``spans``, ``on_cost``
and the share read ``None``.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import statistics
import sys
import time
import types
from collections import defaultdict
from typing import Callable, List, Optional

import torch

from vqabench import harness as H
from vqabench import spec as S
from vqabench import trace as T


def _tracer():
    """The program's ``collect``, or None where the port has no tracer."""
    try:
        from novel_vqa_torch.core.profiling import collect
    except ImportError:
        return None
    return collect


def make_cell(workload: str, seed: int, device: str = "cuda", overrides: Optional[dict] = None):
    """The cell's entry, set up as ``harness.run`` sets it up."""
    bench = S.load()
    cell_spec = H._merge(bench.cells[workload], (overrides or {}).get("cell"))
    config = H._merge(bench.configs[cell_spec["config"]], (overrides or {}).get("config"))
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
    return importlib.import_module(f"vqabench.entries.{cell_spec['entry']}").Cell(ctx)


def _host_s(cell, k: int) -> float:
    """The host clock around each of ``k`` calls, summed."""
    total = 0.0
    for _ in range(k):
        a = time.perf_counter()
        cell.dispatch()
        total += time.perf_counter() - a
    return total


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


def labelled_idle_gaps(body: Callable[[], None], k: int = 10) -> dict:
    """:func:`vqabench.trace.idle_gaps` with the innermost program span
    open at each gap's start in the label (:func:`label_gaps`)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        with record_function(T.SPAN):
            body()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    return label_gaps(T._events(prof), k)


def label_gaps(events: List[dict], k: int = 10) -> dict:
    """The card's idle gaps in a profile's complete events, in seconds by
    ``<harness span>/<innermost nvqa.* span>/<host operator>`` at each
    gap's start (``<harness span>/<host operator>`` outside every program
    span): ``{"gaps": the k longest labels, "program_share": the share of
    all idle seconds whose label holds a program span, "listed_share":
    that share of the k listed}``."""
    seg = [e for e in events if e["cat"] == "user_annotation" and e["name"] == T.SPAN]
    if not seg:
        return {"gaps": [], "program_share": None, "listed_share": None}
    window = T._interval(seg[0])[:2]
    tid = seg[0].get("tid")
    ops = [T._interval(e) for e in events if e["cat"] in T.DEVICE_CATS]
    mine = [e for e in events if e.get("tid") == tid]
    host = T._outermost([T._interval(e) for e in mine if e["cat"] == "cpu_op"])
    notes = [T._interval(e) for e in mine if e["cat"] == "user_annotation"]
    harness = T._outermost([iv for iv in notes if iv[2].startswith("vqabench.")
                            and iv[2] != T.SPAN])
    program = _innermost([iv for iv in notes if iv[2].startswith("nvqa.")], "")
    gaps, t = [], window[0]
    for s, e in T._union(ops, window):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if window[1] > t:
        gaps.append((t, window[1]))
    span_at, op_at = T._finder(harness, "harness"), T._finder(host, "python")
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


def measure(cell, seconds: float, rounds: int) -> dict:
    """The readings of the module docstring for a cell already set up."""
    collect = _tracer()
    k, per = cell.traced_dispatches, cell.steps_per_dispatch
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    host, n, w0 = 0.0, 0, time.perf_counter()
    while time.perf_counter() - w0 < seconds or not n:
        host += _host_s(cell, 1)
        n += 1
    sync()
    out = {"window": {"dispatches": n, "host_ms_per_step": 1e3 * host / (n * per)},
           "steps_per_dispatch": per, "traced_dispatches": k,
           "spans": None, "on_cost": None}
    if collect is not None:
        sync()
        with collect() as rec:
            seg_host = _host_s(cell, k)
        steps = k * per
        stats = rec.stats()
        top = sum(e - s for _, parent, s, e in rec.spans if parent < 0) / 1e6
        out["spans"] = {
            "host_ms_per_step": 1e3 * seg_host / steps,
            "covered_share": top / (1e3 * seg_host),
            "by_name": {name: {"count": st.count, "ms_per_step": st.total_ns / 1e6 / steps,
                               "self_ms_per_step": st.self_ns / 1e6 / steps,
                               "ms_per_dispatch": st.total_ns / 1e6 / k}
                        for name, st in sorted(stats.items())},
        }
        sides = {False: [], True: []}
        for r in range(rounds):
            for on in (r % 2 == 1, r % 2 == 0):  # alternate which side goes first
                sync()
                with collect() if on else contextlib.nullcontext():
                    sides[on].append(1e3 * _host_s(cell, k) / steps)
        if rounds:
            out["on_cost"] = {"off_ms_per_step": sides[False], "on_ms_per_step": sides[True],
                              "ratio_of_medians": statistics.median(sides[True])
                              / statistics.median(sides[False])}
        sync()

    def labelled():
        for _ in range(k):
            with T.span("dispatch"):
                cell.dispatch()
        with T.span("sync"):
            sync()

    with collect() if collect is not None else contextlib.nullcontext():
        out["idle_gaps"] = labelled_idle_gaps(labelled)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("vqabench.phases needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    cell = make_cell(args.workload, args.seed)
    out = measure(cell, args.seconds, args.rounds)
    cell.free()
    out.update(workload=args.workload, seed=args.seed,
               device=torch.cuda.get_device_name(0))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
