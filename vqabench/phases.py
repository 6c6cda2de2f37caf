"""What the program's tracer (``novel_vqa_torch.core.profiling``) costs in
one call of a cell, read on the card.

    python3 -m vqabench.phases --workload arch1.train --seed 7 --rounds 5

Not part of a benchmark run.  It sets the cell up as ``harness.run`` does,
then prints one JSON line with:

  * ``on_cost``: ``--rounds`` pairs of ``cell.traced_dispatches`` calls,
    the tracer off and on (the side that goes first alternating, the card
    idle before each), and the median host ms per step (an optimizer step
    or a batch) of each side;
  * ``covered_share``: the share of the on side's host time, around each
    call, that the outermost spans cover.

The spans themselves (each name's count and inclusive and self host ms per
step) and the card's idle gaps labelled by them are in the result line of
``python3 -m vqabench.run ... --trace 1`` (``spans``,
``breakdown.idle_gaps``).  Without the program's tracer (a port older than
it) both readings are ``None``.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import statistics
import sys
import time
from typing import Optional

import torch

from vqabench import harness as H
from vqabench import spec as S
from vqabench import trace as T


def make_cell(workload: str, seed: int, device: str = "cuda", overrides: Optional[dict] = None):
    """The cell's entry, set up as ``harness.run`` sets it up."""
    cell_spec, ctx = H.context(S.load(), workload, seed, device, overrides)
    return importlib.import_module(f"vqabench.entries.{cell_spec['entry']}").Cell(ctx)


def _host_s(cell, k: int) -> float:
    """The host clock around each of ``k`` calls, summed."""
    total = 0.0
    for _ in range(k):
        a = time.perf_counter()
        cell.dispatch()
        total += time.perf_counter() - a
    return total


def measure(cell, rounds: int) -> dict:
    """The readings of the module docstring for a cell already set up."""
    collect = T.tracer()
    out = {"on_cost": None, "covered_share": None}
    if collect is None or not rounds:
        return out
    k = cell.traced_dispatches
    steps = k * cell.steps_per_dispatch
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sides, covered = {False: [], True: []}, []
    for r in range(rounds):
        for on in (r % 2 == 1, r % 2 == 0):  # alternate which side goes first
            sync()
            with collect() if on else contextlib.nullcontext() as rec:
                host = _host_s(cell, k)
            sides[on].append(1e3 * host / steps)
            if on:
                covered.append(sum(e - s for _, parent, s, e in rec.spans if parent < 0)
                               / 1e9 / host)
    sync()
    out["on_cost"] = {"off_ms_per_step": sides[False], "on_ms_per_step": sides[True],
                      "ratio_of_medians": statistics.median(sides[True])
                      / statistics.median(sides[False])}
    out["covered_share"] = statistics.median(covered)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("vqabench.phases needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    cell = make_cell(args.workload, args.seed)
    out = measure(cell, args.rounds)
    cell.free()
    out.update(workload=args.workload, seed=args.seed,
               device=torch.cuda.get_device_name(0))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
