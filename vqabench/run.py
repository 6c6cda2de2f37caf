"""Run one benchmark cell once and print its result line.

    python3 -m vqabench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port.  Exits 2 without the
cards the cell asks for, and 3 if JAX or the JAX package was loaded, in
both cases printing no result.  The last line of standard output is the
result (JSON); the last lines of standard error give each number the
check compared beside its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402


def _plain(value):
    """JSON has no infinities: a compared number that is not finite is
    written as a string."""
    if isinstance(value, float) and not math.isfinite(value):
        return str(value)
    return value


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from vqabench import harness, spec

    bench = spec.load()
    if args.workload not in bench.cells:
        print(f"unknown workload {args.workload!r}: {sorted(bench.cells)}", file=sys.stderr)
        return 2
    chips = bench.cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result, lines = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                                t_start=T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"JAX modules loaded in the benchmark's process: {loaded}", file=sys.stderr)
        return 3
    for c in result["checks"].values():
        c["value"] = _plain(c["value"])
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
