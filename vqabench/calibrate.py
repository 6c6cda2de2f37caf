"""The readings that the limits of ``correct`` are set from, on the card.

    python3 -m vqabench.calibrate --workload arch1.train --seeds 1,2,3 \\
        --modes program,control,unchanged,half_batch_ce [--seconds 2]

Runs the cell in this process once per seed and mode, and prints one JSON
line each with the numbers the check compared: ``program`` is the cell as
the benchmark runs it; ``control`` puts the reference, computed with TF32
on (the precision below the configurations' float32), in the program's
place; any other mode is a fault of the cell's configuration (``faults/``)
planted in the program.
Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program")
    ap.add_argument("--seconds", type=float, default=0.1)
    args = ap.parse_args(argv)

    import torch

    from vqabench import faults, harness

    if not torch.cuda.is_available():
        print("calibration runs on a CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        for mode in args.modes.split(","):
            planted = (contextlib.nullcontext() if mode in ("program", "control")
                       else faults.plant(args.workload, mode))
            t0 = time.perf_counter()
            with planted:
                result, _ = harness.run(args.workload, seed, args.seconds, False,
                                        t_start=t0, mode="control" if mode == "control" else "program")
            print(json.dumps({"workload": args.workload, "seed": seed, "mode": mode,
                              "correct": result["correct"],
                              "checks": {k: v["value"] for k, v in result["checks"].items()},
                              "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                              "wall_s": time.perf_counter() - t0}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
