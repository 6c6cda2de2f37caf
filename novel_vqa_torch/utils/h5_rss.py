"""Peak host memory of the port's h5 writer on a large store (a CPU
measurement; no device is involved).

    python -m novel_vqa_torch.utils.h5_rss --gb 2 --dir /tmp/h5rss

Each measurement runs in a fresh process, since ``getrusage``'s peak is the
process's:

  write   a (rows, 4096) float32 store of about ``--gb`` GB, made in memory,
          written by ``core/h5.write_h5``;
  append  ``core/h5.update_h5`` adds a (1, 4096) dataset to that file,
          copying the store from the old file.

Prints one JSON line: per measurement the resident set before the call
and the peak during the process (kB), and the store's bytes.  A writer
that held the file in memory would peak at the store plus two copies of
the file in ``write`` and at two copies in ``append``.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np

from novel_vqa_torch.core.h5 import update_h5, write_h5

COLS = 4096


def _rss_kb() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") // 1024


def _child(what: str, path: str, rows: int) -> dict:
    if what == "write":
        store = np.empty((rows, COLS), np.float32)
        for start in range(0, rows, 8192):  # touch every page: the store is resident
            store[start : start + 8192] = np.float32(start)
        before = _rss_kb()
        t0 = time.perf_counter()
        write_h5(path, {"images_train": store})
    else:
        before = _rss_kb()
        t0 = time.perf_counter()
        update_h5(path, {"mean_vector": np.ones((1, COLS), np.float32)})
    return {"rss_kb_before": before, "peak_rss_kb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss,
            "seconds": time.perf_counter() - t0, "file_bytes": os.path.getsize(path)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gb", type=float, default=2.0)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--child", default="", choices=["", "write", "append"])
    args = ap.parse_args(argv)
    rows = int(args.gb * 1e9) // (COLS * 4)
    path = os.path.join(args.dir, "store.h5")
    if args.child:
        print(json.dumps(_child(args.child, path, rows)))
        return {}
    os.makedirs(args.dir, exist_ok=True)
    out = {"store_bytes": rows * COLS * 4, "shape": [rows, COLS], "device": "cpu (host memory only)"}
    try:
        for what in ("write", "append"):
            proc = subprocess.run(
                [sys.executable, "-m", "novel_vqa_torch.utils.h5_rss", "--gb", str(args.gb),
                 "--dir", args.dir, "--child", what],
                capture_output=True, text=True, check=True)
            out[what] = json.loads(proc.stdout.strip().splitlines()[-1])
    finally:
        if os.path.exists(path):
            os.remove(path)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
