"""Metrics logging: console + text logs + structured JSONL (copy of
``novel_vqa_tpu.core.logging``).

The reference's observable surface: EMA train loss ``running_avg =
0.95*running_avg + 0.05*loss`` (002_train_vqa_arch1/002_train_baseline.lua:
330-334), console prints (:404-407), ``logFile.txt``/``logFileVal.txt``
text logs (:389-399), plus a ``<run_name>_metrics.jsonl`` stream for
tooling.  File names and line formats are the JAX package's.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class EMA:
    def __init__(self, decay: float = 0.95):
        self.decay = decay
        self.value: Optional[float] = None

    def update(self, x: float) -> float:
        self.value = x if self.value is None else self.decay * self.value + (1 - self.decay) * x
        return self.value


class MetricsLogger:
    def __init__(self, out_dir: str, run_name: str = "train"):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.txt = open(os.path.join(out_dir, "logFile.txt"), "w")
        self.txt_val = open(os.path.join(out_dir, "logFileVal.txt"), "w")
        self.jsonl = open(os.path.join(out_dir, f"{run_name}_metrics.jsonl"), "w")
        self.t0 = time.time()

    def log_train(self, it: int, max_iters: int, running_avg: float, **extra):
        line = f"training loss: {running_avg}\ton iter: {it}/{max_iters}"
        print(line)
        self.txt.write(line + "\n")
        self.txt.flush()
        self._jsonl({"kind": "train", "iter": it, "loss_ema": running_avg, **extra})

    def log_val(self, it: int, max_iters: int, loss: float, running_avg: float, **extra):
        line = (
            f"validation loss: {loss} validation loss avg: {running_avg}"
            f" on iter: {it}/{max_iters}"
        )
        print(line)
        self.txt_val.write(line + "\n")
        self.txt_val.flush()
        self._jsonl({"kind": "val", "iter": it, "loss": loss, "loss_ema": running_avg, **extra})

    def _jsonl(self, rec: Dict[str, Any]):
        rec["t"] = round(time.time() - self.t0, 3)
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()

    def close(self):
        self.txt.close()
        self.txt_val.close()
        self.jsonl.close()
