"""The cards' published peaks (NVIDIA's data sheet, SXM part, dense rates,
at the full 700 W), by the name ``torch.cuda.get_device_name`` gives.

The configurations here are float32 with TF32 off, so their FLOPs run
outside the tensor cores: ``fp32`` is the rate an MFU and a roofline of
theirs are held to.
"""

from __future__ import annotations

from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "fp32": 67e12,  # FLOP/s, CUDA cores
        "tf32": 495e12,  # FLOP/s, tensor cores
        "bf16": 989e12,  # FLOP/s, tensor cores
        "hbm": 3.35e12,  # bytes/s
    },
}


def of(kind: Optional[str]) -> Optional[dict]:
    """The peaks of a card by its name; None for a card not in the table."""
    return PEAKS.get(kind or "")


def bound_seconds(work, peaks: dict) -> float:
    """The least time for ``work``, a list of (count, flops, bytes) per
    launch: each launch bound by its operations at the fp32 peak or its
    bytes at HBM's rate, whichever takes longer."""
    return sum(n * max(f / peaks["fp32"], b / peaks["hbm"]) for n, f, b in work)
