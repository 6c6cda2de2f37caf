"""Device selection for the port's entry points.

Every entry point runs on ``cuda`` unless the caller asks for ``cpu``.
Asking for ``cuda`` without a card raises; nothing quietly falls back to the
CPU, so a number taken on the CPU can never pass for one taken on the card.
"""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(name)!r} requested but torch.cuda.is_available() is "
            "False; pass device 'cpu' (--device cpu) to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {str(name)!r}: use 'cuda' or 'cpu'")
    return device
