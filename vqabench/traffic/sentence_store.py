"""A sentence corpus made on the device from the seed: left-aligned rows
of ``seq_length`` tokens with a null suffix, as the corpus loader reads
them.

Parameters: ``rows``, ``lengths`` (``vqabench/lengths``), ``words``
(``vqabench/words``) over the configuration's vocabulary.
"""

from __future__ import annotations

import torch

from vqabench import lengths as L
from vqabench import words as W


def make(p: dict, cfg: dict, gen: torch.Generator, device) -> dict:
    n, T = p["rows"], cfg["seq_length"]
    lengths = L.draw(p["lengths"], n, gen, device)
    words = W.draw(p["words"], (n, T), cfg["vocab_size"], gen, device)
    steps = torch.arange(T, device=device)[None, :]
    rows = torch.where(steps < lengths[:, None], words, torch.zeros_like(words))
    return {"rows": rows, "lengths": lengths}
