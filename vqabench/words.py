"""Word ids of the traffic, read from a mix's ``words`` parameters.

``{"kind": "zipf", "exponent": s}``: id r of a vocabulary of V words is
the word of frequency rank r, drawn with probability proportional to
r^-s (Zipf's law; s near 1 for English text, Piantadosi 2014,
Psychonomic Bulletin & Review 21:1112).  Ids repeat as text repeats
them, and the lookup gradient's time depends on how often they do.
"""

from __future__ import annotations

import torch


def shares(spec: dict, vocab: int) -> torch.Tensor:
    """P(id = 1 .. vocab), float64 on the host."""
    if spec["kind"] != "zipf":
        raise ValueError(f"word distribution {spec['kind']!r}: zipf")
    p = torch.arange(1, vocab + 1, dtype=torch.float64).pow(-float(spec["exponent"]))
    return p / p.sum()


def draw(spec: dict, shape, vocab: int, gen: torch.Generator, device) -> torch.Tensor:
    """int32 ids in 1 .. vocab of ``shape``, drawn by ``gen``."""
    cdf = torch.cumsum(shares(spec, vocab), 0).to(device)
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
    ids = torch.searchsorted(cdf, u.reshape(-1)).reshape(shape)
    return ids.clamp_(max=vocab - 1).add_(1).to(torch.int32)
