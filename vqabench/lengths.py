"""Length distributions of the traffic, read from a mix's parameters.

Every seed gets the same multiset of lengths (the distribution's shares
of ``n``, rounded by largest remainder) in another order, so runs on
different seeds do the same work.
"""

from __future__ import annotations

import math
from typing import List

import torch


def pmf(spec: dict) -> List[float]:
    """P(length = 1 .. max): ``shift`` + a Poisson (``mean``) or a negative
    binomial (``mean``, ``shape``) count, the tail beyond ``max`` put on
    ``max`` (truncation, as a fixed-width store cuts a sentence)."""
    kind, mu, top, shift = spec["kind"], spec["mean"], spec["max"], spec["shift"]
    if kind == "poisson":
        p = lambda k: math.exp(-mu + k * math.log(mu) - math.lgamma(k + 1))
    elif kind == "negbinom":
        r = spec["shape"]
        q = r / (r + mu)
        p = lambda k: math.exp(math.lgamma(k + r) - math.lgamma(r) - math.lgamma(k + 1)
                               + r * math.log(q) + k * math.log(1 - q))
    else:
        raise ValueError(f"length distribution {kind!r}: poisson or negbinom")
    out = [0.0] * top
    for length in range(shift, top):
        out[length - 1] = p(length - shift)
    out[top - 1] = max(0.0, 1.0 - sum(out))
    return out


def counts(spec: dict, n: int) -> List[int]:
    """How many of ``n`` take each length 1 .. max."""
    shares = [x * n for x in pmf(spec)]
    got = [int(s) for s in shares]
    order = sorted(range(len(shares)), key=lambda i: got[i] - shares[i])
    for i in order[: n - sum(got)]:
        got[i] += 1
    return got


def draw(spec: dict, n: int, gen: torch.Generator, device) -> torch.Tensor:
    """(n,) int64 lengths: the fixed multiset, permuted by ``gen``."""
    c = torch.tensor(counts(spec, n), device=device)
    lengths = torch.repeat_interleave(torch.arange(1, len(c) + 1, device=device), c)
    return lengths[torch.randperm(n, generator=gen, device=device)]
