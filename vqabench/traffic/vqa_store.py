"""A VQA split made on the device from the seed: right-aligned questions
over a store of L2-normalized image features.

Parameters: ``questions``, ``images``, ``lengths`` (``vqabench/lengths``),
``answers`` (ids uniform over 1 .. answers), ``mc_choices`` (distinct
multiple-choice ids per question, 0 for none), ``words``
(``vqabench/words``) over the configuration's vocabulary.  Image rows are
N(0, 1) scaled to unit norm, each question's image uniform over the store.
"""

from __future__ import annotations

import torch

from vqabench import lengths as L
from vqabench import words as W


def make(p: dict, cfg: dict, gen: torch.Generator, device) -> dict:
    n, m, T = p["questions"], p["images"], cfg["seq_length"]
    lengths = L.draw(p["lengths"], n, gen, device)
    words = W.draw(p["words"], (n, T), cfg["vocab_size"], gen, device)
    steps = torch.arange(T, device=device)[None, :]
    tokens = torch.where(steps >= T - lengths[:, None], words, torch.zeros_like(words))
    image = torch.randn(m, cfg["nhimage"], generator=gen, device=device)
    image /= torch.linalg.vector_norm(image, dim=1, keepdim=True)
    store = {
        "tokens": tokens,
        "lengths": lengths,
        "image": image,
        "img_pos": torch.randint(1, m + 1, (n,), generator=gen, device=device, dtype=torch.int32),
        "answers": torch.randint(1, p["answers"] + 1, (n,), generator=gen, device=device,
                                 dtype=torch.int32),
    }
    k = p["mc_choices"]
    if k:
        weights = torch.ones(min(n, 16384), p["answers"], device=device)
        store["mc_ans"] = torch.cat([
            torch.multinomial(weights[: min(16384, n - s)], k, generator=gen) + 1
            for s in range(0, n, 16384)]).to(torch.int32)
    return store
