"""Functional inverted dropout (port of ``novel_vqa_tpu.ops.dropout``).

Torch ``nn.Dropout`` (v7, ``train`` mode) semantics: each element is zeroed
with probability ``rate`` and survivors are scaled by ``1/(1-rate)``; in
evaluate mode the layer is the identity.  The reference applies 0.5 dropout
inside the question embedding (002_train_baseline.lua:143), between LSTM
layers (misc/LSTM.lua:37) and on both fusion inputs (misc/netdef.lua:10-11).

The keep mask is drawn from an explicit ``torch.Generator`` on the tensor's
device (a CUDA generator draws on the card, with no host round trip).  Its
bits cannot match the JAX package's ``rbg`` draws; the distribution does.
"""

from __future__ import annotations

from typing import Optional

import torch


def dropout(
    x: torch.Tensor,
    rate: float,
    generator: Optional[torch.Generator],
    deterministic: bool,
) -> torch.Tensor:
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout: training mode with rate > 0 needs a generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
