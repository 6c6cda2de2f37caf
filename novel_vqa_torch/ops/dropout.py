"""Functional inverted dropout (port of ``novel_vqa_tpu.ops.dropout``).

Torch ``nn.Dropout`` (v7, ``train`` mode) semantics: each element is zeroed
with probability ``rate`` and survivors are scaled by ``1/(1-rate)``; in
evaluate mode the layer is the identity.  The reference applies 0.5 dropout
inside the question embedding (002_train_baseline.lua:143), between LSTM
layers (misc/LSTM.lua:37) and on both fusion inputs (misc/netdef.lua:10-11).

The keep mask is drawn from an explicit ``torch.Generator`` on the tensor's
device (a CUDA generator draws on the card, with no host round trip).  Its
bits cannot match the JAX package's ``rbg`` draws; the distribution does.

On a data-parallel group (``dp``, a ``parallel.mesh.DPGroup``) ``x`` is this
rank's slice, along ``axis``, of the global batch.  The mask is drawn at the
global shape and this rank's slice of it taken, so every rank's generator
stays in step and the ranks' masks together are the one process's mask, as
GSPMD's dropout over the global array is in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch


def dropout(
    x: torch.Tensor,
    rate: float,
    generator: Optional[torch.Generator],
    deterministic: bool,
    dp=None,
    axis: int = 0,
) -> torch.Tensor:
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout: training mode with rate > 0 needs a generator")
    keep = 1.0 - rate
    shape = list(x.shape)
    if dp is not None:
        shape[axis] *= dp.world_size
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if dp is not None:
        mask = dp.shard(mask, axis)
    return torch.where(mask, x / keep, torch.zeros_like(x))
