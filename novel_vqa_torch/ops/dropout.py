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


def dropout_mask(
    x: torch.Tensor,
    rate: float,
    generator: Optional[torch.Generator],
    dp=None,
    axis: int = 0,
) -> torch.Tensor:
    """The keep mask of :func:`dropout` for ``x`` (bool, ``x``'s shape),
    drawn from ``generator`` as :func:`dropout` draws it.  A caller that
    recomputes its forward (``ops/lstm.py`` under ``remat``) draws the
    mask once, outside the recomputed region."""
    if generator is None:
        raise ValueError("dropout: training mode with rate > 0 needs a generator")
    shape = list(x.shape)
    if dp is not None:
        shape[axis] *= dp.world_size
    mask = torch.rand(shape, generator=generator, device=x.device) < 1.0 - rate
    if dp is not None:
        mask = dp.shard(mask, axis)
    return mask


def apply_mask(x: torch.Tensor, mask: torch.Tensor, rate: float) -> torch.Tensor:
    """Survivors scaled by ``1/(1-rate)``, the rest zeroed; a Python scalar
    keeps ``x``'s dtype (bf16 stays bf16, as in the JAX package)."""
    keep = 1.0 - rate
    return torch.where(mask, x / keep, torch.zeros_like(x))


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
    return apply_mask(x, dropout_mask(x, rate, generator, dp, axis), rate)
