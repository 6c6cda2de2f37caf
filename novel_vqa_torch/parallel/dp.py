"""Batch gather over a device-resident split store and the multi-step
training loop (port of ``novel_vqa_tpu.parallel.dp.gather_batch`` and
``vqa_scan_steps``; the rest of the data-parallel module comes with the
multi-GPU slice)."""

from __future__ import annotations

from typing import Callable

import torch

from novel_vqa_torch.core.tree import value_and_grad
from novel_vqa_torch.ops.optim import GradientTransformation, apply_updates


def gather_batch(data, qinds):
    """(tokens, image, labels) of rows ``qinds`` from the store ``data``
    (tokens (N, D), image (M, F), img_pos (N,) 1-indexed, answers (N,));
    only the index vector crosses from the host (002_train_baseline.lua:
    195-222 inverted)."""
    tokens = data["tokens"][qinds]
    labels = data["answers"][qinds]
    iminds = data["img_pos"][qinds].long() - 1
    image = data["image"][iminds]
    return tokens, image, labels


def vqa_scan_steps(
    loss_fn: Callable, cfg, tx: GradientTransformation,
    params, opt_state, data, generator: torch.Generator,
    n_steps: int, batch_size: int,
):
    """``n_steps`` training iterations with on-device batch sampling
    (uniform with replacement, the reference's ``torch.random`` draw,
    002_train_baseline.lua:203), the batch gathered from the resident
    store, then forward, backward and update.  The JAX package scans this
    body in one dispatch; here it is a loop that never waits for the
    device: the indices and the dropout masks come from ``generator``, a
    generator on the store's device, and the losses stay there.

    Returns (params, opt_state, losses (n_steps,))."""
    n = data["tokens"].shape[0]
    device = data["tokens"].device
    step = value_and_grad(loss_fn)
    losses = []
    for _ in range(n_steps):
        qinds = torch.randint(0, n, (batch_size,), generator=generator, device=device)
        tokens, image, labels = gather_batch(data, qinds)
        loss, grads = step(params, cfg, tokens, image, labels, generator)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        losses.append(loss)
    return params, opt_state, torch.stack(losses)
