"""Data-parallel helpers shared by the trainers and the eval loops (port of
``novel_vqa_tpu.parallel.dp``).

arch1 and arch2 need the same DP machinery (the models differ only in the
``loss_fn`` each closes over), so the step factories live here once.  The recipe
is the JAX package's: params, optimizer state and the device-resident
dataset on every rank, the per-step sampled index vector sharded over the
group so the batch gather and forward/backward run per card, the gradient
mean all-reduced before the update (``parallel/mesh.py``).  One process is
the group of one (``DPGroup(0, 1, device)``): the same code, every
collective the identity, and the models' single-device steps
(``arch{1,2}.train_step_indexed``, ``train_steps_scan``) are these steps on
that group.

``loss_fn`` contract: ``loss_fn(params, cfg, tokens, image, labels,
generator, dp=None) -> scalar mean loss`` (``arch1.loss_fn`` and
``arch2.loss_fn``).

The fetch helpers copy device results into pinned host memory without
waiting for the card, each copy followed by an event, so the host waits
only when it reads a result.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from novel_vqa_torch.core.profiling import span
from novel_vqa_torch.ops.optim import GradientTransformation
from novel_vqa_torch.parallel.mesh import DPGroup, dp_update


def _start_copy(dev: torch.Tensor, host: Optional[torch.Tensor] = None):
    """Begin copying ``dev`` into (pinned) host memory; returns (host
    tensor, the event after the copy or None for a CPU tensor)."""
    if dev.device.type != "cuda":
        return (dev.detach().clone() if host is None else host.copy_(dev)), None
    if host is None:
        host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
    host.copy_(dev, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def fetch_chunked(dev: torch.Tensor, rows_per_chunk: int = 0, target_mb: int = 64) -> np.ndarray:
    """A large device array on the host, copied in axis-0 slices into one
    pinned buffer (every slice's copy queued before the first is waited
    for); the same bytes as a one-shot ``.cpu()``.  Arrays of at most one
    chunk take one copy."""
    n = dev.shape[0]
    if not rows_per_chunk:
        row_bytes = max(1, int(np.prod(dev.shape[1:], dtype=np.int64)) * dev.element_size())
        rows_per_chunk = max(1, int(target_mb * 2**20) // row_bytes)
    if dev.device.type != "cuda":
        return dev.detach().cpu().numpy().copy()
    host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
    event = None
    for i in range(0, n, rows_per_chunk):
        _, event = _start_copy(dev[i : i + rows_per_chunk], host[i : i + rows_per_chunk])
    if event is not None:
        event.synchronize()
    return host.numpy()


class DeferredFetch:
    """Pipelined device->host fetches for full-split inference loops.

    ``put(result, meta)`` starts the copy back and defers the wait until
    ``depth`` newer results are in flight, so the host's next batch, the
    card's compute and the copy back overlap.  ``results()`` waits for the
    rest and returns ``[(np.ndarray, meta), ...]`` in put order.  Used by
    the streaming eval path (``train/eval_loop.run_full_split``)."""

    def __init__(self, depth: int = 3):
        self.depth = max(0, depth)
        self._q: deque = deque()
        self._out: list = []

    def put(self, dev: torch.Tensor, meta=None) -> None:
        host, event = _start_copy(dev)
        self._q.append((host, event, meta))
        self._drain(self.depth)

    def _drain(self, limit: int) -> None:
        while len(self._q) > limit:
            host, event, meta = self._q.popleft()
            if event is not None:
                event.synchronize()
            self._out.append((host.numpy(), meta))

    def results(self):
        self._drain(0)
        return self._out


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


def make_vqa_dp_indexed_step(loss_fn: Callable, cfg, tx: GradientTransformation,
                             group: DPGroup):
    """One DP training step over host-sampled indices: ``step(params,
    opt_state, data, qinds, generator)`` with the store on every rank and
    the global (B,) index vector sharded: each rank gathers and trains on
    its slice, the gradient mean all-reduced over the group."""

    def step(params, opt_state, data, qinds, generator):
        batch = gather_batch(data, group.shard(qinds))
        return dp_update(loss_fn, cfg, tx, group, params, opt_state, batch, generator)

    return step


def make_vqa_dp_steps_scan(loss_fn: Callable, cfg, tx: GradientTransformation,
                           group: DPGroup, n_steps: int, batch_size: int):
    """``n_steps`` training iterations per call: ``steps(params, opt_state,
    data, generator) -> (params, opt_state, losses (n_steps,))``.  Each
    iteration samples the global (B,) index vector on the device (uniform
    with replacement, the reference's ``torch.random`` draw,
    002_train_baseline.lua:203), gathers this rank's slice of the batch
    from the resident store, and runs forward, backward and the update
    with the gradient mean all-reduced.  The JAX package scans this body in
    one dispatch; here it is a loop that never waits for the device: the
    indices and the dropout masks come from ``generator``, a generator on
    the store's device, and the losses stay there.  Every rank draws the
    same global indices (the same seed), so DP samples what one process
    samples."""
    group.check_divisible(batch_size)

    def steps(params, opt_state, data, generator):
        n = data["tokens"].shape[0]
        device = data["tokens"].device
        losses = []
        for _ in range(n_steps):
            with span("train.sample"):
                qinds = torch.randint(0, n, (batch_size,), generator=generator, device=device)
                batch = gather_batch(data, group.shard(qinds))
            params, opt_state, loss = dp_update(
                loss_fn, cfg, tx, group, params, opt_state, batch, generator)
            losses.append(loss)
        return params, opt_state, torch.stack(losses)

    return steps
