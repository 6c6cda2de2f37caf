"""The data-parallel process group and the DP step factories (port of
``novel_vqa_tpu.parallel.mesh``).

The reference is strictly single-GPU (``-gpuid``,
002_train_vqa_arch1/002_train_baseline.lua:57-63).  The JAX package scales
by batch data parallelism over a 1-D mesh: params and optimizer state
replicated, batches sharded on axis ``"data"``, the gradient mean
all-reduced by GSPMD.  Here the mesh is a ``torch.distributed`` process
group, one process per card (``torchrun``), and what GSPMD inserts is
written out:

* a replicated tree is broadcast from rank 0 once, at start
  (``DPGroup.broadcast_tree``);
* a batch-sharded array is this rank's contiguous slice of the global
  batch (``DPGroup.shard``: rank r holds rows [r*B/W, (r+1)*B/W));
* after the backward the gradients are all-reduced (one flat buffer per
  dtype) before ``tx.update``, so the clamp and the lr schedule act on the
  reduced gradient, as on one device;
* eval outputs are all-gathered in rank order, so a batch comes back whole
  and in global row order.

Three things in the models span the batch and see the group through the
``dp`` argument they take: the autoencoder encoder's can_skip (``(seq !=
0).any(dim=1)``, ``models/seq/autoencoder.encode``, all-reduced), the masked
sequence NLL's count of scored tokens (``decode_teacher_forced_nll``: each
rank divides its own sum by the global count, and the gradients are summed,
``reduce="sum"``, rather than averaged) and the dropout masks (drawn at the
global batch's shape from a generator every rank seeds alike, this rank's
slice taken, ``ops/dropout.py``).  So DP computes what one process computes,
dropout included.

:func:`make_mesh` joins the group:
  * under ``torchrun`` (``WORLD_SIZE`` set): ``env://``, NCCL on
    ``cuda:LOCAL_RANK`` (``torch.cuda.set_device`` first), or gloo when the
    caller asks for the CPU; a world larger than the visible cards raises;
  * in a process that already joined a group (the tests' gloo groups on a
    ``FileStore``): that group;
  * otherwise: one process, no group, every collective the identity.
A CLI always runs through a group: without ``--data_parallel`` it is that
one-process group (:func:`cli_group`).
Nothing falls back to the CPU: asking for ``cuda`` without a card raises
(``core/device.resolve_device``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from novel_vqa_torch.core.device import resolve_device
from novel_vqa_torch.core.profiling import span
from novel_vqa_torch.core.tree import tree_leaves, tree_map, value_and_grad
from novel_vqa_torch.ops.optim import GradientTransformation, apply_updates


@dataclasses.dataclass(frozen=True)
class DPGroup:
    """One process's place in the data-parallel group: its rank, the world
    size, its device and the backend (``None``: one process, no group)."""

    rank: int
    world_size: int
    device: torch.device
    backend: Optional[str] = None
    owns_group: bool = False

    @property
    def is_writer(self) -> bool:
        """Only rank 0 writes checkpoints, h5 files and JSON files."""
        return self.rank == 0

    def check_divisible(self, batch_size: int, what: str = "batch_size") -> None:
        if batch_size % self.world_size:
            raise ValueError(
                f"--data_parallel: {what} {batch_size} not divisible by the "
                f"group's {self.world_size} processes"
            )

    def shard(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's contiguous slice of ``x`` along ``dim``."""
        n = x.shape[dim]
        self.check_divisible(n, f"axis {dim} of size")
        per = n // self.world_size
        return x.narrow(dim, self.rank * per, per)

    # -- collectives (the identity without a group) -------------------------
    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of ``t`` over the group (a new tensor)."""
        out = t.clone()
        if self.backend is not None:
            dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    def any(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise OR of a bool tensor over the group."""
        if self.backend is None:
            return t
        out = t.to(torch.int32)
        dist.all_reduce(out, op=dist.ReduceOp.MAX)
        return out > 0

    def reduce_tree(self, tree: Any, op: str = "mean") -> Any:
        """Sum (``op="sum"``) or mean (``"mean"``) of every leaf over the
        group: one all-reduce per dtype over the leaves laid end to end."""
        if op not in ("sum", "mean"):
            raise ValueError(f"reduce op {op!r}: 'sum' or 'mean'")
        if self.backend is None:
            return tree
        leaves = tree_leaves(tree)
        out = list(leaves)
        by_dtype: dict = {}
        for i, leaf in enumerate(leaves):
            by_dtype.setdefault(leaf.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([leaves[i].reshape(-1) for i in idx])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM)
            if op == "mean":
                flat = flat / self.world_size
            for i, piece in zip(idx, flat.split([leaves[i].numel() for i in idx])):
                out[i] = piece.view(leaves[i].shape)
        it = iter(out)
        return tree_map(lambda _: next(it), tree)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along axis 0, in rank order."""
        if self.backend is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.world_size)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts)

    def broadcast_tree(self, tree: Any) -> Any:
        """Rank 0's leaves on every rank (in place; returns ``tree``)."""
        if self.backend is not None:
            for leaf in tree_leaves(tree):
                dist.broadcast(leaf, src=0)
        return tree

    def barrier(self) -> None:
        if self.backend is not None:
            dist.barrier()

    def close(self) -> None:
        """Leave the group this process joined, so that the next process
        on its card starts clean; a group the caller made stays."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()


def make_mesh(device: str | torch.device = "cuda") -> DPGroup:
    """Join the data-parallel group (see the module docstring)."""
    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        backend = dist.get_backend()
        if (backend == "gloo") != (dev.type == "cpu"):
            raise RuntimeError(
                f"--data_parallel: this process's {backend} group cannot run on "
                f"{str(device)!r}: gloo is for --device cpu, NCCL for the card"
            )
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        return DPGroup(dist.get_rank(), dist.get_world_size(), dev, backend)
    if "WORLD_SIZE" not in os.environ:
        return DPGroup(0, 1, dev)
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise RuntimeError(
                f"--data_parallel: {local_world} processes on this host but only "
                f"{cards} visible card(s); one process per card"
            )
        torch.cuda.set_device(local_rank)
        dev = torch.device("cuda", local_rank)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    return DPGroup(rank, world, dev, backend, owns_group=True)


def dp_update(loss_fn: Callable, cfg, tx: GradientTransformation, group: DPGroup,
              params, opt_state, batch, generator, reduce: str = "mean"):
    """Forward and backward on this rank's ``batch``, the loss and the
    gradients reduced over the group (``reduce``: see
    :func:`make_dp_train_step`), then ``tx.update``: the clamp and the lr
    schedule act on the reduced gradient, as on one device.  The tracer's
    spans: ``train.forward`` and ``train.backward`` (``core/tree``),
    ``train.reduce``, ``train.update``."""
    loss, grads = value_and_grad(loss_fn)(params, cfg, *batch, generator, dp=group)
    with span("train.reduce"):
        loss, grads = group.reduce_tree((loss, grads), reduce)
    with span("train.update"):
        updates, opt_state = tx.update(grads, opt_state, params)
        params = apply_updates(params, updates)
    return params, opt_state, loss


def make_dp_train_step(
    cfg,
    tx: GradientTransformation,
    group: DPGroup,
    loss_fn: Callable,
    batch_specs: Optional[Sequence[int]] = None,
    reduce: str = "mean",
):
    """A DP train step for ``loss_fn(params, cfg, *batch, generator, dp=)``.

    ``step(params, opt_state, generator, *batch)`` takes the GLOBAL batch,
    shards each array on its axis in ``batch_specs`` (default: the leading
    axis of each; time-major sequence batches pass 1), runs the loss on
    this rank's rows and reduces the gradients and the loss over the group
    before ``tx.update``: ``reduce="mean"`` for a loss that is a plain mean
    over equal shards (cross-entropy), ``"sum"`` for one that ``dp``
    already normalizes by a global count (the sequence NLL)."""

    def step(params, opt_state, generator, *batch):
        specs = batch_specs if batch_specs is not None else (0,) * len(batch)
        local = tuple(group.shard(b, axis) for b, axis in zip(batch, specs))
        return dp_update(loss_fn, cfg, tx, group, params, opt_state, local, generator, reduce)

    return step


def _gather_outputs(group: DPGroup, out):
    """Eval outputs back to whole batches: 0-d values (losses, means over
    equal shards) averaged over the group, arrays gathered in rank order."""
    if isinstance(out, tuple):
        return tuple(_gather_outputs(group, o) for o in out)
    if out.dim() == 0:
        return group.reduce_tree(out, "mean")
    return group.gather(out)


def make_dp_eval_step(cfg, group: DPGroup, eval_fn: Callable, n_batch_args: int = 3):
    """Batch-sharded DP inference forward, the eval-side mirror of
    :func:`make_dp_train_step` (reference workloads: full-split forwards in
    004_eval_model.lua:202-231 and the LF score precompute,
    003_compute_lf_answers.lua:373-482).

    ``eval_fn(cfg, params, *batch, dp=)`` (the ``arch{1,2}.eval_step``
    contract); ``step(params, *batch)`` takes the global batch, forwards
    this rank's rows and returns the outputs gathered in global row order,
    so the caller's sequential assembly is the single-device path's."""

    def step(params, *batch):
        if len(batch) != n_batch_args:
            raise ValueError(f"expected {n_batch_args} batch arrays, got {len(batch)}")
        local = tuple(group.shard(b) for b in batch)
        return _gather_outputs(group, eval_fn(cfg, params, *local, dp=group))

    return step


def make_dp_eval_indexed_step(cfg, group: DPGroup, eval_indexed_fn: Callable):
    """DP variant of the device-resident eval forward
    (``arch{1,2}.eval_step_indexed`` / ``eval_predict_indexed``): params and
    the split store on every rank, the global (B,) index vector sharded,
    each rank gathering and forwarding its rows; outputs gathered in
    global row order."""

    def step(params, data, qinds):
        out = eval_indexed_fn(cfg, params, data, group.shard(qinds), dp=group)
        return _gather_outputs(group, out)

    return step


def cli_group(data_parallel: int, device: str, batch_size: int) -> DPGroup:
    """A CLI's group: for ``--data_parallel 0`` one process on ``device``
    (every collective the identity), for 1 the joined group, checked to
    divide ``batch_size`` before the CLI reads any data."""
    if not data_parallel:
        return DPGroup(0, 1, resolve_device(device))
    group = make_mesh(device)
    try:
        group.check_divisible(batch_size)
    except ValueError:
        group.close()
        raise
    return group
