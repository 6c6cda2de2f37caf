"""Reference-exact optimizer pieces for arch1 (port of the arch1 half of
``novel_vqa_tpu.ops.optim``).

Torch ``optim.rmsprop`` as the VQA trainers use it
(002_train_vqa_arch1/002_train_baseline.lua:408), the element-wise gradient
clamp (:329), the per-parameter gradient scale of the wp variant
(003_train_ae_based_wp.lua:344) and the per-iteration lr decay (:410).
None of these is ``torch.optim``'s: rmsprop adds eps *after* the sqrt,
``x -= lr * g / (sqrt(m) + eps)``.

Each piece is a :class:`GradientTransformation` (``init(params) -> state``,
``update(grads, state, params) -> (updates, state)``) and :func:`chain`
composes them as ``optax.chain`` does, its state a tuple of the pieces'
states.  The states are NamedTuples with the JAX package's names and
fields (``EmptyState``, ``MomentState(count, m)``), so a state flattens to
the same npz keys (``opt_state/1/count``, ``opt_state/1/m/...``) and
``--resume`` files cross between the packages.  Updates are new tensors:
nothing is changed in place.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from novel_vqa_torch.core.tree import tree_leaves, tree_map

Schedule = Callable[[torch.Tensor], torch.Tensor]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


class EmptyState(NamedTuple):
    pass


class MomentState(NamedTuple):
    count: torch.Tensor
    m: Any


def rmsprop(lr: Schedule, alpha: float = 0.99, epsilon: float = 1e-8) -> GradientTransformation:
    """optim_updates.lua:60-76 / Torch optim.rmsprop:
    m = a*m + (1-a)*g*g; x -= lr * g/(sqrt(m)+eps).  ``count`` is an int32
    scalar on the params' device; ``lr(count)`` the step's lr.  (The JAX
    package's weight-decay term is for arch2, which is not ported yet.)"""

    def init(params):
        count = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
        return MomentState(count=count, m=tree_map(torch.zeros_like, params))

    def update(grads, state, params=None):
        step_lr = lr(state.count)
        new_m = tree_map(lambda m, g: alpha * m + (1.0 - alpha) * g * g, state.m, grads)
        upd = tree_map(lambda m, g: -step_lr * (g / (torch.sqrt(m) + epsilon)), new_m, grads)
        return upd, MomentState(count=state.count + 1, m=new_m)

    return GradientTransformation(init, update)


def clamp(limit: float) -> GradientTransformation:
    """Element-wise gradient clamp to [-limit, limit]: the reference clamps
    gradients, not their global norm (002_train_baseline.lua:329)."""

    def update(grads, state, params=None):
        return tree_map(lambda g: torch.clamp(g, -limit, limit), grads), state

    return GradientTransformation(lambda params: EmptyState(), update)


def scale_by_tree(scales) -> GradientTransformation:
    """Gradients times a tree of scalar factors matching the params: the
    reference's ``-lr_scale`` on the encoder and embedding blocks, before
    the clamp (003_train_ae_based_wp.lua:344)."""

    def update(grads, state, params=None):
        return tree_map(lambda g, s: g * s, grads, scales), state

    return GradientTransformation(lambda params: EmptyState(), update)


def exponential_decay_schedule(lr0: float, decay_factor: float) -> Schedule:
    """Iteration k uses lr0 * d^k, in float32 as the JAX package computes
    it (``optimize.learningRate * decay_factor`` after every step,
    002_train_baseline.lua:410, d = 0.99997592083).  The base stays a
    Python scalar: a tensor made from it on the card would be a blocking
    host-to-device copy in every step."""

    def sched(count: torch.Tensor) -> torch.Tensor:
        return lr0 * torch.pow(decay_factor, count.to(torch.float32))

    return sched


def chain(*txs: GradientTransformation) -> GradientTransformation:
    """Apply ``txs`` in order (``optax.chain``); the state is the tuple of
    their states."""

    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(grads, state, params=None):
        new_state = []
        for tx, s in zip(txs, state):
            grads, s = tx.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


def apply_updates(params, updates):
    """``optax.apply_updates``: params + updates, as new tensors."""
    return tree_map(lambda p, u: p + u, params, updates)
