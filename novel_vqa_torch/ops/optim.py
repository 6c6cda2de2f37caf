"""Reference-exact optimizers (port of ``novel_vqa_tpu.ops.optim``).

The updates of 001_train_autoencoder/misc/optim_updates.lua (sgd :4-9, sgdm
:12-24, sgdmom :26-40, adagrad :42-57, rmsprop :60-76, adam :78-111), Torch
``optim.rmsprop`` as the VQA trainers use it
(002_train_vqa_arch1/002_train_baseline.lua:408; arch2 folds a weight-decay
term into the gradient, 003_train_ae_based.lua ``optimize.weightDecay``),
the element-wise gradient clamp (:329), the AE trainers' decayed weights
(001_train_arch1_text_autoencoder.lua:240-243), the per-parameter gradient
scale of the wp variant (003_train_ae_based_wp.lua:344) and the lr
schedules.  None of these is ``torch.optim``'s:
  * rmsprop/adagrad/adam add eps *after* the sqrt, ``x -= lr * g /
    (sqrt(m) + eps)``;
  * adam folds the bias correction into the step size, ``step = lr *
    sqrt(1 - b2^t) / (1 - b1^t)``;
  * sgdmom is the Nesterov form ``x += -a*m_prev + (1+a)*m_new`` with
    ``m_new = a*m - lr*g``.

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


class ScalarState(NamedTuple):
    count: torch.Tensor


class MomentState(NamedTuple):
    count: torch.Tensor
    m: Any


class AdamState(NamedTuple):
    count: torch.Tensor
    m: Any
    v: Any


def _as_schedule(lr) -> Schedule:
    """A schedule as given, or a constant one for a number."""
    if callable(lr):
        return lr
    return lambda count: torch.full((), lr, dtype=torch.float32, device=count.device)


def _count(params) -> torch.Tensor:
    """The step counter: an int32 scalar on the params' device."""
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


def _moment_init(params) -> MomentState:
    return MomentState(count=_count(params), m=tree_map(torch.zeros_like, params))


def sgd(lr) -> GradientTransformation:
    """optim_updates.lua:4-9: x += -lr * g."""
    sched = _as_schedule(lr)

    def update(grads, state, params=None):
        step_lr = sched(state.count)
        return tree_map(lambda g: -step_lr * g, grads), ScalarState(count=state.count + 1)

    return GradientTransformation(lambda params: ScalarState(count=_count(params)), update)


def sgdm(lr, alpha: float) -> GradientTransformation:
    """optim_updates.lua:12-24: v = a*v + lr*g; x -= v."""
    sched = _as_schedule(lr)

    def update(grads, state, params=None):
        step_lr = sched(state.count)
        new_m = tree_map(lambda v, g: alpha * v + step_lr * g, state.m, grads)
        return tree_map(lambda v: -v, new_m), MomentState(count=state.count + 1, m=new_m)

    return GradientTransformation(_moment_init, update)


def sgdmom(lr, alpha: float) -> GradientTransformation:
    """optim_updates.lua:26-40 (Nesterov): m' = a*m - lr*g;
    x += -a*m + (1+a)*m'."""
    sched = _as_schedule(lr)

    def update(grads, state, params=None):
        step_lr = sched(state.count)
        new_m = tree_map(lambda m, g: alpha * m - step_lr * g, state.m, grads)
        upd = tree_map(lambda m_old, m_new: -alpha * m_old + (1.0 + alpha) * m_new, state.m, new_m)
        return upd, MomentState(count=state.count + 1, m=new_m)

    return GradientTransformation(_moment_init, update)


def adagrad(lr, epsilon: float) -> GradientTransformation:
    """optim_updates.lua:42-57: m += g*g; x -= lr * g/(sqrt(m)+eps)."""
    sched = _as_schedule(lr)

    def update(grads, state, params=None):
        step_lr = sched(state.count)
        new_m = tree_map(lambda m, g: m + g * g, state.m, grads)
        upd = tree_map(lambda m, g: -step_lr * (g / (torch.sqrt(m) + epsilon)), new_m, grads)
        return upd, MomentState(count=state.count + 1, m=new_m)

    return GradientTransformation(_moment_init, update)


def rmsprop(lr, alpha: float = 0.99, epsilon: float = 1e-8) -> GradientTransformation:
    """optim_updates.lua:60-76 / Torch optim.rmsprop:
    m = a*m + (1-a)*g*g; x -= lr * g/(sqrt(m)+eps).  ``lr`` is a number or
    a schedule, ``lr(count)`` the step's lr.  arch2's weight decay is
    :func:`add_decayed_weights` chained before it."""
    sched = _as_schedule(lr)

    def update(grads, state, params=None):
        step_lr = sched(state.count)
        new_m = tree_map(lambda m, g: alpha * m + (1.0 - alpha) * g * g, state.m, grads)
        upd = tree_map(lambda m, g: -step_lr * (g / (torch.sqrt(m) + epsilon)), new_m, grads)
        return upd, MomentState(count=state.count + 1, m=new_m)

    return GradientTransformation(_moment_init, update)


def adam(lr, beta1: float = 0.9, beta2: float = 0.999, epsilon: float = 1e-8) -> GradientTransformation:
    """optim_updates.lua:78-111: the bias correction folded into the step
    size, eps after the sqrt."""
    sched = _as_schedule(lr)

    def init(params):
        return AdamState(count=_count(params), m=tree_map(torch.zeros_like, params),
                         v=tree_map(torch.zeros_like, params))

    def update(grads, state, params=None):
        t = state.count + 1
        step_lr = sched(state.count)
        new_m = tree_map(lambda m, g: beta1 * m + (1.0 - beta1) * g, state.m, grads)
        new_v = tree_map(lambda v, g: beta2 * v + (1.0 - beta2) * g * g, state.v, grads)
        tf = t.to(torch.float32)
        step = step_lr * torch.sqrt(1.0 - torch.pow(beta2, tf)) / (1.0 - torch.pow(beta1, tf))
        upd = tree_map(lambda m, v: -step * (m / (torch.sqrt(v) + epsilon)), new_m, new_v)
        return upd, AdamState(count=t, m=new_m, v=new_v)

    return GradientTransformation(init, update)


def clamp(limit: float) -> GradientTransformation:
    """Element-wise gradient clamp to [-limit, limit]: the reference clamps
    gradients, not their global norm (002_train_baseline.lua:329)."""

    def update(grads, state, params=None):
        return tree_map(lambda g: torch.clamp(g, -limit, limit), grads), state

    return GradientTransformation(lambda params: EmptyState(), update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    """g += wd * x, which the AE trainers apply after clipping
    (001_train_arch1_text_autoencoder.lua:240-243)."""

    def update(grads, state, params=None):
        return tree_map(lambda g, p: g + weight_decay * p, grads, params), state

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


def half_life_schedule(lr0: float, decay_start: int, decay_every: int) -> Schedule:
    """The AE trainers' lr half-life (001_train_arch1_text_autoencoder.lua:
    341-346): past ``decay_start``, lr0 * 0.5^((count - decay_start) /
    decay_every) with a continuous exponent; ``decay_start < 0`` keeps lr0."""

    def sched(count: torch.Tensor) -> torch.Tensor:
        on = count > decay_start if decay_start >= 0 else torch.zeros_like(count, dtype=torch.bool)
        frac = torch.where(on, (count.to(torch.float32) - decay_start) / decay_every,
                           torch.zeros((), dtype=torch.float32, device=count.device))
        return lr0 * torch.pow(0.5, frac)

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
