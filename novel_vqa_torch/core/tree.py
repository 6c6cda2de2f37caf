"""Nested params and optimizer states (the port's pytrees), and gradients
over them.

Params are dicts of tensors with lists for LSTM layers, in the JAX
package's layout; optimizer states are NamedTuples and tuples.  These
helpers play the part of ``jax.tree_util`` and ``jax.value_and_grad`` for
those structures, so the training code reads as the JAX package's does.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

from novel_vqa_torch.core.profiling import span


def _is_namedtuple(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure); dicts, lists, tuples and NamedTuples keep
    their types."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    leaves: List[Any] = []
    tree_map(leaves.append, tree)
    return leaves


def value_and_grad(fn: Callable) -> Callable:
    """``jax.value_and_grad`` for a scalar ``fn(params, *args, **kwargs)``:
    returns (value detached, grads in the structure of ``params``).  The
    caller's tensors are not touched: the graph is built on detached
    aliases.  A leaf ``fn`` does not reach (a frozen lookup, behind
    ``detach``) gets a zero gradient, as JAX gives it.  The forward and the
    backward are the tracer's ``train.forward`` and ``train.backward``."""

    def wrapped(params, *args, **kwargs) -> Tuple[torch.Tensor, Any]:
        with torch.enable_grad():
            live = tree_map(lambda p: p.detach().requires_grad_(), params)
            with span("train.forward"):
                value = fn(live, *args, **kwargs)
            leaves = tree_leaves(live)
            with span("train.backward"):
                grads = torch.autograd.grad(value, leaves, allow_unused=True)
        it = iter(torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves))
        return value.detach(), tree_map(lambda _: next(it), params)

    return wrapped
