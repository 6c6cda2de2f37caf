"""bf16 mixed precision: products with an f32 result, and the compute cast.

The JAX package's mixed precision (``compute_dtype="bfloat16"`` of arch1
and the autoencoders) casts the f32 leaves of the params tree and the
float inputs to bf16 inside the step (:func:`cast_compute`; the masters
stay f32 and the cast's backward carries the gradients back to f32), and
takes every product as ``jnp.dot(a, b, preferred_element_type=float32)``
(:func:`dot_f32`): bf16 operands, an f32 result.

:func:`dot_f32` follows ``jnp.dot``'s promotion:
  * f32 with f32 is ``torch.matmul``, so the f32 routes are unchanged;
  * bf16 with bf16 multiplies exactly (a bf16 product fits f32) and
    accumulates in f32.  On a CUDA tensor that is one cuBLAS call with an
    f32 output, ``torch.mm(a, b, out_dtype=torch.float32)``; on a CPU
    tensor the operands are widened to f32 and multiplied there (the
    CPU's PyTorch has no ``mm.dtype``).  Torch's own ``a @ b`` on bf16
    rounds the result to bf16, which is not JAX's route;
  * bf16 with f32 widens the bf16 side, an f32 product (JAX promotes).
The backward is JAX's transpose of that dot: the f32 cotangent times the
other operand widened to f32, an f32 product, rounded to the operand's
dtype (a bf16 operand's gradient is bf16).
"""

from __future__ import annotations

from typing import Any

import torch

from novel_vqa_torch.core.tree import tree_map

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """``compute_dtype`` of a config -> the torch dtype; unknown names raise."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype={name!r}: must be 'float32' or 'bfloat16'")
    return COMPUTE_DTYPES[name]


def cast_compute(tree: Any, dtype: torch.dtype) -> Any:
    """The f32 leaves of ``tree`` in ``dtype`` (others as they are); a
    no-op for f32."""
    if dtype == torch.float32:
        return tree
    return tree_map(
        lambda a: a.to(dtype) if a is not None and a.dtype == torch.float32 else a, tree)


def _bf16_product(a2: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) x (K, N) bf16 -> f32: exact products, f32 accumulation."""
    if a2.is_cuda:
        return torch.mm(a2, b, out_dtype=torch.float32)
    return torch.mm(a2.float(), b.float())


class _DotBF16(torch.autograd.Function):
    """bf16 x bf16 -> f32 with JAX's backward (``mm.dtype`` has none)."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        return _bf16_product(a.reshape(-1, a.shape[-1]), b).reshape(*a.shape[:-1], b.shape[-1])

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, b = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).float()
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.mm(g2, b.float().t()).to(a.dtype).reshape(a.shape)
        if ctx.needs_input_grad[1]:
            gb = torch.mm(a.reshape(-1, a.shape[-1]).float().t(), g2).to(b.dtype)
        return ga, gb


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.dot(a, b, preferred_element_type=jnp.float32)`` for ``a``
    (..., K) and ``b`` (K, N): an f32 result."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16:
        return _DotBF16.apply(a, b)
    return torch.matmul(a.float(), b.float())
