"""Multimodal fusion blocks AxB, AskipB, A_B.

Port of ``novel_vqa_tpu.ops.fusion`` (002_train_vqa_arch1/misc/netdef.lua):

    AxB    (netdef.lua:6-14):  tanh(Wq·drop(q)) * tanh(Wi·drop(i))
    AskipB (netdef.lua:16-25): qc + qc*ic
    A_B    (netdef.lua:27-35): concat(qc, ic)

Weights are stored (in_features, out_features).  The two projections are
plain products with an f32 result (``ops/precision.dot_f32``: bf16
inputs give f32 ``qc``, ``ic``), as the JAX package leaves them to XLA.  In
training mode (``deterministic=False`` with a generator) both projection
inputs go through dropout.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from novel_vqa_torch.ops.dropout import dropout
from novel_vqa_torch.ops.precision import dot_f32

AxBParams = Dict[str, torch.Tensor]  # {"wq", "bq", "wi", "bi"}


def _projections(
    params: AxBParams,
    q: torch.Tensor,
    i: torch.Tensor,
    rate: float,
    generator: Optional[torch.Generator],
    deterministic: bool,
    dp=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    if generator is not None and not deterministic and rate > 0.0:
        q = dropout(q, rate, generator, deterministic=False, dp=dp)
        i = dropout(i, rate, generator, deterministic=False, dp=dp)
    qc = torch.tanh(dot_f32(q, params["wq"]) + params["bq"])
    ic = torch.tanh(dot_f32(i, params["wi"]) + params["bi"])
    return qc, ic


def axb_apply(
    params: AxBParams,
    q: torch.Tensor,
    i: torch.Tensor,
    *,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    dp=None,
) -> torch.Tensor:
    qc, ic = _projections(params, q, i, dropout_rate, generator, deterministic, dp)
    return qc * ic


def askipb_apply(
    params: AxBParams,
    q: torch.Tensor,
    i: torch.Tensor,
    *,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    dp=None,
) -> torch.Tensor:
    qc, ic = _projections(params, q, i, dropout_rate, generator, deterministic, dp)
    return qc + qc * ic


def a_b_apply(
    params: AxBParams,
    q: torch.Tensor,
    i: torch.Tensor,
    *,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    dp=None,
) -> torch.Tensor:
    qc, ic = _projections(params, q, i, dropout_rate, generator, deterministic, dp)
    return torch.cat([qc, ic], dim=-1)
