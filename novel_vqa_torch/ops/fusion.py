"""Multimodal fusion blocks AxB, AskipB, A_B, forward only.

Port of ``novel_vqa_tpu.ops.fusion`` (002_train_vqa_arch1/misc/netdef.lua):

    AxB    (netdef.lua:6-14):  tanh(Wq·q) * tanh(Wi·i)
    AskipB (netdef.lua:16-25): qc + qc*ic
    A_B    (netdef.lua:27-35): concat(qc, ic)

Weights are stored (in_features, out_features).  The two projections are
plain ``torch.matmul`` calls, as the JAX package leaves them to XLA.  The
dropout of training mode comes with the training slice.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

AxBParams = Dict[str, torch.Tensor]  # {"wq", "bq", "wi", "bi"}


def _projections(
    params: AxBParams, q: torch.Tensor, i: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    qc = torch.tanh(torch.matmul(q, params["wq"]) + params["bq"])
    ic = torch.tanh(torch.matmul(i, params["wi"]) + params["bi"])
    return qc, ic


def axb_apply(params: AxBParams, q: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    qc, ic = _projections(params, q, i)
    return qc * ic


def askipb_apply(params: AxBParams, q: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    qc, ic = _projections(params, q, i)
    return qc + qc * ic


def a_b_apply(params: AxBParams, q: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    qc, ic = _projections(params, q, i)
    return torch.cat([qc, ic], dim=-1)
