"""Row-wise L2 normalization (port of ``novel_vqa_tpu.ops.l2norm``).

Reference: 001_train_autoencoder/misc/L2Normalize.lua:10-40 (forward
x/||x||, backward through an explicit Jacobian; autograd of the forward
gives the same vector-Jacobian product).  The eps is added to the norm, not
under the root: ``eps=0.0`` divides by the raw norm, as
002_train_vqa_arch1/002_train_baseline.lua:117-123 does.
"""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / (norm + eps)
