"""Token embedding (port of ``novel_vqa_tpu.ops.embedding``).

The reference's arch1 word embedding is ``one-hot(V) @ Linear(V, E)`` plus a
bias (002_train_vqa_arch1/002_train_baseline.lua:141-144): a row gather plus
the shared bias.  Tokens are 1-indexed with 0 = null; the index is clipped
to [0, V-1], so null tokens read row 0 and the caller masks them out.
"""

from __future__ import annotations

from typing import Optional

import torch


def embedding_lookup(
    table: torch.Tensor,  # (V, E): row v-1 holds the embedding of token v
    tokens: torch.Tensor,  # int tokens, 1-indexed, 0 = null
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    idx = torch.clamp(tokens.long() - 1, 0, table.shape[0] - 1)
    out = table[idx]
    if bias is not None:
        out = out + bias
    return out
