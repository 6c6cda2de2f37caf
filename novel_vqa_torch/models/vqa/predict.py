"""Answer prediction for the full-split eval (port of
``novel_vqa_tpu.models.vqa.predict``).

The reference argmaxes on the host (004_eval_model.lua:250-255 OE; :258-273
MC argmax over the choices).  ``device_predict`` computes both predictions
next to the scores, so only two (B,) vectors leave the card;
``host_mc_predict`` is the host loop for the streaming path.  Both take the
FIRST maximal entry (``torch.argmax``, ``np.argmax``), as ``jnp.argmax``
does.
"""

from __future__ import annotations

import numpy as np
import torch


def device_predict(scores: torch.Tensor, choices: torch.Tensor | None = None):
    """OE + MC predictions from a (B, num_output) score matrix.

    ``choices``: optional (B, 18) int of 1-indexed MC answer ids, 0 = empty
    slot.  Returns ``(pred, mc_pred)``, both (B,) int32 1-indexed answer ids;
    ``mc_pred == pred`` when ``choices`` is None and for rows with no valid
    choice."""
    pred = (torch.argmax(scores, dim=1) + 1).to(torch.int32)
    if choices is None:
        return pred, pred
    choices = choices.long()
    valid = choices != 0
    ch_scores = torch.gather(scores, 1, torch.clamp(choices - 1, min=0))
    ch_scores = torch.where(valid, ch_scores, torch.full_like(ch_scores, -torch.inf))
    mc_idx = torch.argmax(ch_scores, dim=1)
    mc_pred = torch.gather(choices, 1, mc_idx[:, None])[:, 0]
    mc_pred = torch.where(valid.any(dim=1), mc_pred, pred.long()).to(torch.int32)
    return pred, mc_pred


def host_mc_predict(scores, mc_ans, pred):
    """Host-side MC argmax over the choices (004_eval_model.lua:258-273) for
    the streaming eval path.  ``mc_ans``: (n, 18) int of 1-indexed choice
    ids, 0 = empty slot; ``pred``: (n,) 1-indexed OE ids (the fallback for
    rows with no choice).  Returns (n,) int64 1-indexed MC answer ids."""
    out = np.empty(len(pred), dtype=np.int64)
    for i in range(len(pred)):
        choices = mc_ans[i]
        valid = choices[choices != 0].astype(np.int64)
        out[i] = (
            int(valid[np.argmax(scores[i, valid - 1])])
            if valid.size
            else int(pred[i])
        )
    return out
