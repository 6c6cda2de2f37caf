"""Full-split inference loop (port of ``novel_vqa_tpu.train.eval_loop``).

Two data-movement strategies (reference loop 004_eval_model.lua:202-273):

* ``hbm_resident=True`` (default): the split store goes to the device once
  and the whole split runs through ``eval_predict_scan`` /
  ``eval_scores_scan``, batches gathered on the device;
* ``hbm_resident=False``: every batch is streamed host -> device (for stores
  larger than device memory) through ``arch.eval_step``; scores come back
  and the caller argmaxes on the host.

Both pad the final short batch with the split's LAST row, the row the
resident scan clamps to, so both run the same batches.  That matters for
arch2, whose encoder skips a step only when every row of the batch is null
there: a longer padding row would make the real rows run extra null steps.
(The JAX package's streaming path pads with row 0,
``novel_vqa_tpu/data/vqa.py:187-188``, and so differs from its own
resident path for arch2.)

``data_parallel`` comes with the multi-GPU slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _upload(store, device):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in store.items()}


def run_full_split(
    arch, cfg, params, data, split: str, batch_size: int, *,
    device, hbm_resident: bool = True, data_parallel: bool = False,
    want: str = "predict",
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], Optional[np.ndarray]]:
    """Forward one whole split on ``device``; returns ``(pred, mc_pred, scores)``.

    ``want='predict'``: pred/mc_pred are (n,) int64 1-indexed answer ids
    (argmax on the device) and ``scores`` is None.  ``want='scores'``: the
    full (n, num_output) float32 score matrix with pred/mc_pred None.  The
    streaming path only produces scores, so ``want='predict'`` raises
    there."""
    if data_parallel:
        raise NotImplementedError(
            "run_full_split(data_parallel=True): multi-GPU eval is ported "
            "with the multi-GPU slice (ROADMAP A13)"
        )
    if not hbm_resident and want == "predict":
        raise ValueError(
            "run_full_split: the streaming path (hbm_resident=False) only "
            "produces scores (arch.eval_step); pass want='scores' and "
            "argmax on host (models/vqa/predict.host_mc_predict)"
        )
    n = data.num_examples(split)

    if hbm_resident:
        store = _upload(data.split_store(split), device)
        n_batches = -(-n // batch_size)
        if want == "predict":
            _, pred_m, mc_m = arch.eval_predict_scan(
                cfg, params, store, n_batches, batch_size
            )
            pred = pred_m.reshape(-1)[:n].cpu().numpy().astype(np.int64)
            mc_pred = mc_m.reshape(-1)[:n].cpu().numpy().astype(np.int64)
            return pred, mc_pred, None
        _, scores_m = arch.eval_scores_scan(cfg, params, store, n_batches, batch_size)
        return None, None, scores_m.reshape(-1, scores_m.shape[-1])[:n].cpu().numpy()

    parts = []
    for batch in data.iter_split(split, batch_size):
        real = len(batch.question_id)
        arrays = (batch.tokens, batch.image, batch.labels)
        if real < batch_size:  # repeat the split's last row, as the scan clamps
            arrays = tuple(np.concatenate([a, np.repeat(a[-1:], batch_size - real, axis=0)])
                           for a in arrays)
        _, scores = arch.eval_step(cfg, params, *(torch.from_numpy(a).to(device) for a in arrays))
        parts.append(scores[:real])
    return None, None, torch.cat(parts).cpu().numpy()
