"""Full-split inference loop (port of ``novel_vqa_tpu.train.eval_loop``).

Two data-movement strategies (reference loop 004_eval_model.lua:202-273):

* ``hbm_resident=True`` (default): the split store goes to the device once
  and every batch is gathered there (``eval_predict_indexed`` /
  ``eval_step_indexed``, the bodies of ``eval_predict_scan`` /
  ``eval_scores_scan``), outputs kept on the device to the end;
* ``hbm_resident=False``: every batch is streamed host -> device (for stores
  larger than device memory) through ``arch.eval_step``; scores come back
  and the caller argmaxes on the host.

Both pad the final short batch with the split's LAST row, the row the
resident path clamps to, so both run the same batches.  That matters for
arch2, whose encoder skips a step only when every row of the batch is null
there: a longer padding row would make the real rows run extra null steps.
(The JAX package's streaming path pads with row 0,
``novel_vqa_tpu/data/vqa.py:187-188``, and so differs from its own
resident path for arch2.)

Both run through a ``parallel.mesh.DPGroup`` (one process without
``--data_parallel``): every rank holds the params (and, resident, the
store), forwards its slice of each batch and the outputs are gathered in
global row order (``make_dp_eval_indexed_step`` / ``make_dp_eval_step``).
Streamed results come back through ``parallel/dp.DeferredFetch``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from novel_vqa_torch.core.device import resolve_device
from novel_vqa_torch.core.profiling import span
from novel_vqa_torch.parallel.dp import DeferredFetch, fetch_chunked
from novel_vqa_torch.parallel.mesh import DPGroup, make_dp_eval_indexed_step, make_dp_eval_step


def _upload(store, device):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in store.items()}


def run_full_split(
    arch, cfg, params, data, split: str, batch_size: int, *,
    device="cuda", hbm_resident: bool = True, group: Optional[DPGroup] = None,
    want: str = "predict",
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], Optional[np.ndarray]]:
    """Forward one whole split on ``group`` (a caller without one gives
    ``device``: the group of one process there); returns ``(pred, mc_pred,
    scores)``.

    ``want='predict'``: pred/mc_pred are (n,) int64 1-indexed answer ids
    (argmax on the device) and ``scores`` is None.  ``want='scores'``: the
    full (n, num_output) float32 score matrix with pred/mc_pred None.  The
    streaming path only produces scores, so ``want='predict'`` raises
    there."""
    if not hbm_resident and want == "predict":
        raise ValueError(
            "run_full_split: the streaming path (hbm_resident=False) only "
            "produces scores (arch.eval_step); pass want='scores' and "
            "argmax on host (models/vqa/predict.host_mc_predict)"
        )
    if group is None:
        group = DPGroup(0, 1, resolve_device(device))
    device = group.device
    n = data.num_examples(split)

    if hbm_resident:
        fn = arch.eval_predict_indexed if want == "predict" else arch.eval_step_indexed
        step = make_dp_eval_indexed_step(cfg, group, fn)
        host_store = data.split_store(split)
        with span("eval.upload"):
            store = _upload(host_store, device)
        arange = torch.arange(batch_size, device=device)
        # the final batch repeats the last row; outputs stay on the device
        outs = [step(params, store, torch.clamp(start + arange, max=n - 1))[1:]
                for start in range(0, n, batch_size)]
        if want == "scores":
            return None, None, fetch_chunked(torch.cat([o[0] for o in outs])[:n])
        pred, mc_pred = (torch.cat([o[i] for o in outs])[:n].cpu().numpy().astype(np.int64)
                         for i in (0, 1))
        return pred, mc_pred, None

    step = make_dp_eval_step(cfg, group, arch.eval_step)
    fetch = DeferredFetch()
    for batch in data.iter_split(split, batch_size):
        real = len(batch.question_id)
        arrays = (batch.tokens, batch.image, batch.labels)
        if real < batch_size:  # repeat the split's last row, as the resident path
            arrays = tuple(np.concatenate([a, np.repeat(a[-1:], batch_size - real, axis=0)])
                           for a in arrays)
        _, scores = step(params, *(torch.from_numpy(a).to(device) for a in arrays))
        fetch.put(scores, real)
    return None, None, np.concatenate([s[:r] for s, r in fetch.results()])
