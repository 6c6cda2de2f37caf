"""Training through the seq kernel: the port of the custom VJP of
``novel_vqa_tpu.ops.pallas_lstm`` (``_fused_lstm_seq``) and of
``pallas_lstm_encode_train``.

The forward is the kernel (``kernels/lstm.lstm_seq``), called from
``autograd.Function.forward``, where grad mode is off, so the wrapper's
``refuse_grad`` guard lets it through.  The backward is the JAX package's
(XLA code there, not Pallas): its large products are f32 ``torch.matmul``,
as the JAX package leaves them to XLA, and its reverse scan is one launch
of the seq backward kernel (``kernels/lstm.lstm_seq_backward``).  The
backward reads no value back to the host, and autograd runs it on the
stream the forward launched on.

The JAX package's step-kernel VJP (``_fused_lstm_step``, serving
``NOVEL_VQA_PALLAS=all``) is not ported: on an H100 that route gave the
default route's loss and was slower (PERF.md, Findings).

  * :class:`FusedSeq` (``_seq_fwd``/``_seq_bwd``, pallas_lstm.py:269-374):
    1. all gates recomputed in two (T*N)-row products from ``xs`` and the
       saved post-mask ``hs`` shifted by one step (at a masked step
       ``hs[t]`` equals ``h_{t-1}``, which the kernel and ``lstm_seq_plain``
       both keep);
    2. an elementwise forward scan rebuilds c, and
    3. a reverse scan with one (N, 4H) x (4H, H) product per step gives the
       gate derivatives: both in ``lstm_seq_backward``, over the
       pre-activations of step 1;
    4. dWx, dWh and dxs as single products over T*N.
  * :func:`seq_encode_train` (``pallas_lstm_encode_train``, :415-453): one
    :class:`FusedSeq` per layer, one (T, N, H) inter-layer dropout mask per
    layer boundary.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from novel_vqa_torch.kernels import lstm as kernels
from novel_vqa_torch.ops.dropout import dropout
from novel_vqa_torch.ops.lstm2 import _seq_mm


class FusedSeq(torch.autograd.Function):
    """``_fused_lstm_seq``: the seq kernel's (c, h, hs) of one masked layer
    from a zero state, and ``_seq_bwd``.  Takes ``b = bx + bh``; no
    gradient flows to ``mask``.  An output the caller leaves unused gets a
    zero cotangent (``ctx.set_materialize_grads``, on by default)."""

    @staticmethod
    def forward(ctx, xs, mask, wx, wh, b):
        xs, mask = xs.contiguous(), mask.contiguous()
        c, h, hs = kernels.lstm_seq(xs, mask, wx, wh, b)
        ctx.save_for_backward(xs, mask, wx, wh, b, hs)
        return c, h, hs

    @staticmethod
    def backward(ctx, dc_fin, dh_fin, dhs):
        xs, mask, wx, wh, b, hs = ctx.saved_tensors
        T, N, _ = xs.shape

        # 1. the gates from xs and h_{t-1}: zeros at t = 0, then the saved hs
        h_prev = torch.cat([hs.new_zeros(1, N, hs.shape[-1]), hs[:-1]])
        gates = _seq_mm(xs, wx) + _seq_mm(h_prev, wh) + b
        # 2-3. the rebuild of c and the reverse scan, over the gates
        dg = kernels.lstm_seq_backward(gates, mask, wh, dhs.contiguous(), dh_fin.contiguous(),
                                       dc_fin.contiguous()).reshape(T * N, -1)
        # 4. products over the (T*N) axis
        return ((dg @ wx.t()).reshape(T, N, -1), None,
                xs.reshape(T * N, -1).t() @ dg, h_prev.reshape(T * N, -1).t() @ dg, dg.sum(dim=0))


def seq_encode_train(
    layers: Sequence[Dict[str, torch.Tensor]],
    xs: torch.Tensor,  # (T, N, In) time-major, float32
    mask: torch.Tensor,  # (T, N)
    dropout_rate: float,
    generator: Optional[torch.Generator],
    dp=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training encode on the seq kernel: one :class:`FusedSeq` per layer,
    layer k+1 fed layer k's hidden sequence through one (T, N, H) dropout
    mask (on a DP group ``dp``, this rank's slice of the global batch's,
    as ``ops/lstm2.fused2_encode_train`` draws its multiplier).  Dropout
    is only between layers, never on the recurrence (misc/LSTM.lua:36-38),
    so each layer's recurrence is one launch.  The per-step route draws
    one (N, H) mask per step and layer instead: the same distribution, and
    on a CUDA generator other masks (a CPU generator lays consecutive
    draws end to end, so at two layers they coincide there).  Returns the
    stacked final (c, h), each (L, N, H)."""
    cs, hs_final = [], []
    inp = xs
    for li, layer in enumerate(layers):
        c, h, hs = FusedSeq.apply(inp, mask, layer["wx"], layer["wh"], layer["bx"] + layer["bh"])
        cs.append(c)
        hs_final.append(h)
        if li + 1 < len(layers):
            inp = dropout(hs, dropout_rate, generator, deterministic=False, dp=dp, axis=1)
    return torch.stack(cs), torch.stack(hs_final)
