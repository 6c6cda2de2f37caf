"""Fused 2-layer full-sequence LSTM training encode: the port of
``novel_vqa_tpu.ops.pallas_lstm2``.

The forward is the seq2 kernel (``kernels/lstm2.lstm_seq2``: both layers'
recurrences in one launch, bf16 storage, f32 carries).  The backward is a
plain-PyTorch port of ``_fused2_bwd`` (pallas_lstm2.py:227-330):

  1. both layers' gate pre-activations recomputed in whole-sequence products
     from the saved bf16 hidden states, the same operands the forward used;
  2. elementwise scans rebuild both cell-state sequences (``_rebuild_c``);
  3. a reverse pass carries (dh, dc) for both layers.  The JAX package runs
     it as a wavefront (layer-2 step t-1 beside layer-1 step t) for the
     TPU's matrix unit; here layer-2 step t runs right before layer-1 step
     t, which computes the same numbers;
  4. dWx/dWh/db/dxs as single products over the (T*N) axis.

Every product takes bf16-rounded operands in float32 (the JAX package's
``preferred_element_type=f32``): a bf16 ``torch.matmul`` would round its
output to bf16.  Large products outside the kernel go to ``torch.matmul``,
as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from novel_vqa_torch.kernels.lstm import gate_activations
from novel_vqa_torch.kernels.lstm2 import lstm_seq2
from novel_vqa_torch.ops.dropout import dropout

F32, BF16 = torch.float32, torch.bfloat16


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 -> f32: both operands widened (exactly), then an f32
    product, so the output keeps f32 precision."""
    return torch.matmul(a.to(F32), b.to(F32))


def _seq_mm(seq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(T, N, K) @ (K, M) -> (T, N, M) in f32 (``einsum('tnk,km->tnm')``)."""
    T, N, K = seq.shape
    return _mm(seq.reshape(T * N, K), w).reshape(T, N, -1)


def _rebuild_c(i, f, g, m):
    """Forward scan: per-step pre-mask candidate c_new and the post-mask
    c_{t-1} (pallas_lstm2.py:185-198)."""
    c_prev = torch.zeros_like(i[0])
    c_new_seq, c_prev_seq = [], []
    for t in range(i.shape[0]):
        c_new = f[t] * c_prev + i[t] * g[t]
        c_new_seq.append(c_new)
        c_prev_seq.append(c_prev)
        c_prev = torch.where(m[t] > 0, c_new, c_prev)
    return torch.stack(c_new_seq), torch.stack(c_prev_seq)


def _layer_reverse_step(dh_in, dh_carry, dc_carry, i_t, f_t, o_t, g_t,
                        c_prev, tanh_ct, m_t):
    """One masked reverse LSTM step (pallas_lstm2.py:201-224): returns
    (dgates_t, dh_passthrough, dc_prev)."""
    dh_t = dh_in + dh_carry
    dc_t = dc_carry
    dh_new = m_t * dh_t
    dc_new = m_t * dc_t + dh_new * o_t * (1.0 - tanh_ct * tanh_ct)
    do = dh_new * tanh_ct
    di = dc_new * g_t
    df = dc_new * c_prev
    dg = dc_new * i_t
    dgates_t = torch.cat(
        [
            di * i_t * (1.0 - i_t),
            df * f_t * (1.0 - f_t),
            do * o_t * (1.0 - o_t),
            dg * (1.0 - g_t * g_t),
        ],
        dim=-1,
    )
    dh_pass = (1.0 - m_t) * dh_t
    dc_prev = dc_new * f_t + (1.0 - m_t) * dc_t
    return dgates_t, dh_pass, dc_prev


class Fused2(torch.autograd.Function):
    """``_fused2`` (pallas_lstm2.py:171-182): the seq2 kernel forward,
    returning the final (c1, h1, c2, h2), and the written-out backward.
    Inputs as ``kernels/lstm2.lstm_seq2`` takes them (bf16 storage, f32
    mask); no gradient flows to ``mask`` or ``drop``."""

    @staticmethod
    def forward(ctx, xs, mask, drop, wx1, wh1, b1, wx2, wh2, b2):
        args = [t.contiguous() for t in (xs, mask, drop, wx1, wh1, b1, wx2, wh2, b2)]
        c1, h1, c2, h2, hs1, hs2 = lstm_seq2(*args)
        ctx.save_for_backward(*args, hs1, hs2)
        return c1, h1, c2, h2

    @staticmethod
    def backward(ctx, dc1_fin, dh1_fin, dc2_fin, dh2_fin):
        xs, mask, drop, wx1, wh1, b1, wx2, wh2, b2, hs1, hs2 = ctx.saved_tensors
        T, N, _ = xs.shape
        H = wh1.shape[0]
        m = mask[..., None].to(F32)  # (T, N, 1)
        drop_f = drop.to(F32)

        # 1. gate recomputation from the same bf16 operands as the forward
        z = hs1.new_zeros(1, N, H)
        h1_prev = torch.cat([z, hs1[:-1]])
        h2_prev = torch.cat([z, hs2[:-1]])
        d1 = (hs1.to(F32) * drop_f).to(BF16)  # layer-2 inputs
        gates1 = _seq_mm(xs, wx1) + _seq_mm(h1_prev, wh1) + b1.to(F32)
        gates2 = _seq_mm(d1, wx2) + _seq_mm(h2_prev, wh2) + b2.to(F32)
        i1, f1, o1, g1 = gate_activations(gates1)
        i2, f2, o2, g2 = gate_activations(gates2)

        # 2. the cell-state sequences
        c1_new, c1_prev = _rebuild_c(i1, f1, g1, m)
        c2_new, c2_prev = _rebuild_c(i2, f2, g2, m)
        t1c = torch.tanh(c1_new)
        t2c = torch.tanh(c2_new)

        # 3. the reverse pass; layer-2 step t yields d(hs1_t) through Wx2
        #    and the dropout multiplier, which layer-1 step t consumes
        w2_cat_t = torch.cat([wx2, wh2]).t()  # (4H, 2H)
        wh1_t = wh1.t()
        dh1_c, dc1_c = dh1_fin, dc1_fin
        dh2_c, dc2_c = dh2_fin, dc2_fin
        dgates1 = [None] * T
        dgates2 = [None] * T
        for t in reversed(range(T)):
            dgates2[t], dh2_pass, dc2_c = _layer_reverse_step(
                0.0, dh2_c, dc2_c, i2[t], f2[t], o2[t], g2[t], c2_prev[t], t2c[t], m[t]
            )
            both = _mm(dgates2[t].to(BF16), w2_cat_t)
            dh1_from2 = both[:, :H] * drop_f[t]
            dh2_c = both[:, H:] + dh2_pass
            dgates1[t], dh1_pass, dc1_c = _layer_reverse_step(
                dh1_from2, dh1_c, dc1_c, i1[t], f1[t], o1[t], g1[t], c1_prev[t], t1c[t], m[t]
            )
            dh1_c = _mm(dgates1[t].to(BF16), wh1_t) + dh1_pass
        dgates1 = torch.stack(dgates1)
        dgates2 = torch.stack(dgates2)

        # 4. whole-sequence products over the (T*N) axis
        dg1_b = dgates1.to(BF16).reshape(T * N, -1)
        dg2_b = dgates2.to(BF16).reshape(T * N, -1)

        def wgrad(seq, dg):  # einsum('tnk,tnj->kj')
            return _mm(seq.reshape(T * N, -1).t(), dg)

        dxs = _mm(dg1_b, wx1.t()).reshape(T, N, -1)
        return (
            dxs.to(xs.dtype), None, None,
            wgrad(xs, dg1_b).to(wx1.dtype), wgrad(h1_prev, dg1_b).to(wh1.dtype),
            dgates1.sum(dim=(0, 1)).to(b1.dtype),
            wgrad(d1, dg2_b).to(wx2.dtype), wgrad(h2_prev, dg2_b).to(wh2.dtype),
            dgates2.sum(dim=(0, 1)).to(b2.dtype),
        )


def fused2_encode_train(
    layers: Sequence[Dict[str, torch.Tensor]],
    xs: torch.Tensor,  # (T, N, In) time-major, any float dtype (cast to bf16)
    mask: torch.Tensor,  # (T, N)
    dropout_rate: float,
    generator: Optional[torch.Generator],
    dp=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training encode of exactly two layers (pallas_lstm2.py:336-378):
    returns the stacked final (c, h), each (2, N, H).  One (T, N, H)
    inter-layer dropout multiplier, in {0, 1/keep}, is drawn for the whole
    sequence (on a DP group ``dp``, this rank's slice of the global
    batch's); the per-layer ``bx + bh`` is summed in f32, then cast to
    bf16 with the weights and inputs."""
    if len(layers) != 2:
        raise ValueError(f"fused2_encode_train takes exactly 2 layers, got {len(layers)}")
    T, N, _ = xs.shape
    H = layers[0]["wh"].shape[0]
    ones = torch.ones(T, N, H, device=xs.device)
    drop = dropout(ones, dropout_rate, generator, deterministic=generator is None,
                   dp=dp, axis=1).to(BF16)
    l1, l2 = layers
    c1, h1, c2, h2 = Fused2.apply(
        xs.to(BF16), mask.to(F32), drop,
        l1["wx"].to(BF16), l1["wh"].to(BF16), (l1["bx"] + l1["bh"]).to(BF16),
        l2["wx"].to(BF16), l2["wh"].to(BF16), (l2["bx"] + l2["bh"]).to(BF16),
    )
    return torch.stack([c1, c2]), torch.stack([h1, h2])
