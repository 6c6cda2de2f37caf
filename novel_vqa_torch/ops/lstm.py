"""Fused-gate LSTM: single step, multi-layer stack, masked time scan.

Port of ``novel_vqa_tpu.ops.lstm``.  Reference math
(002_train_vqa_arch1/misc/LSTM.lua:41-59):

    gates = x @ Wx + bx + h @ Wh + bh
    i, f, o = sigmoid(gates[0:H]), sigmoid(gates[H:2H]), sigmoid(gates[2H:3H])
    g       = tanh(gates[3H:4H])
    c' = f * c + i * g
    h' = o * tanh(c')

Layer params are dicts {wx (in, 4H), bx, wh (H, 4H), bh}; ``bx`` and ``bh``
stay separate to keep the Torch flat-vector layout, and are summed where a
kernel is called.

Routing mirrors the JAX package (ops/lstm.py:367-467), with the card in
the TPU's place:
  * a deterministic whole-sequence encode from a zero state (no
    ``init_state``, no ``return_sequence``) runs one seq-kernel launch per
    layer, layer k+1 fed layer k's per-step hidden states
    (``pallas_lstm_encode``);
  * under ``NOVEL_VQA_FUSED2=1``, a training encode of exactly two layers
    with ``rnn_size % 128 == 0`` and float32 CUDA inputs runs the seq2
    kernel once (``ops/lstm2.fused2_encode_train``; bf16 storage, so its
    results differ from the default route's in the last bf16 bits);
  * every other encode steps cell by cell through :func:`lstm_step`: the
    step kernel in eval, and in training the plain cell with autograd
    (the JAX package's XLA cell, ops/lstm.py:76-122), with inter-layer
    dropout.
The kernel wrappers (``kernels/``) launch the CUDA kernels on CUDA tensors
and run their plain versions on CPU tensors; their outputs carry no
``grad_fn``, so a training forward reaches them only through
``ops/lstm2.Fused2``, whose backward is written out.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from novel_vqa_torch.core.device import resolve_device
from novel_vqa_torch.kernels import lstm as kernels
from novel_vqa_torch.ops.dropout import dropout
from novel_vqa_torch.ops.lstm2 import fused2_encode_train

LSTMLayerParams = Dict[str, torch.Tensor]  # {"wx", "bx", "wh", "bh"}


@contextlib.contextmanager
def fused2_route(on: bool):
    """``NOVEL_VQA_FUSED2=1`` inside the block when ``on``, unset when not;
    the caller's setting afterwards (the route is read at each encode)."""
    old = os.environ.pop("NOVEL_VQA_FUSED2", None)
    if on:
        os.environ["NOVEL_VQA_FUSED2"] = "1"
    try:
        yield
    finally:
        os.environ.pop("NOVEL_VQA_FUSED2", None)
        if old is not None:
            os.environ["NOVEL_VQA_FUSED2"] = old


def lstm_layer_init(
    generator: torch.Generator,
    input_size: int,
    rnn_size: int,
    scale: float = 0.08,
    device: str | torch.device = "cuda",
) -> LSTMLayerParams:
    """Uniform(-scale, scale) init, matching ``encoder_w_q:uniform(-0.08, 0.08)``
    (002_train_vqa_arch1/002_train_baseline.lua:178).  The draws come from
    ``generator`` on the CPU; the params land on ``device``, ``cuda``
    unless the caller asks for ``cpu``."""
    device = resolve_device(device)

    def u(*shape):
        t = torch.rand(*shape, generator=generator, dtype=torch.float32)
        return (t * (2 * scale) - scale).to(device)

    return {
        "wx": u(input_size, 4 * rnn_size),
        "bx": u(4 * rnn_size),
        "wh": u(rnn_size, 4 * rnn_size),
        "bh": u(4 * rnn_size),
    }


def lstm_step(
    params: LSTMLayerParams,
    x: torch.Tensor,
    c: torch.Tensor,
    h: torch.Tensor,
    training: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step. x: (N, in); c, h: (N, H). Returns (c', h').

    ``training=False``: the step kernel.  ``training=True``: the plain cell
    with autograd, its two products in ``torch.matmul``."""
    if training:
        gates = (
            torch.matmul(x, params["wx"]) + torch.matmul(h, params["wh"])
            + params["bx"] + params["bh"]
        )
        return kernels.cell(gates, c)
    return kernels.lstm_step(
        x.contiguous(), h.contiguous(), c.contiguous(),
        params["wx"], params["wh"], params["bx"] + params["bh"],
    )


def lstm_stack_step(
    params: Sequence[LSTMLayerParams],
    x: torch.Tensor,
    state: Tuple[torch.Tensor, torch.Tensor],  # (c, h) each (L, N, H)
    *,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    dp=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-layer step: layer k+1 reads layer k's new h.  Inter-layer
    dropout on the input of layers > 1 only (misc/LSTM.lua:36-38: none on
    the first layer's input and none on the recurrent path); on a DP group
    (``dp``) its masks are the global batch's (``ops/dropout.py``)."""
    c, h = state
    new_c: List[torch.Tensor] = []
    new_h: List[torch.Tensor] = []
    inp = x
    for layer_idx, layer in enumerate(params):
        if layer_idx > 0:
            inp = dropout(inp, dropout_rate, generator, deterministic, dp=dp)
        c_l, h_l = lstm_step(
            layer, inp, c[layer_idx], h[layer_idx], training=not deterministic
        )
        new_c.append(c_l)
        new_h.append(h_l)
        inp = h_l
    return torch.stack(new_c), torch.stack(new_h)


def pack_state(c: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Pack (L, N, H) c/h into the Torch packed-state layout [c1, h1, c2, h2,
    ...] of width 2*L*H (misc/LSTM.lua:21-23,70)."""
    parts = []
    for layer in range(c.shape[0]):
        parts.append(c[layer])
        parts.append(h[layer])
    return torch.cat(parts, dim=-1)


def unpack_state(packed: torch.Tensor, num_layers: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_state`."""
    rnn_size = packed.shape[-1] // (2 * num_layers)
    cs, hs = [], []
    for layer in range(num_layers):
        off = 2 * layer * rnn_size
        cs.append(packed[..., off : off + rnn_size])
        hs.append(packed[..., off + rnn_size : off + 2 * rnn_size])
    return torch.stack(cs), torch.stack(hs)


def lstm_encode(
    params: Sequence[LSTMLayerParams],
    xs: torch.Tensor,  # (T, N, in) time-major inputs
    mask: torch.Tensor,  # (T, N) 1.0 where the step is active for that row
    *,
    init_state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    return_sequence: bool = False,
    remat: bool = False,
    dp=None,
):
    """Masked dense scan over time.

    ``state = where(mask_t, stack_step(state, x_t), state)``: rows keep their
    previous (initially zero) state on inactive steps, which reproduces the
    reference's right-aligned ragged batching (misc/RNNUtils.lua:84-125).

    Returns the final (c, h), each (L, N, H), or ``((c, h), (cs, hs))`` with
    the per-step states, each (T, L, N, H), when ``return_sequence``.
    ``generator`` draws the dropout masks of training mode
    (``deterministic=False``), at the global batch's shape on a DP group
    (``dp``).
    """
    if remat:
        raise NotImplementedError(
            "lstm_encode(remat=True): recomputing the step in the backward is "
            "not ported yet (ROADMAP A3, remat)"
        )
    whole_sequence = init_state is None and not return_sequence
    if whole_sequence and deterministic:
        mask = mask.contiguous()
        cs, hs_final = [], []
        inp = xs.contiguous()
        for layer in params:
            c, h, hs = kernels.lstm_seq(
                inp, mask, layer["wx"], layer["wh"], layer["bx"] + layer["bh"]
            )
            cs.append(c)
            hs_final.append(h)
            inp = hs
        return torch.stack(cs), torch.stack(hs_final)
    if (
        whole_sequence
        and os.environ.get("NOVEL_VQA_FUSED2", "0") == "1"
        and len(params) == 2
        and params[0]["wh"].shape[0] % 128 == 0
        and xs.dtype == torch.float32
        and xs.is_cuda
    ):
        return fused2_encode_train(params, xs, mask, dropout_rate, generator, dp)

    seq_len, batch, _ = xs.shape
    if init_state is None:
        rnn_size = params[0]["wh"].shape[0]
        zeros = xs.new_zeros(len(params), batch, rnn_size)
        init_state = (zeros, zeros)
    c, h = init_state
    cs_seq, hs_seq = [], []
    for t in range(seq_len):
        c_new, h_new = lstm_stack_step(
            params, xs[t], (c, h), dropout_rate=dropout_rate,
            generator=generator, deterministic=deterministic, dp=dp,
        )
        m = mask[t][None, :, None] > 0
        c = torch.where(m, c_new, c)
        h = torch.where(m, h_new, h)
        if return_sequence:
            cs_seq.append(c)
            hs_seq.append(h)
    if return_sequence:
        return (c, h), (torch.stack(cs_seq), torch.stack(hs_seq))
    return c, h
