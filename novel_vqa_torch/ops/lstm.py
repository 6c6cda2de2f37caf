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
the TPU's place.  The kernels take float32 only: bf16 inputs (the mixed
precision of ``compute_dtype="bfloat16"``) take the plain cell on every
device, in eval too, as the JAX package keeps them on XLA (:97, :374).
For float32 inputs:
  * a deterministic whole-sequence encode from a zero state (no
    ``init_state``, no ``return_sequence``, no ``remat``) runs one
    seq-kernel launch per layer, layer k+1 fed layer k's per-step hidden
    states (``pallas_lstm_encode``);
  * a training whole-sequence encode (no ``remat`` either) of CUDA inputs
    with ``rnn_size % 128 == 0`` takes, in this order, the first route
    its environment asks for:
      - ``NOVEL_VQA_FUSED2=1`` with exactly two layers: the seq2 kernel
        once (``ops/lstm2.fused2_encode_train``; bf16 storage, so its
        results differ from the default route's in the last bf16 bits);
      - ``NOVEL_VQA_SEQ_TRAIN=1``: one seq-kernel launch per layer with
        the written-out backward (``ops/lstm_vjp.seq_encode_train``); its
        dropout is one (T, N, H) draw per layer boundary, not one (N, H)
        draw per step and layer, so a CUDA generator gives it other masks
        than the per-step route's, from the same distribution;
  * every other encode steps cell by cell through :func:`lstm_step`: the
    step kernel in eval, and in training the plain cell with autograd
    (the JAX package's XLA cell, ops/lstm.py:76-122), with inter-layer
    dropout.
The environment is read at each call (:func:`training_route` sets it for
a block).  ``NOVEL_VQA_PALLAS`` is not ported: ``=0`` (the plain cell
everywhere) would put the plain version on the card's main path, and
``=all`` (training steps through the step kernel) gave the default
route's loss on an H100 and was slower (PERF.md, Findings).
The bf16 cell is JAX's: gates in f32 from products with an f32 result
(``ops/precision.dot_f32``) plus the bf16 biases, the activations and
``c'`` in f32, then ``c'`` and ``h'`` rounded to the carry's dtype.
``remat`` (``jax.checkpoint`` of the step) recomputes each training step
in the backward (``torch.utils.checkpoint``); the step's dropout masks
are drawn before it, so the recompute applies the same masks.
The kernel wrappers (``kernels/``) launch the CUDA kernels on CUDA tensors
and run their plain versions on CPU tensors; their outputs carry no
``grad_fn``, so a training forward reaches them only through an autograd
Function whose backward is written out: ``ops/lstm2.Fused2`` and
``ops/lstm_vjp.FusedSeq``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from novel_vqa_torch.core.device import resolve_device
from novel_vqa_torch.core.profiling import span
from novel_vqa_torch.kernels import lstm as kernels
from novel_vqa_torch.ops.dropout import apply_mask, dropout_mask
from novel_vqa_torch.ops.lstm2 import fused2_encode_train
from novel_vqa_torch.ops.lstm_vjp import seq_encode_train
from novel_vqa_torch.ops.precision import dot_f32

LSTMLayerParams = Dict[str, torch.Tensor]  # {"wx", "bx", "wh", "bh"}


# the training routes' environment variables and the value that selects each
ROUTE_ENV = {
    "fused2": ("NOVEL_VQA_FUSED2", "1"),
    "seq_train": ("NOVEL_VQA_SEQ_TRAIN", "1"),
}


@contextlib.contextmanager
def training_route(name: str):
    """The training route ``name`` inside the block: ``"default"`` unsets
    every variable of :data:`ROUTE_ENV`, another name sets its own and
    unsets the others; the caller's settings afterwards (the route is read
    at each encode)."""
    if name != "default" and name not in ROUTE_ENV:
        raise ValueError(f"training route {name!r}: one of default, {', '.join(ROUTE_ENV)}")
    old = {var: os.environ.pop(var, None) for var, _ in ROUTE_ENV.values()}
    if name != "default":
        var, value = ROUTE_ENV[name]
        os.environ[var] = value
    try:
        yield
    finally:
        for var, value in old.items():
            os.environ.pop(var, None)
            if value is not None:
                os.environ[var] = value


def _on_card(t: torch.Tensor) -> bool:
    """Whether the training routes through a kernel take ``t``: a CUDA
    tensor (the JAX package's TPU test)."""
    return t.is_cuda


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

    ``training=False`` with float32 ``x``: the step kernel.  Otherwise the
    plain cell with autograd, its two products with an f32 result
    (``torch.matmul`` for f32), ``c'`` and ``h'`` in the carry's dtype."""
    if training or x.dtype != torch.float32:
        gates = (
            dot_f32(x, params["wx"]) + dot_f32(h, params["wh"])
            + params["bx"] + params["bh"]
        )
        c_new, h_new = kernels.cell(gates, c)
        return c_new.to(c.dtype), h_new.to(h.dtype)
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
    masks: Optional[Sequence[Optional[torch.Tensor]]] = None,
    deterministic: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-layer step: layer k+1 reads layer k's new h.  Inter-layer
    dropout on the input of layers > 1 only (misc/LSTM.lua:36-38: none on
    the first layer's input and none on the recurrent path), with the
    step's ``masks`` from :func:`step_masks`; ``None`` applies none."""
    c, h = state
    new_c: List[torch.Tensor] = []
    new_h: List[torch.Tensor] = []
    inp = x
    for layer_idx, layer in enumerate(params):
        if layer_idx > 0 and masks is not None:
            inp = apply_mask(inp, masks[layer_idx], dropout_rate)
        c_l, h_l = lstm_step(
            layer, inp, c[layer_idx], h[layer_idx], training=not deterministic
        )
        new_c.append(c_l)
        new_h.append(h_l)
        inp = h_l
    return torch.stack(new_c), torch.stack(new_h)


def step_masks(
    num_layers: int, h: torch.Tensor, dropout_rate: float, generator, deterministic: bool,
    dp=None,
) -> Optional[List[Optional[torch.Tensor]]]:
    """The inter-layer dropout masks of one stack step (``h``: one layer's
    (N, H) state), one per layer, the first unused; ``None`` where no
    dropout applies (eval, or rate 0), which draws nothing.  On a DP group
    (``dp``) they are the global batch's masks' slices
    (``ops/dropout.py``)."""
    if deterministic or dropout_rate == 0.0:
        return None
    return [None] + [dropout_mask(h, dropout_rate, generator, dp) for _ in range(num_layers - 1)]


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
    ``remat`` recomputes each training step in the backward instead of
    keeping its activations; the results are the same.  The tracer's span
    is ``lstm.encode``.
    """
    with span("lstm.encode"):
        whole_sequence = init_state is None and not return_sequence and not remat
        kernel_dtype = xs.dtype == torch.float32
        if whole_sequence and deterministic and kernel_dtype:
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
            whole_sequence and not deterministic and kernel_dtype
            and params[0]["wh"].shape[0] % 128 == 0 and _on_card(xs)
        ):
            if os.environ.get("NOVEL_VQA_FUSED2", "0") == "1" and len(params) == 2:
                return fused2_encode_train(params, xs, mask, dropout_rate, generator, dp)
            if os.environ.get("NOVEL_VQA_SEQ_TRAIN", "0") == "1":
                return seq_encode_train(params, xs, mask, dropout_rate, generator, dp)

        seq_len, batch, _ = xs.shape
        if init_state is None:
            rnn_size = params[0]["wh"].shape[0]
            zeros = xs.new_zeros(len(params), batch, rnn_size)
            init_state = (zeros, zeros)
        c, h = init_state

        def step(x_t, m_t, c, h, masks):
            c_new, h_new = lstm_stack_step(
                params, x_t, (c, h), dropout_rate=dropout_rate, masks=masks,
                deterministic=deterministic,
            )
            m = m_t[None, :, None] > 0
            return torch.where(m, c_new, c), torch.where(m, h_new, h)

        cs_seq, hs_seq = [], []
        for t in range(seq_len):
            masks = step_masks(len(params), h[0], dropout_rate, generator, deterministic, dp)
            if remat and not deterministic:
                # every draw is from ``generator``, made above: no RNG state to keep
                c, h = checkpoint(step, xs[t], mask[t], c, h, masks, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                c, h = step(xs[t], mask[t], c, h, masks)
            if return_sequence:
                cs_seq.append(c)
                hs_seq.append(h)
        if return_sequence:
            return (c, h), (torch.stack(cs_seq), torch.stack(hs_seq))
        return c, h
