"""The arch1 text autoencoder in plain PyTorch, float32: the benchmark's
reference.

After 001_train_autoencoder/001_train_arch1_text_autoencoder.lua:148-249
with misc/AutoEncoder_text_nostart.lua and misc/LanguageModelCriterion
(the CVPR 2017 novel-vqa release), written from that description:

  * one lookup table of V+1 rows (row V is START = END = V+1) shared by
    encoder and decoder; a null token reads token 1's row; lookup ->
    Dropout(0.5) -> tanh;
  * encoder: a 1-layer LSTM (E = H = 512) from zeros over the sentence's
    T steps, left-aligned with a null suffix; rows are not masked, so a
    row that has ended goes on changing, and only a step that is null in
    every row of the batch is skipped;
  * decoder: the same cell from the encoder's final (c, h), fed START then
    the sentence, Dropout(0.5) on its output in training, Linear(H, V+1);
  * loss: the NLL of each sentence's tokens and of END at its first null,
    summed and divided by the number of scored predictions;
  * the step: clamp each gradient element to +-0.1, add 1e-6 w, then adam
    (m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, x -= lr sqrt(1 - b2^t)
    / (1 - b1^t) m / (sqrt(v) + eps); optim_updates.lua:78-111).

Greedy decoding (the trainer's validation samples) feeds its own argmax
back; it is judged here on logits: the decoder is run teacher-forced on
the tokens a program chose.  This file imports torch alone.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from vqabench.refs.arch1 import _flatten, _unflatten


def param_spec(cfg: dict):
    """[(path, shape, init, scale)]: the lookup N(0, 1) (nn.LookupTable),
    each linear's weight and bias U(+-1/sqrt(fan_in)) (nn.Linear)."""
    V, E, H = cfg["vocab_size"], cfg["input_encoding_size"], cfg["rnn_size"]
    spec = [(("lookup",), (V + 1, E), "normal", 1.0)]

    def layer(prefix, n_in):
        ux, uh = 1.0 / math.sqrt(n_in), 1.0 / math.sqrt(H)
        return [(prefix + ("wx",), (n_in, 4 * H), "uniform", ux),
                (prefix + ("bx",), (4 * H,), "uniform", ux),
                (prefix + ("wh",), (H, 4 * H), "uniform", uh),
                (prefix + ("bh",), (4 * H,), "uniform", uh)]

    for k in range(cfg["num_layers"]):
        spec += layer(("encoder", k), E if k == 0 else H)
    for k in range(cfg["num_layers"]):
        spec += layer(("decoder", "layers", k), E if k == 0 else H)
    u = 1.0 / math.sqrt(H)
    spec += [(("decoder", "proj_w"), (H, V + 1), "uniform", u),
             (("decoder", "proj_b"), (V + 1,), "uniform", u)]
    return spec


def draw_slots(cfg: dict, batch: int):
    """The keep masks one training forward uses, by name and shape."""
    T, E, H = cfg["seq_length"], cfg["input_encoding_size"], cfg["rnn_size"]
    slots = [("encoder_lookup", (T, batch, E)), ("decoder_start_lookup", (batch, E)),
             ("decoder_lookup", (T, batch, E)), ("decoder_output", (T + 1, batch, H))]
    slots += [(f"between_layers_{k}", (T, batch, H)) for k in range(1, cfg["num_layers"])]
    return slots


def _drop(x, masks, name, keep, t=None):
    if masks is None:
        return x
    m = masks[name] if t is None else masks[name][t]
    return torch.where(m, x / keep, torch.zeros_like(x))


def _lookup(params, tokens, masks, name, keep):
    rows = torch.clamp(torch.clamp(tokens.long(), min=1) - 1, 0, params["lookup"].shape[0] - 1)
    return torch.tanh(_drop(params["lookup"][rows], masks, name, keep))


def _step(layers, x, c, h, masks, keep, t):
    """One stack step: (L, N, H) states; Dropout between layers only."""
    cs, hs = [], []
    for k, p in enumerate(layers):
        if k > 0:
            x = _drop(x, masks, f"between_layers_{k}", keep, t)
        H = p["wh"].shape[0]
        gates = x @ p["wx"] + p["bx"] + h[k] @ p["wh"] + p["bh"]
        i, f = torch.sigmoid(gates[:, :H]), torch.sigmoid(gates[:, H:2 * H])
        o, g = torch.sigmoid(gates[:, 2 * H:3 * H]), torch.tanh(gates[:, 3 * H:])
        c_new = f * c[k] + i * g
        cs.append(c_new)
        hs.append(o * torch.tanh(c_new))
        x = hs[-1]
    return torch.stack(cs), torch.stack(hs)


def encode(params, cfg, seq, masks=None):
    """The encoder's final (c, h), each (L, N, H); seq (T, N) time-major."""
    keep = 1.0 - cfg["dropout"]
    xs = _lookup(params, seq, masks, "encoder_lookup", keep)
    L, N = len(params["encoder"]), seq.shape[1]
    c = h = xs.new_zeros(L, N, cfg["rnn_size"])
    for t in range(seq.shape[0]):
        c_new, h_new = _step(params["encoder"], xs[t], c, h, masks, keep, t)
        if bool((seq[t] != 0).any()):
            c, h = c_new, h_new
    return c, h


def decoder_logits(params, cfg, state, inputs, masks=None):
    """(S, N, V+1) logits of the decoder from ``state`` fed START then
    ``inputs`` (S-1, N) tokens."""
    keep = 1.0 - cfg["dropout"]
    N = inputs.shape[1]
    start = torch.full((N,), cfg["vocab_size"] + 1, dtype=torch.long, device=inputs.device)
    xs = torch.cat([_lookup(params, start, masks, "decoder_start_lookup", keep)[None],
                    _lookup(params, inputs, masks, "decoder_lookup", keep)])
    dec = params["decoder"]
    c, h = state
    out = []
    for t in range(xs.shape[0]):
        c, h = _step(dec["layers"], xs[t], c, h, masks, keep, None)
        top = _drop(h[-1], masks, "decoder_output", keep, t)
        out.append(top @ dec["proj_w"] + dec["proj_b"])
    return torch.stack(out)


def nll(params, cfg, seq, masks=None):
    """(mean NLL over the scored predictions, their count)."""
    logits = decoder_logits(params, cfg, encode(params, cfg, seq, masks), seq, masks)
    T, N = seq.shape
    V1 = logits.shape[-1]
    lengths = (seq != 0).sum(dim=0)
    steps = torch.arange(T + 1, device=seq.device)[:, None]
    target = torch.cat([seq.long(), seq.new_zeros(1, N, dtype=torch.long)])
    target = torch.where(steps == lengths[None, :], V1, target)  # END at the first null
    scored = steps <= lengths[None, :]
    logp = torch.log_softmax(logits, dim=-1)
    picked = logp.gather(2, torch.clamp(target - 1, 0, V1 - 1)[..., None])[..., 0]
    n = scored.sum()
    return -(picked * scored).sum() / n, int(n)


def greedy_gaps(params, cfg, seq, tokens) -> torch.Tensor:
    """(T, N) gaps by which each token a greedy decode chose lies below the
    reference's best logit at its position, the decoder fed the chosen
    tokens (tokens (T, N), 1-indexed)."""
    state = encode(params, cfg, seq)
    logits = decoder_logits(params, cfg, state, tokens[:-1])
    chosen = logits.gather(2, (tokens.long() - 1)[..., None])[..., 0]
    return logits.max(dim=-1).values - chosen


def train(params, cfg: dict, batches) -> dict:
    """The first len(batches) steps (batches: (seq, masks) each): each
    step's loss, the first step's gradient as adam gets it (clamped, plus
    the weight decay) by leaf, and the params after the last step."""
    opt = cfg["optimizer"]
    b1, b2, eps, lr = opt["beta1"], opt["beta2"], opt["epsilon"], opt["learning_rate"]
    names, flat = _flatten(params)
    m = [torch.zeros_like(p) for p in flat]
    v = [torch.zeros_like(p) for p in flat]
    losses, grad1 = [], None
    for k, (seq, masks) in enumerate(batches):
        live = [p.detach().requires_grad_() for p in flat]
        value, _ = nll(_unflatten(params, live), cfg, seq, masks)
        grads = torch.autograd.grad(value, live)
        grads = [torch.clamp(g, -opt["grad_clip"], opt["grad_clip"]) + opt["weight_decay"] * p
                 for g, p in zip(grads, flat)]
        if k == 0:
            grad1 = dict(zip(names, [g.detach().clone() for g in grads]))
        t = k + 1
        m = [b1 * a + (1 - b1) * g for a, g in zip(m, grads)]
        v = [b2 * a + (1 - b2) * g * g for a, g in zip(v, grads)]
        step = lr * math.sqrt(1 - b2 ** t) / (1 - b1 ** t)
        flat = [p.detach() - step * a / (torch.sqrt(b) + eps) for p, a, b in zip(flat, m, v)]
        losses.append(float(value.detach()))
    return {"losses": losses, "grad1": grad1, "params": dict(zip(names, flat))}


def batch_nll(params, cfg, seq, masks: Optional[Dict[str, torch.Tensor]] = None) -> float:
    return float(nll(params, cfg, seq, masks)[0])
