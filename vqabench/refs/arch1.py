"""arch1 in plain PyTorch, float32: the benchmark's reference.

After 002_train_vqa_arch1/002_train_baseline.lua (the CVPR 2017
novel-vqa release), written from its description and not from the port:

  * embedding: W[t] + b (the one-hot Linear, :141-144) -> Dropout(0.5) ->
    tanh; token 0 is the null pad of right-aligned questions;
  * encoder: a 2-layer LSTM over the T steps, gates i, f, o, g from
    x Wx + bx + h Wh + bh (misc/LSTM.lua:41-59); a row's state is held on
    its null steps (misc/RNNUtils.lua:84-125); Dropout(0.5) on the second
    layer's input only;
  * question vector: [c1, h1, c2, h2] at the last step (:152);
  * AxB fusion: tanh(Wq drop(q) + bq) * tanh(Wi drop(img) + bi)
    (misc/netdef.lua:6-14), Dropout(0.5), then Linear(1024, 1000);
  * loss: cross-entropy over 1-indexed answers (:157); the step: clamp
    each gradient element to +-10 (:329), then rmsprop, m = a m + (1 - a)
    g^2, x -= lr_k g / (sqrt(m) + eps), lr_k = lr0 d^k (:408-410).

Dropout takes the keep masks it is given (``masks``), so the reference
follows the draws the program made.  This file imports torch alone.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch


def param_spec(cfg: dict):
    """[(path, shape, init, scale)] in the layout the weights are handed
    over in: U(-0.08, 0.08) everywhere (:174-181)."""
    E, H, L = cfg["input_encoding_size"], cfg["rnn_size"], cfg["rnn_layer"]
    C, u = cfg["common_embedding_size"], cfg["init_uniform"]
    spec = [(("embedding", "w"), (cfg["vocab_size"], E)), (("embedding", "b"), (E,))]
    for layer in range(L):
        n_in = E if layer == 0 else H
        spec += [(("encoder", layer, "wx"), (n_in, 4 * H)), (("encoder", layer, "bx"), (4 * H,)),
                 (("encoder", layer, "wh"), (H, 4 * H)), (("encoder", layer, "bh"), (4 * H,))]
    spec += [(("fusion", "wq"), (2 * H * L, C)), (("fusion", "bq"), (C,)),
             (("fusion", "wi"), (cfg["nhimage"], C)), (("fusion", "bi"), (C,)),
             (("classifier", "w"), (C, cfg["num_output"])), (("classifier", "b"), (cfg["num_output"],))]
    return [(path, shape, "uniform", u) for path, shape in spec]


def draw_slots(cfg: dict, batch: int):
    """The keep masks one training forward uses, by name and shape."""
    T, E, H, L = cfg["seq_length"], cfg["input_encoding_size"], cfg["rnn_size"], cfg["rnn_layer"]
    slots = [("embedding", (batch, T, E))]
    slots += [(f"between_layers_{k}", (T, batch, H)) for k in range(1, L)]
    slots += [("fusion_q", (batch, 2 * H * L)), ("fusion_img", (batch, cfg["nhimage"])),
              ("fused", (batch, cfg["common_embedding_size"]))]
    return slots


def _drop(x, masks, name, keep):
    if masks is None:
        return x
    return torch.where(masks[name], x / keep, torch.zeros_like(x))


def _lstm_layer(p, xs, active):
    """One layer over time from a zero state: xs (T, N, In), active (T, N)
    bool.  Returns the final (c, h) and the per-step h, held on null steps."""
    T, N, _ = xs.shape
    H = p["wh"].shape[0]
    c = xs.new_zeros(N, H)
    h = xs.new_zeros(N, H)
    hs = []
    for t in range(T):
        gates = xs[t] @ p["wx"] + p["bx"] + h @ p["wh"] + p["bh"]
        i = torch.sigmoid(gates[:, :H])
        f = torch.sigmoid(gates[:, H:2 * H])
        o = torch.sigmoid(gates[:, 2 * H:3 * H])
        g = torch.tanh(gates[:, 3 * H:])
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        on = active[t][:, None]
        c = torch.where(on, c_new, c)
        h = torch.where(on, h_new, h)
        hs.append(h)
    return c, h, torch.stack(hs)


def scores(params, cfg: dict, tokens, image, masks: Optional[Dict[str, torch.Tensor]] = None):
    """(N, num_output) answer scores; ``masks`` (training) or none (eval).
    tokens (N, T) right-aligned, 0 = null; image (N, nhimage)."""
    keep = 1.0 - cfg["dropout"]
    emb = params["embedding"]
    idx = torch.clamp(tokens.long() - 1, 0, emb["w"].shape[0] - 1)
    x = torch.tanh(_drop(emb["w"][idx] + emb["b"], masks, "embedding", keep))
    xs = x.transpose(0, 1)
    active = (tokens != 0).t()
    state: List[torch.Tensor] = []
    for k, layer in enumerate(params["encoder"]):
        if k > 0:
            xs = _drop(xs, masks, f"between_layers_{k}", keep)
        c, h, xs = _lstm_layer(layer, xs, active)
        state += [c, h]
    q = torch.cat(state, dim=1)
    fu = params["fusion"]
    qc = torch.tanh(_drop(q, masks, "fusion_q", keep) @ fu["wq"] + fu["bq"])
    ic = torch.tanh(_drop(image, masks, "fusion_img", keep) @ fu["wi"] + fu["bi"])
    fused = _drop(qc * ic, masks, "fused", keep)
    return fused @ params["classifier"]["w"] + params["classifier"]["b"]


def loss(params, cfg, tokens, image, answers, masks=None):
    logp = torch.log_softmax(scores(params, cfg, tokens, image, masks), dim=1)
    return -logp.gather(1, (answers.long() - 1)[:, None]).mean()


def train(params, cfg: dict, batches) -> dict:
    """The first len(batches) steps from ``params`` (batches: (tokens,
    image, answers, masks) each).  Returns each step's loss, the first
    step's clamped gradient by leaf, and the params after the last step."""
    opt = cfg["optimizer"]
    alpha, eps, lr0, decay = opt["alpha"], opt["epsilon"], opt["learning_rate"], opt["decay_factor"]
    names, flat = _flatten(params)
    moments = [torch.zeros_like(p) for p in flat]
    losses, grad1 = [], None
    for k, (tokens, image, answers, masks) in enumerate(batches):
        live = [p.detach().requires_grad_() for p in flat]
        value = loss(_unflatten(params, live), cfg, tokens, image, answers, masks)
        grads = torch.autograd.grad(value, live)
        grads = [torch.clamp(g, -opt["grad_clamp"], opt["grad_clamp"]) for g in grads]
        if k == 0:
            grad1 = dict(zip(names, [g.detach().clone() for g in grads]))
        lr = lr0 * decay ** k
        moments = [alpha * m + (1 - alpha) * g * g for m, g in zip(moments, grads)]
        flat = [p.detach() - lr * g / (torch.sqrt(m) + eps) for p, g, m in zip(flat, grads, moments)]
        losses.append(float(value.detach()))
    return {"losses": losses, "grad1": grad1, "params": dict(zip(names, flat))}


def _flatten(tree, prefix=()):
    names, flat = [], []
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            n, f = _flatten(v, prefix + (k,))
            names += n
            flat += f
        else:
            names.append("/".join(str(p) for p in prefix + (k,)))
            flat.append(v)
    return names, flat


def _unflatten(tree, flat):
    it = iter(flat)

    def rebuild(node):
        if isinstance(node, dict):
            return {k: rebuild(v) for k, v in node.items()}
        if isinstance(node, list):
            return [rebuild(v) for v in node]
        return next(it)

    return rebuild(tree)
