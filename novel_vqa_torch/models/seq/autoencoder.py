"""LSTM sequence autoencoders, the novel-word-transfer models (port of
``novel_vqa_tpu.models.seq.autoencoder``).

Variants (all share one embedding table between encoder and decoder):
  * ``text_nostart``, the arch1 text AE (misc/AutoEncoder_text_nostart.lua):
    the encoder reads the seq_length token steps only; lookup = LookupTable
    -> Dropout(0.5) -> Tanh (:28-32);
  * ``arch2`` (misc/AutoEncoder.lua): the encoder reads [image, START,
    w1..wL] (:258-309); plain LookupTable; the decoder starts from the final
    encoder state (:313-316);
  * ``vqa_arch``, the arch1 weak-paired AE (misc/AutoEncoder_vqa_arch.lua):
    a 1-layer decoder seeded by the encoder's final (c, h) plus a skip
    connection AxB([c, h], image) -> Dropout(0.5) (:341-350); with
    ``encoder_skip`` the mean sentence vector stands in for the encoder
    (:332-335); the lookup and the mean vector get no gradient;
  * ``null``, the arch2 weak-paired AE (misc/AutoEncoderNull.lua): the
    encoder reads ``seq_input``, the criterion targets ``seq``; the lookup
    gets no gradient (:90-100).

As in the reference, the encoder does not mask per row: null tokens are
redirected to token 1 and processed, so rows that have ended keep
changing, and only the steps on which every row is null are skipped
(can_skip, AutoEncoder.lua:273-289).  The skip is a 0-d bool tensor per
step that ``torch.where`` applies on the device: the step runs every time
and nothing waits for the host.  The decoder runs all seq_length+1 steps.

Every step of a deterministic pass (``encode``, the teacher-forced
decoders and ``sample``) goes through the step kernel (``ops/lstm.
lstm_stack_step`` -> ``kernels.lstm.lstm_step``); training steps run the
plain cell with autograd.  Dropout masks come from one ``torch.Generator``
drawn in a fixed order, so :func:`apply` and :func:`apply_nll` draw alike
from the same seed.  The embedding dropout is a fixed 0.5 (not
``cfg.dropout``), as is the ``vqa_arch`` seed's.

``compute_dtype="bfloat16"`` is the JAX package's mixed precision: the
four entry points (:func:`encode`, :func:`apply`, :func:`apply_nll`,
:func:`sample`) cast the params' f32 leaves and the float inputs to bf16
(``_cast_compute``; the masters stay f32); every step then runs the plain
bf16 cell (no kernel, ``ops/lstm.py``), the decoder's projection gives
f32 logits (``ops/precision.dot_f32``), and the logsumexp and the NLL are
f32.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from novel_vqa_torch.core.device import resolve_device
from novel_vqa_torch.core.profiling import span
from novel_vqa_torch.ops.dropout import dropout
from novel_vqa_torch.ops.embedding import embedding_lookup
from novel_vqa_torch.ops.fusion import axb_apply
from novel_vqa_torch.ops.losses import sequence_targets
from novel_vqa_torch.ops.lstm import lstm_stack_step, step_masks
from novel_vqa_torch.ops.precision import cast_compute, compute_dtype, dot_f32

State = Tuple[torch.Tensor, torch.Tensor]  # (c, h), each (layers, N, H)


class AEConfig(NamedTuple):
    vocab_size: int
    input_encoding_size: int = 512
    rnn_size: int = 512
    num_layers: int = 1
    seq_length: int = 16
    dropout: float = 0.5  # -drop_prob_ae
    variant: str = "text_nostart"  # text_nostart | arch2 | vqa_arch | null
    nhimage: int = 0  # vqa_arch image feature width
    # "bfloat16" = mixed precision (bf16 weights and activations, f32
    # products' results and loss); float32 as the reference
    compute_dtype: str = "float32"

    @property
    def start_token(self) -> int:
        return self.vocab_size + 1  # START == END == V+1

    @property
    def decoder_layers(self) -> int:
        # the weak-paired arch1 decoder has 1 layer (AutoEncoder_vqa_arch.lua:33)
        return 1 if self.variant == "vqa_arch" else self.num_layers

    @property
    def lookup_has_dropout_tanh(self) -> bool:
        return self.variant in ("text_nostart", "vqa_arch")

    @property
    def lookup_frozen(self) -> bool:
        return self.variant in ("vqa_arch", "null")


def _cast_compute(cfg: AEConfig, params, *arrays):
    """``cfg.compute_dtype`` at an entry point: the params' f32 leaves and
    the float inputs (None and token tensors as they are) in bf16; a no-op
    for float32.  The cast's backward carries the gradients to the f32
    masters."""
    cdt = compute_dtype(cfg.compute_dtype)
    cast = lambda a: a.to(cdt) if a is not None and a.is_floating_point() else a
    return (cast_compute(params, cdt),) + tuple(cast(a) for a in arrays)


def init_params(
    cfg: AEConfig, generator: torch.Generator, device: str | torch.device = "cuda"
) -> Dict[str, Any]:
    """Torch's defaults, in the JAX package's layout: the lookup normal(0, 1)
    (nn.LookupTable), each linear uniform(+-1/sqrt(fan_in)) for weight and
    bias (nn.Linear).  The draws come from ``generator`` on the CPU and
    differ from ``jax.random``'s; the params land on ``device``."""
    device = resolve_device(device)

    def linear(n_in, n_out):
        bound = 1.0 / float(n_in) ** 0.5
        u = lambda *shape: torch.rand(*shape, generator=generator) * (2 * bound) - bound
        return u(n_in, n_out).to(device), u(n_out).to(device)

    def layer(n_in):
        wx, bx = linear(n_in, 4 * cfg.rnn_size)
        wh, bh = linear(cfg.rnn_size, 4 * cfg.rnn_size)
        return {"wx": wx, "bx": bx, "wh": wh, "bh": bh}

    E, H = cfg.input_encoding_size, cfg.rnn_size
    lookup = torch.randn(cfg.vocab_size + 1, E, generator=generator).to(device)
    encoder = [layer(E if i == 0 else H) for i in range(cfg.num_layers)]
    dec_layers = [layer(E if i == 0 else H) for i in range(cfg.decoder_layers)]
    proj_w, proj_b = linear(H, cfg.vocab_size + 1)
    params: Dict[str, Any] = {
        "lookup": lookup,
        "encoder": encoder,
        "decoder": {"layers": dec_layers, "proj_w": proj_w, "proj_b": proj_b},
    }
    if cfg.variant == "vqa_arch":
        wq, bq = linear(2 * H, 2 * H)
        wi, bi = linear(cfg.nhimage, 2 * H)
        params["multimodal"] = {"wq": wq, "bq": bq, "wi": wi, "bi": bi}
    return params


def _embed(params, cfg: AEConfig, tokens, generator, deterministic: bool,
           dp=None) -> torch.Tensor:
    """The variant's lookup; null tokens (0) read token 1's row, as
    ``it[eq(it,0)]=1``.  The batch is the last axis of ``tokens``."""
    x = embedding_lookup(params["lookup"], torch.clamp(tokens, min=1))
    if cfg.lookup_frozen:
        x = x.detach()
    if cfg.lookup_has_dropout_tanh:
        x = torch.tanh(dropout(x, 0.5, generator, deterministic, dp=dp, axis=tokens.dim() - 1))
    return x


def _start(cfg: AEConfig, N: int, device) -> torch.Tensor:
    return torch.full((N,), cfg.start_token, dtype=torch.long, device=device)


def _scan_encoder(layers, xs, active, cfg: AEConfig, generator, deterministic: bool,
                  dp=None) -> State:
    """The encoder's steps; ``active`` (T,) bool holds the state on the
    steps every row skips (the batch-wide can_skip)."""
    T, N, _ = xs.shape
    c = h = xs.new_zeros(len(layers), N, cfg.rnn_size)
    for t in range(T):
        masks = step_masks(len(layers), h[0], cfg.dropout, generator, deterministic, dp)
        c_new, h_new = lstm_stack_step(
            layers, xs[t], (c, h), dropout_rate=cfg.dropout, masks=masks,
            deterministic=deterministic,
        )
        c = torch.where(active[t], c_new, c)
        h = torch.where(active[t], h_new, h)
    return c, h


def encode(
    params,
    cfg: AEConfig,
    seq: torch.Tensor,  # (L, N) time-major tokens, 0 = null (suffix only)
    imgs: Optional[torch.Tensor] = None,  # (N, E) for arch2/null
    *,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    dp=None,
) -> State:
    """The variant's encoder: the final (c, h), each (layers, N, H).  On
    a DP group (``dp``, ``parallel/mesh.DPGroup``) ``seq`` is this rank's
    slice of the batch, and the can_skip and the dropout masks span the
    global batch, as they do on one device.  The encoder's steps are the
    tracer's ``lstm.encode`` span, as ``ops/lstm.lstm_encode``'s are."""
    params, imgs = _cast_compute(cfg, params, imgs)
    L, N = seq.shape
    embs = _embed(params, cfg, seq, generator, deterministic, dp)  # (L, N, E)
    token_active = (seq != 0).any(dim=1)  # (L,) the batch-wide can_skip
    if dp is not None:
        token_active = dp.any(token_active)
    if cfg.variant in ("arch2", "null"):
        start_emb = _embed(params, cfg, _start(cfg, N, seq.device), generator, deterministic, dp)
        xs = torch.cat([imgs[None], start_emb[None], embs], dim=0)
        active = torch.cat([token_active.new_ones(2), token_active])
    else:
        xs, active = embs, token_active
    with span("lstm.encode"):
        return _scan_encoder(params["encoder"], xs, active, cfg, generator, deterministic, dp)


def _decoder_steps(params, cfg: AEConfig, init_state: State, seq, generator, deterministic,
                   dp=None):
    """The teacher-forced decoder's steps: yields each step's (N, V+1)
    logits, step t fed START (t = 0) or seq[t-1]."""
    N = seq.shape[1]
    start_emb = _embed(params, cfg, _start(cfg, N, seq.device), generator, deterministic, dp)
    embs = _embed(params, cfg, seq, generator, deterministic, dp)
    xs = torch.cat([start_emb[None], embs], dim=0)  # (L+1, N, E)
    dec = params["decoder"]
    state = init_state
    for t in range(xs.shape[0]):
        masks = step_masks(len(dec["layers"]), state[1][0], cfg.dropout, generator,
                           deterministic, dp)
        state = lstm_stack_step(
            dec["layers"], xs[t], state, dropout_rate=cfg.dropout, masks=masks,
            deterministic=deterministic,
        )
        top = state[1][-1]
        if not deterministic:
            top = dropout(top, cfg.dropout, generator, False, dp=dp)
        yield dot_f32(top, dec["proj_w"]) + dec["proj_b"]


def decode_teacher_forced(params, cfg: AEConfig, init_state: State, seq, *,
                          generator=None, deterministic: bool = True) -> torch.Tensor:
    """(L+1, N, V+1) logprobs: step t predicts seq[t], the last step END."""
    return torch.stack([
        torch.log_softmax(logits, dim=-1)
        for logits in _decoder_steps(params, cfg, init_state, seq, generator, deterministic)
    ])


def decode_teacher_forced_nll(params, cfg: AEConfig, init_state: State, seq, *,
                              generator=None, deterministic: bool = True, dp=None):
    """The decoder and LanguageModelCriterion fused: the masked NLL
    accumulates step by step (a logsumexp and a gather at the target), so
    the (L+1, N, V+1) logprobs, 1.4 GB at the reference width, are never
    built.  The same math and draws as ``sequence_nll(decode_teacher_forced
    (...), seq)``.  Returns (loss, n).  On a DP group (``dp``) ``n`` is the
    global count of scored tokens, so the ranks' losses (and gradients)
    sum to the single-device ones."""
    Mp1 = params["decoder"]["proj_w"].shape[1]
    targets, scored = sequence_targets(seq, Mp1)
    gather_idx = torch.clamp(targets - 1, 0, Mp1 - 1)  # (L+1, N)
    loss_sum = seq.new_zeros((), dtype=torch.float32)
    steps = _decoder_steps(params, cfg, init_state, seq, generator, deterministic, dp)
    for t, logits in enumerate(steps):
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, 1, gather_idx[t][:, None])[:, 0] - lse
        loss_sum = loss_sum - torch.where(scored[t], picked, torch.zeros_like(picked)).sum()
    n = scored.sum()
    if dp is not None:
        n = dp.sum(n)
    return loss_sum / n.to(torch.float32), n


def _vqa_arch_decoder_init(params, cfg: AEConfig, c_enc, h_enc, imgs, generator, deterministic,
                           dp=None):
    """The multimodal skip-connected decoder seed (AutoEncoder_vqa_arch.lua:326-350)."""
    H = cfg.rnn_size
    c1, h1 = c_enc[-1], h_enc[-1]
    joined = torch.cat([c1, h1], dim=-1)  # [c, h] (JoinTable order)
    mm = axb_apply(params["multimodal"], joined, imgs, dropout_rate=0.5,
                   generator=generator, deterministic=deterministic, dp=dp)
    mm = dropout(mm, 0.5, generator, deterministic, dp=dp)
    return (c1 + mm[..., :H])[None], (h1 + mm[..., H:])[None]


def _decoder_start_state(params, cfg: AEConfig, seq, imgs, sent_input, seq_input,
                         encoder_skip: bool, generator, deterministic: bool, dp=None) -> State:
    """The encoder (and for vqa_arch the multimodal seed): the decoder's
    initial state."""
    kw = dict(generator=generator, deterministic=deterministic, dp=dp)
    if cfg.variant == "text_nostart":
        return encode(params, cfg, seq, **kw)
    if cfg.variant == "arch2":
        return encode(params, cfg, seq, imgs, **kw)
    if cfg.variant == "null":
        return encode(params, cfg, seq_input, imgs, **kw)
    if cfg.variant == "vqa_arch":
        H = cfg.rnn_size
        if encoder_skip:
            sent = sent_input.detach()
            c_enc, h_enc = sent[None, :, :H], sent[None, :, H:]
        else:
            c_enc, h_enc = encode(params, cfg, seq, **kw)
        return _vqa_arch_decoder_init(params, cfg, c_enc, h_enc, imgs, generator, deterministic,
                                      dp)
    raise ValueError(cfg.variant)


def apply(params, cfg: AEConfig, seq: torch.Tensor, *, imgs=None, sent_input=None,
          seq_input=None, encoder_skip: bool = False, generator=None,
          deterministic: bool = True) -> torch.Tensor:
    """The whole AE -> (L+1, N, V+1) decoder logprobs."""
    params, imgs, sent_input = _cast_compute(cfg, params, imgs, sent_input)
    state = _decoder_start_state(params, cfg, seq, imgs, sent_input, seq_input,
                                 encoder_skip, generator, deterministic)
    return decode_teacher_forced(params, cfg, state, seq, generator=generator,
                                 deterministic=deterministic)


def apply_nll(params, cfg: AEConfig, seq: torch.Tensor, *, imgs=None, sent_input=None,
              seq_input=None, encoder_skip: bool = False, generator=None,
              deterministic: bool = True, dp=None):
    """The whole AE to the fused masked NLL: (loss, n), equal to
    ``sequence_nll(apply(...), seq)`` from the same generator state.  On a
    DP group (``dp``) ``seq`` is this rank's slice and both the can_skip and
    the count span the global batch: the ranks' losses sum to one
    device's."""
    params, imgs, sent_input = _cast_compute(cfg, params, imgs, sent_input)
    state = _decoder_start_state(params, cfg, seq, imgs, sent_input, seq_input,
                                 encoder_skip, generator, deterministic, dp)
    return decode_teacher_forced_nll(params, cfg, state, seq, generator=generator,
                                     deterministic=deterministic, dp=dp)


def loss_fn(params, cfg: AEConfig, seq, generator, **kwargs) -> torch.Tensor:
    loss, _ = apply_nll(params, cfg, seq, generator=generator, deterministic=False, **kwargs)
    return loss


@torch.no_grad()
def sample(params, cfg: AEConfig, init_state: State, *, generator=None,
           sample_max: bool = True, temperature: float = 1.0):
    """Autoregressive decoding in evaluate mode (AutoEncoder.lua:173-212):
    START, then the arg-max token fed back (``argmax + 1``), or one drawn
    from softmax(logprobs / temperature) with ``generator`` (JAX's
    categorical in distribution, not in bits).  Returns (tokens (L, N),
    the logprobs of the chosen tokens (L, N)).  Like the JAX package it
    computes L+1 steps, the last step's output unused."""
    c, h = init_state
    params, c, h = _cast_compute(cfg, params, c, h)
    N = c.shape[1]
    dec = params["decoder"]

    def step_logits(state, tokens):
        x = _embed(params, cfg, tokens, None, True)
        state = lstm_stack_step(dec["layers"], x, state, deterministic=True)
        logits = dot_f32(state[1][-1], dec["proj_w"]) + dec["proj_b"]
        return state, torch.log_softmax(logits, dim=-1)

    state, logprobs = step_logits((c, h), _start(cfg, N, c.device))
    tokens, lps = [], []
    for _ in range(cfg.seq_length):
        if sample_max:
            it = torch.argmax(logprobs, dim=-1) + 1  # 1-indexed token
        else:
            probs = torch.softmax(logprobs / temperature, dim=-1)
            it = torch.multinomial(probs, 1, generator=generator)[:, 0] + 1
        lps.append(torch.gather(logprobs, 1, (it - 1)[:, None])[:, 0])
        tokens.append(it)
        state, logprobs = step_logits(state, it)
    return torch.stack(tokens), torch.stack(lps)
