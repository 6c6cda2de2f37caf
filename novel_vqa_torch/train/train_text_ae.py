"""Text-autoencoder trainer CLI, on the card by default: port of
``novel_vqa_tpu.train.train_text_ae``.

The stage-001 AE trainers:
  * ``--variant text_nostart`` = 001_train_arch1_text_autoencoder.lua
    (adam lr 1e-5 alpha 0.8 beta 0.999, batch 1000, grad clip 0.1, weight
    decay 1e-6, 75001 iterations; flags :22-59);
  * ``--variant arch2`` = 001_train_arch2_text_autoencoder.lua (the image
    slot at t=1 fed zeros, as the loader does, misc/DataLoader.lua:84).

Loop semantics (001_train_arch1_text_autoencoder.lua): forward/backward ->
clamp(+-grad_clip) -> ``+ weight_decay * w`` (:237-243) -> the chosen
optimizer (:349-364); the continuous lr half-life (:341-346); ``eval_split``
on val every ``save_checkpoint_every`` iterations, with greedy samples
(:148-202); the best checkpoint gated on CIDEr under ``--language_eval 1``,
else on -val_loss (:296-318); the loss-explosion watchdog, loss > 20 *
loss0 (:369-373), checked at the log cadence.

Same flags and output files as the JAX trainer (``model_id<id>.{npz,json}``
with its keys, so either package loads the other's checkpoint), plus
``--device``.  ``--steps_per_dispatch k > 1`` keeps the train split on the
device and runs k iterations per call without waiting for it, with the
loader's exact windows (the head re-read on wrap).  Validation's NLL and
greedy sampling step through the step kernel (under ``--compute_dtype
bfloat16``, the JAX package's mixed precision, through the plain bf16
cell: no kernel).  ``--data_parallel 1`` under
``torchrun`` trains each rank on its slice of every batch (time-major, so
axis 1): the encoder's can_skip and the NLL's count of scored tokens are
reduced over the group, so the summed gradient is one device's; rank 0
writes and prints.  ``--profile_dir`` writes a
``torch.profiler`` trace; ``--debug_nans 1`` runs under
``torch.autograd.detect_anomaly``.

    python -m novel_vqa_torch.train.train_text_ae --input_h5 data.h5 \\
        --input_json data.json --checkpoint_path ae/
    python -m novel_vqa_torch.train.train_text_ae ... --device cpu
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os

import numpy as np
import torch

from novel_vqa_torch.core.checkpoint import load_npz, save_npz, unflatten_like
from novel_vqa_torch.core.config import parse_config
from novel_vqa_torch.core.convert import ae_params_from_numpy, ae_params_to_numpy
from novel_vqa_torch.core.profiling import nan_guard, span, trace
from novel_vqa_torch.data.corpus import CorpusLoader
from novel_vqa_torch.eval.language_metrics import language_eval
from novel_vqa_torch.models.seq import autoencoder as ae
from novel_vqa_torch.ops import optim
from novel_vqa_torch.parallel.mesh import DPGroup, cli_group, make_dp_train_step


@dataclasses.dataclass
class AETrainConfig:
    input_h5: str = "data/data.h5"
    input_json: str = "data/data.json"
    start_from: str = ""
    variant: str = "text_nostart"  # text_nostart | arch2
    rnn_size: int = 512
    input_encoding_size: int = 512
    num_layers: int = 1
    max_iters: int = 75001
    batch_size: int = 1000
    grad_clip: float = 0.1
    drop_prob_ae: float = 0.5
    optim: str = "adam"  # rmsprop|sgd|sgdm|sgdmom|adagrad|adam
    learning_rate: float = 1e-5
    learning_rate_decay_start: int = -1
    learning_rate_decay_every: int = 50000
    optim_alpha: float = 0.8
    optim_beta: float = 0.999
    optim_epsilon: float = 1e-8
    weight_decay: float = 1e-6
    val_sentences_use: int = 30000
    save_checkpoint_every: int = 2500
    checkpoint_path: str = ""
    losses_log_every: int = 25
    id: str = ""
    seed: int = 123
    profile_dir: str = ""  # torch.profiler chrome trace output dir ('' = off)
    debug_nans: int = 0  # 1 = torch.autograd.detect_anomaly
    sample_print: int = 0  # print N greedy samples per eval
    # 1 = score greedy reconstructions with BLEU/CIDEr and gate the best
    # checkpoint on CIDEr (eval/language_metrics.py)
    language_eval: int = 0
    # >1: the train split on the device and that many iterations per call
    # with the loader's exact windows; 1 = per-step host reads
    steps_per_dispatch: int = 1
    # 1 = data-parallel over the process group (torchrun: one process per
    # card; parallel/mesh.py): each rank trains on its slice of every
    # batch (time-major batches sharded on axis 1)
    data_parallel: int = 0
    # "bfloat16" = bf16 weights/activations in the forward with f32 masters
    # and f32 products' results (models/seq/autoencoder.AEConfig.compute_dtype);
    # f32 as the reference
    compute_dtype: str = "float32"
    device: str = "cuda"


def make_tx(opt: AETrainConfig) -> optim.GradientTransformation:
    """clamp(+-grad_clip) -> + weight_decay * w -> the chosen optimizer on
    the half-life schedule."""
    sched = optim.half_life_schedule(
        opt.learning_rate, opt.learning_rate_decay_start, opt.learning_rate_decay_every
    )
    if opt.optim == "adam":
        inner = optim.adam(sched, opt.optim_alpha, opt.optim_beta, opt.optim_epsilon)
    elif opt.optim == "rmsprop":
        inner = optim.rmsprop(sched, opt.optim_alpha, opt.optim_epsilon)
    elif opt.optim == "adagrad":
        inner = optim.adagrad(sched, opt.optim_epsilon)
    elif opt.optim == "sgd":
        inner = optim.sgd(sched)
    elif opt.optim == "sgdm":
        inner = optim.sgdm(sched, opt.optim_alpha)
    elif opt.optim == "sgdmom":
        inner = optim.sgdmom(sched, opt.optim_alpha)
    else:
        raise ValueError(f"bad option --optim {opt.optim}")
    return optim.chain(
        optim.clamp(opt.grad_clip),
        optim.add_decayed_weights(opt.weight_decay),
        inner,
    )


def dp_loss_fn(params, cfg: ae.AEConfig, seq, imgs, generator, dp=None) -> torch.Tensor:
    """``ae.loss_fn`` over a (seq, imgs) batch, the contract of
    ``parallel.mesh.make_dp_train_step``: on a group the can_skip and the
    count of scored tokens span the global batch, so the ranks' losses and
    gradients sum to one device's."""
    kwargs = {"imgs": imgs} if cfg.variant == "arch2" else {}
    return ae.loss_fn(params, cfg, seq, generator, dp=dp, **kwargs)


def make_dp_step(cfg: ae.AEConfig, tx, group):
    """The DP train step: ``step(params, opt_state, generator, seq (L, B),
    imgs (B, E))`` on the global batch, sharded on axis 1 (seq) and 0
    (imgs), the gradients summed over the group."""
    return make_dp_train_step(cfg, tx, group, dp_loss_fn, batch_specs=(1, 0), reduce="sum")


def train_step(cfg: ae.AEConfig, tx, params, opt_state, seq, generator, imgs=None):
    """One forward/backward/update step: returns (params, opt_state, loss),
    the loss a 0-d tensor left on the device.  The DP step on the group of
    one process; ``imgs`` (the arch2 variant's image slot) defaults to
    zeros."""
    if imgs is None:
        imgs = torch.zeros(seq.shape[1], cfg.input_encoding_size, device=seq.device)
    step = make_dp_step(cfg, tx, DPGroup(0, 1, seq.device))
    return step(params, opt_state, generator, seq, imgs)


def scan_windows(offset: torch.Tensor, n_rows: int, batch_size: int):
    """The loader's window at ``offset`` and the next offset, on the device
    (DataLoader.lua:58-88): a batch that crosses the end fills its tail
    from the head and the next one starts at 0."""
    base = torch.where(offset < n_rows - 1, offset, torch.zeros_like(offset))
    idx = base + torch.arange(batch_size, device=offset.device)
    idx = torch.where(idx < n_rows, idx, idx - n_rows)
    nxt = torch.where(offset + batch_size > n_rows, torch.zeros_like(offset), offset + batch_size)
    return idx, nxt


def train_steps_scan(cfg: ae.AEConfig, tx, params, opt_state, train_rows, offset,
                     n_steps: int, batch_size: int, generator, dp=None):
    """``n_steps`` iterations over the device-resident split ``train_rows``
    (N, L), the iterator ``offset`` a 0-d tensor carried on the device;
    nothing waits for the card.  Every rank of the DP group ``dp`` (by
    default the group of one process) reads the same global window and
    trains on its slice of it.  Returns (params, opt_state, offset, losses
    (n_steps,))."""
    if dp is None:
        dp = DPGroup(0, 1, train_rows.device)
    imgs = train_rows.new_zeros(batch_size, cfg.input_encoding_size, dtype=torch.float32)
    step = make_dp_step(cfg, tx, dp)
    losses = []
    for _ in range(n_steps):
        with span("train.sample"):
            idx, offset = scan_windows(offset, train_rows.shape[0], batch_size)
            seq = train_rows[idx].t()  # (L, bs)
        params, opt_state, loss = step(params, opt_state, generator, seq, imgs)
        losses.append(loss)
    return params, opt_state, offset, torch.stack(losses)


@torch.inference_mode()
def val_nll(cfg: ae.AEConfig, params, seq, imgs=None) -> torch.Tensor:
    """The deterministic fused NLL of one batch (step kernel)."""
    kwargs = {"imgs": imgs} if cfg.variant == "arch2" else {}
    with span("ae.nll"):
        return ae.apply_nll(params, cfg, seq, deterministic=True, **kwargs)[0]


@torch.inference_mode()
def greedy_tokens(cfg: ae.AEConfig, params, seq, imgs=None) -> torch.Tensor:
    """Encode one batch and decode it greedily (step kernel): (L, N)."""
    with span("ae.greedy"):
        state = ae.encode(params, cfg, seq, imgs if cfg.variant == "arch2" else None)
        return ae.sample(params, cfg, state)[0]


def decode_sequence(ix_to_word, seq: np.ndarray):
    """ix -> words (net_utils.decode_sequence, misc/net_utils.lua:298-313):
    stop a row at its first out-of-vocab (END) or null token."""
    L, N = seq.shape
    out = []
    for b in range(N):
        words = []
        for t in range(L):
            word = ix_to_word.get(str(int(seq[t, b])))
            if word is None:
                break
            words.append(word)
        out.append(" ".join(words))
    return out


def main(argv=None):
    opt = parse_config(AETrainConfig, argv, description=__doc__)
    if opt.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"--compute_dtype {opt.compute_dtype!r}: must be 'float32' or 'bfloat16'")
    group = cli_group(opt.data_parallel, opt.device, opt.batch_size)
    try:
        _train(opt, group)
    finally:
        group.close()


def _train(opt: AETrainConfig, group):
    device = group.device
    writer = group.is_writer  # only rank 0 writes and prints
    log = print if writer else (lambda *args: None)
    # full fp32 in the products, as the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    ckpt_dir = opt.checkpoint_path or "."
    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)

    loader = CorpusLoader(opt.input_h5, opt.input_json)
    cfg = ae.AEConfig(
        vocab_size=loader.vocab_size,
        input_encoding_size=opt.input_encoding_size,
        rnn_size=opt.rnn_size,
        num_layers=opt.num_layers,
        seq_length=loader.seq_length,
        dropout=opt.drop_prob_ae,
        variant=opt.variant,
        compute_dtype=opt.compute_dtype,
    )
    params = ae.init_params(cfg, torch.Generator().manual_seed(opt.seed), device)
    if opt.start_from:
        flat, _ = load_npz(opt.start_from)
        params = ae_params_from_numpy(unflatten_like(ae_params_to_numpy(params), flat), device)
    tx = make_tx(opt)
    opt_state = tx.init(params)
    # every rank starts from rank 0's state
    params = group.broadcast_tree(params)
    opt_state = group.broadcast_tree(opt_state)
    step = make_dp_step(cfg, tx, group)
    zero_imgs = torch.zeros(opt.batch_size, cfg.input_encoding_size, device=device)

    def eval_split(split: str):
        loader.reset_iterator(split)
        loss_sum, loss_evals, n = 0.0, 0, 0
        printed = 0
        predictions = []
        while True:
            labels, bounds = loader.get_batch(split, opt.batch_size)
            seq = torch.from_numpy(labels).to(device)
            loss_sum += float(val_nll(cfg, params, seq, zero_imgs))
            loss_evals += 1
            n += labels.shape[1]
            if printed < opt.sample_print or opt.language_eval:
                toks = greedy_tokens(cfg, params, seq, zero_imgs).cpu().numpy()
                preds = decode_sequence(loader.ix_to_word, toks)
                actuals = decode_sequence(loader.ix_to_word, labels)
                if opt.language_eval:
                    predictions += [{"prediction": p, "actual": a} for p, a in zip(preds, actuals)]
                for p, a in list(zip(preds, actuals))[: max(0, opt.sample_print - printed)]:
                    log(f"Prediction: {p} ||| Actual: {a}")
                    printed += 1
            if bounds["wrapped"]:
                break
            if 0 <= opt.val_sentences_use <= n:
                break
        lang_stats = None
        if opt.language_eval and predictions:
            lang_stats = language_eval(predictions)
            log("language eval:", lang_stats)
        return loss_sum / max(1, loss_evals), lang_stats

    chunk = max(1, opt.steps_per_dispatch)
    if chunk > 1:
        # the whole train split on the device; the loop carries the
        # loader's iterator (DataLoader.lua:58-88)
        train_rows = torch.from_numpy(loader.split_rows("train")).to(device)
        scan_offset = torch.zeros((), dtype=torch.int64, device=device)

    generator = torch.Generator(device=device).manual_seed(opt.seed)
    loss0 = None
    best_score = None
    loss_history = {}
    val_loss_history = {}
    it = 0
    with contextlib.ExitStack() as stack:
        stack.enter_context(trace(opt.profile_dir, device))
        stack.enter_context(nan_guard(bool(opt.debug_nans)))
        while True:
            if chunk > 1:
                params, opt_state, scan_offset, losses = train_steps_scan(
                    cfg, tx, params, opt_state, train_rows, scan_offset, chunk,
                    opt.batch_size, generator, dp=group,
                )
                loss = losses[-1]
                it += chunk - 1  # the loop tail below adds the final 1
            else:
                labels, _ = loader.get_batch("train", opt.batch_size)
                seq = torch.from_numpy(labels).to(device)
                params, opt_state, loss = step(params, opt_state, generator, seq, zero_imgs)

            # with k iterations per call the modulo cadences fire when the
            # window [it-k+1, it] crosses the boundary
            if opt.losses_log_every > 0 and it % opt.losses_log_every < chunk:
                f = float(loss)
                loss_history[it] = f
                log(f"iter {it}: {f:.6f}")
                # the loss-explosion watchdog, at the log cadence so that no
                # other step waits for the card
                if loss0 is None:
                    loss0 = f
                if f > loss0 * 20:
                    log("loss seems to be exploding, quitting.")
                    break

            if it % opt.save_checkpoint_every < chunk or it >= opt.max_iters - 1:
                val_loss, lang_stats = eval_split("val")
                val_loss_history[it] = val_loss
                log(f"validation loss: {val_loss}")

                ckpt_base = os.path.join(ckpt_dir, "model_id" + opt.id)
                # CIDEr gating under language eval, else -val_loss
                current_score = lang_stats["CIDEr"] if lang_stats is not None else -val_loss
                best = best_score is None or current_score > best_score
                if best:
                    best_score = current_score
                if writer:
                    with open(ckpt_base + ".json", "w") as f:
                        json.dump(
                            {
                                "opt": dataclasses.asdict(opt),
                                "iter": it,
                                "loss_history": loss_history,
                                "val_loss_history": val_loss_history,
                            },
                            f,
                        )
                    if best:
                        save_npz(
                            ckpt_base + ".npz",
                            ae_params_to_numpy(params),
                            meta={"cfg": cfg._asdict(), "iter": it, "val_loss": val_loss},
                        )
                        print("wrote best checkpoint to " + ckpt_base + ".npz")

            it += 1
            if 0 < opt.max_iters <= it:
                break

    loader.close()


if __name__ == "__main__":
    main()
