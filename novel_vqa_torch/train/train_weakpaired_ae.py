"""Weak-paired autoencoder trainer CLI (joint CNN + AE), on the card by
default: port of ``novel_vqa_tpu.train.train_weakpaired_ae``
(001_train_autoencoder/004_train_arch{1,2}_weakpaired_autoencoder_{vgg,inc}.lua).

  * ``--variant vqa_arch`` (arch1): AutoEncoder_vqa, the text encoder and
    an AxB multimodal skip fusion seeding the decoder; with probability 0.5
    the batch takes the encoder-skip path fed the precomputed mean LSTM
    sentence vector (``--lstm_average_path`` h5 ``/mean_vector``,
    004_train_arch1_...vgg.lua:296-310); the CNN is build_cnn_2 (VGG fc7 ->
    L2Normalize, misc/net_utils.lua:46-81);
  * ``--variant null`` (arch2): AutoEncoderNull, with probability
    ``--rand_val`` the encoder's sentence input zeroed while the criterion
    targets the true sequence (004_train_arch2_...vgg.lua:289-295); the CNN
    is build_cnn (VGG fc7 -> L2Normalize -> Linear(4096 -> encoding_size),
    net_utils.lua:5-44);
  * ``--cnn_arch inception`` swaps the trunk for Inception-v3 (2048-d pool,
    nhimage 2048, 004_train_arch1_...inc.lua);
  * ``--start_from_text`` copies encoder/decoder/lookup(/multimodal) from a
    text-AE checkpoint (:143-153); ``--start_from`` reloads both nets from
    a saved ``model_id.npz``; ``--resume`` continues a ``--save_train_state``
    file (both nets, both optimizer states, the iteration and the train
    window's position);
  * a separate CNN optimizer, whose gradients and update run only from
    ``--finetune_cnn_after`` on (:329-331, :477-487): before that the trunk
    runs under ``torch.no_grad()``; the AE side's clamp and weight decay;
    the loss-explosion watchdog; the best checkpoint gated on -val_loss.

Validation is deterministic: every AE step of it runs the step kernel on
the card (``csrc/lstm.cu`` ``lstm_step_kernel``).  ``--compute_dtype
bfloat16`` stores the trunk's weights and activations in bf16 inside the
step, with f32 master weights and f32 optimizer states.  The whole run has
TF32 off (true fp32 products, as the reference).  Checkpoints are the JAX
CLI's files (``model_id<id>.{npz,json}`` with ``ae/`` and ``cnn/`` keys,
``train_state<id>.npz``, HWIO convs), so either package reads the other's.
Same flags as the JAX CLI plus ``--device``; ``--data_parallel 1`` and
``--remat 1`` raise (ROADMAP A13, A11).

    python -m novel_vqa_torch.train.train_weakpaired_ae --input_h5 data.h5 \\
        --input_json data.json --lstm_average_path lstm_mean.h5 --checkpoint_path wp/
    python -m novel_vqa_torch.train.train_weakpaired_ae ... --device cpu
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import random

import numpy as np
import torch

from novel_vqa_torch.core.checkpoint import load_npz, save_npz, unflatten_like
from novel_vqa_torch.core.config import parse_config
from novel_vqa_torch.core.convert import vision_params_from_numpy, vision_params_to_numpy
from novel_vqa_torch.core.device import resolve_device
from novel_vqa_torch.core.h5 import H5Reader
from novel_vqa_torch.core.profiling import nan_guard, trace
from novel_vqa_torch.core.tree import tree_leaves, value_and_grad
from novel_vqa_torch.data.weakpaired import (
    WeakPairedLoader,
    center_crop_offsets,
    prepro_wp_images,
    random_crop_offsets,
)
from novel_vqa_torch.models.seq import autoencoder as ae
from novel_vqa_torch.models.vision import inception, vgg
from novel_vqa_torch.models.vision.layers import bf16_storage_cast, fp32_exact
from novel_vqa_torch.ops import optim
from novel_vqa_torch.ops.l2norm import l2_normalize


@dataclasses.dataclass
class WPTrainConfig:
    input_h5: str = "data/data.h5"
    input_json: str = "data/data.json"
    start_from: str = ""  # reload both nets {ae, cnn} from a model_id .npz
    start_from_text: str = ""
    # full-state resume from a --save_train_state file; the crop, coin-flip
    # and dropout streams continue from seeds offset by the iteration
    resume: str = ""
    save_train_state: int = 0
    cnn_arch: str = "vgg16"  # vgg16 | inception
    cnn_weights: str = ""  # converted .npz trunk weights ('' = random)
    lstm_average_path: str = ""
    img_average_path: str = ""
    variant: str = "vqa_arch"  # vqa_arch (arch1) | null (arch2)
    rnn_size: int = 512
    input_encoding_size: int = 512
    num_layers: int = 1
    max_iters: int = 50000
    batch_size: int = 16
    grad_clip: float = 0.1
    drop_prob_ae: float = 0.5
    optim: str = "adam"
    learning_rate: float = 3e-5
    learning_rate_decay_start: int = -1
    learning_rate_decay_every: int = 50000
    optim_alpha: float = 0.8
    optim_beta: float = 0.999
    optim_epsilon: float = 1e-8
    weight_decay: float = 1e-6
    finetune_cnn_after: int = -1
    nhimage: int = 4096
    cnn_optim: str = "adam"
    cnn_optim_alpha: float = 0.8
    cnn_optim_beta: float = 0.999
    cnn_learning_rate: float = 1e-5
    cnn_weight_decay: float = 0.0
    rand_val: float = 0.5
    val_sentences_use: int = 30000
    save_checkpoint_every: int = 5000
    checkpoint_path: str = ""
    losses_log_every: int = 25
    id: str = ""
    seed: int = 123
    profile_dir: str = ""  # torch.profiler chrome trace output dir ('' = off)
    debug_nans: int = 0  # 1 = torch.autograd.detect_anomaly
    image_size: int = 256  # stored image side; cropped to crop_size
    crop_size: int = 224
    # multi-GPU training comes with the multi-GPU slice: 1 raises
    data_parallel: int = 0
    compute_dtype: str = "float32"  # float32 | bfloat16 (trunk storage)
    # 1 = recompute the trunk's forward in the finetune backward: raises
    # until an H100 measurement calls for it
    remat: int = 0
    device: str = "cuda"


def build_cnn(opt: WPTrainConfig, with_projection: bool, generator: torch.Generator, device):
    """build_cnn / build_cnn_2: (params {"trunk"[, "proj"]}, apply(params,
    images) -> (N, D) f32 features, trunk feature width)."""
    if opt.cnn_arch == "vgg16":
        cfg, net, tap, feat_dim = vgg.VGGConfig(arch="vgg16", image_size=opt.crop_size), vgg, "fc7", 4096
    elif opt.cnn_arch == "inception":
        cfg, net, tap, feat_dim = inception.InceptionConfig(image_size=opt.crop_size), inception, "pool", 2048
    else:
        raise ValueError(f"unknown --cnn_arch {opt.cnn_arch}: vgg16 | inception")
    if opt.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown --compute_dtype {opt.compute_dtype}")
    if opt.cnn_weights:
        flat, _ = load_npz(opt.cnn_weights)
        flat = {k[len("trunk/"):] if k.startswith("trunk/") else k: v for k, v in flat.items()}
        trunk = vision_params_from_numpy(unflatten_like(net.param_template(cfg), flat), device)
    else:
        trunk = net.init_params(cfg, generator, device)
    cnn_params = {"trunk": trunk}
    if with_projection:
        # Linear(feat_dim -> encoding_size), weight +-0.08, bias 0 (net_utils.lua:39-42)
        w = torch.rand(feat_dim, opt.input_encoding_size, generator=generator) * 0.16 - 0.08
        cnn_params["proj"] = {"w": w.to(device), "b": torch.zeros(opt.input_encoding_size, device=device)}

    def apply_fn(cnn_params, images):
        trunk_params = cnn_params["trunk"]
        if opt.compute_dtype == "bfloat16":
            # cast inside the step: the masters and both optimizers stay f32,
            # and the cast's backward carries the trunk's gradients to f32
            trunk_params = bf16_storage_cast(trunk_params)
        feats = l2_normalize(net.apply(trunk_params, cfg, images, tap).float())
        if "proj" in cnn_params:
            feats = feats @ cnn_params["proj"]["w"] + cnn_params["proj"]["b"]
        return feats

    return cnn_params, apply_fn, feat_dim


def make_ae_tx(opt: WPTrainConfig) -> optim.GradientTransformation:
    sched = optim.half_life_schedule(opt.learning_rate, opt.learning_rate_decay_start,
                                     opt.learning_rate_decay_every)
    inner = {
        "adam": lambda: optim.adam(sched, opt.optim_alpha, opt.optim_beta, opt.optim_epsilon),
        "rmsprop": lambda: optim.rmsprop(sched, opt.optim_alpha, opt.optim_epsilon),
        "adagrad": lambda: optim.adagrad(sched, opt.optim_epsilon),
        "sgd": lambda: optim.sgd(sched),
        "sgdm": lambda: optim.sgdm(sched, opt.optim_alpha),
        "sgdmom": lambda: optim.sgdmom(sched, opt.optim_alpha),
    }
    if opt.optim not in inner:
        raise ValueError(f"bad option --optim {opt.optim}")
    return optim.chain(optim.clamp(opt.grad_clip), optim.add_decayed_weights(opt.weight_decay),
                       inner[opt.optim]())


def make_cnn_tx(opt: WPTrainConfig) -> optim.GradientTransformation:
    sched = optim.half_life_schedule(opt.cnn_learning_rate, opt.learning_rate_decay_start,
                                     opt.learning_rate_decay_every)
    inner = {
        "adam": lambda: optim.adam(sched, opt.cnn_optim_alpha, opt.cnn_optim_beta, opt.optim_epsilon),
        "sgd": lambda: optim.sgd(sched),
        "sgdm": lambda: optim.sgdm(sched, opt.cnn_optim_alpha),
    }
    if opt.cnn_optim not in inner:
        raise ValueError(f"bad option --cnn_optim {opt.cnn_optim}")
    chain = [inner[opt.cnn_optim]()]
    if opt.cnn_weight_decay > 0:
        chain = [optim.add_decayed_weights(opt.cnn_weight_decay), optim.clamp(opt.grad_clip)] + chain
    return optim.chain(*chain)


def make_train_step(cfg: ae.AEConfig, variant: str, crop_size: int, cnn_apply,
                    ae_tx: optim.GradientTransformation, cnn_tx: optim.GradientTransformation):
    """The weak-paired train step: crop and normalize on the device -> CNN
    forward -> AE forward/backward -> the AE update and, with ``finetune``,
    the CNN's gradients and update (the reference's finetune gate is a
    phase change on the host, 004_train_arch1_...vgg.lua:329-331).

    Returns ``step(skip, finetune, ae_params, ae_opt_state, cnn_params,
    cnn_opt_state, images_u8, offsets, seq, sent_input, seq_input,
    generator) -> (ae_params, ae_opt_state, cnn_params, cnn_opt_state,
    loss)``, the loss a 0-d tensor left on the device."""

    def loss_from_feats(ae_params, feats, seq, sent_input, seq_input, skip, generator):
        # the fused decoder + criterion: the (L+1, N, V+1) logprobs are never built
        if variant == "vqa_arch":
            return ae.apply_nll(ae_params, cfg, seq, imgs=feats, sent_input=sent_input,
                                encoder_skip=skip, generator=generator, deterministic=False)[0]
        return ae.apply_nll(ae_params, cfg, seq, imgs=feats, seq_input=seq_input,
                            generator=generator, deterministic=False)[0]

    def step(skip, finetune, ae_params, ae_opt_state, cnn_params, cnn_opt_state,
             images_u8, offsets, seq, sent_input, seq_input, generator):
        images = prepro_wp_images(images_u8, offsets, crop_size)
        args = (seq, sent_input, seq_input, bool(skip), generator)
        if finetune:
            def full_loss(both):
                return loss_from_feats(both["ae"], cnn_apply(both["cnn"], images), *args)

            loss, grads = value_and_grad(full_loss)({"ae": ae_params, "cnn": cnn_params})
            ae_grads = grads["ae"]
            cnn_updates, cnn_opt_state = cnn_tx.update(grads["cnn"], cnn_opt_state, cnn_params)
            cnn_params = optim.apply_updates(cnn_params, cnn_updates)
        else:
            with torch.no_grad():
                feats = cnn_apply(cnn_params, images)
            loss, ae_grads = value_and_grad(loss_from_feats)(ae_params, feats, *args)
        ae_updates, ae_opt_state = ae_tx.update(ae_grads, ae_opt_state, ae_params)
        ae_params = optim.apply_updates(ae_params, ae_updates)
        return ae_params, ae_opt_state, cnn_params, cnn_opt_state, loss

    return step


@torch.inference_mode()
def val_step(cfg: ae.AEConfig, variant: str, crop_size: int, cnn_apply, ae_params, cnn_params,
             images_u8, offsets, seq) -> torch.Tensor:
    """The deterministic NLL of one batch (center crops; every AE step
    through the step kernel on the card): vqa_arch with a zero sentence
    input and no skip, null with the true sequence as the encoder input."""
    feats = cnn_apply(cnn_params, prepro_wp_images(images_u8, offsets, crop_size))
    if variant == "vqa_arch":
        zeros = feats.new_zeros(seq.shape[1], 2 * cfg.rnn_size)
        return ae.apply_nll(ae_params, cfg, seq, imgs=feats, sent_input=zeros,
                            encoder_skip=False, deterministic=True)[0]
    return ae.apply_nll(ae_params, cfg, seq, imgs=feats, seq_input=seq, deterministic=True)[0]


def load_text_ae(params, path: str, device) -> dict:
    """``params`` with the lookup, encoder, decoder and (where both have
    one) multimodal fusion of a text-AE checkpoint (:143-153)."""
    flat, _ = load_npz(path)

    def t(key):
        return torch.tensor(np.asarray(flat[key], np.float32), device=device)

    def lstm(prefix):
        n = len({k[len(prefix):].split("/")[0] for k in flat if k.startswith(prefix)})
        return [{p: t(f"{prefix}{i}/{p}") for p in ("wx", "bx", "wh", "bh")} for i in range(n)]

    params = dict(params, lookup=t("lookup"), encoder=lstm("encoder/"),
                  decoder={"layers": lstm("decoder/layers/"), "proj_w": t("decoder/proj_w"),
                           "proj_b": t("decoder/proj_b")})
    if "multimodal/wq" in flat and "multimodal" in params:
        params["multimodal"] = {k: t(f"multimodal/{k}") for k in ("wq", "bq", "wi", "bi")}
    return params


def _norm(tree) -> float:
    return float(torch.sqrt(sum(torch.sum(p * p) for p in tree_leaves(tree))))


def main(argv=None):
    opt = parse_config(WPTrainConfig, argv, description=__doc__)
    if opt.data_parallel:
        raise NotImplementedError(
            "--data_parallel 1: multi-GPU training comes with the multi-GPU slice (ROADMAP A13)")
    if opt.remat:
        raise NotImplementedError(
            "--remat 1: recomputing the trunk in the finetune backward is not ported yet "
            "(ROADMAP A11, remat); it changes no result")
    device = resolve_device(opt.device)
    ckpt_dir = opt.checkpoint_path or "."
    os.makedirs(ckpt_dir, exist_ok=True)
    random.seed(opt.seed)  # math.randomseed(123) for the skip/zero coin flips

    loader = WeakPairedLoader(opt.input_h5, opt.input_json)
    cfg = ae.AEConfig(
        vocab_size=loader.vocab_size, input_encoding_size=opt.input_encoding_size,
        rnn_size=opt.rnn_size, num_layers=opt.num_layers, seq_length=loader.seq_length,
        dropout=opt.drop_prob_ae, variant=opt.variant,
        nhimage=opt.nhimage if opt.variant == "vqa_arch" else 0,
    )
    ae_params = ae.init_params(cfg, torch.Generator().manual_seed(opt.seed), device)
    if opt.start_from_text:
        ae_params = load_text_ae(ae_params, opt.start_from_text, device)
    with_projection = opt.variant == "null"  # build_cnn vs build_cnn_2
    cnn_params, cnn_apply, feat_dim = build_cnn(
        opt, with_projection, torch.Generator().manual_seed(opt.seed + 7), device)
    if opt.variant == "vqa_arch" and feat_dim != opt.nhimage:
        raise ValueError(f"--nhimage {opt.nhimage} != the {opt.cnn_arch} trunk's {feat_dim} features")

    lstm_mean = None
    if opt.lstm_average_path:
        with H5Reader(opt.lstm_average_path) as f:
            lstm_mean = np.asarray(f["mean_vector"], np.float32).reshape(-1)

    if opt.start_from:
        # warm restart of both nets (the reference reloads protos={ae,cnn}, :121-127)
        flat, _ = load_npz(opt.start_from)
        restored = vision_params_from_numpy(unflatten_like({"ae": ae_params, "cnn": cnn_params}, flat), device)
        ae_params, cnn_params = restored["ae"], restored["cnn"]
        print(f"initialized ae+cnn from {opt.start_from}")

    ae_tx, cnn_tx = make_ae_tx(opt), make_cnn_tx(opt)
    ae_opt_state, cnn_opt_state = ae_tx.init(ae_params), cnn_tx.init(cnn_params)

    start_iter = 0
    if opt.resume:
        flat, meta = load_npz(opt.resume)
        template = {"ae": ae_params, "cnn": cnn_params, "ae_opt": ae_opt_state, "cnn_opt": cnn_opt_state}
        restored = vision_params_from_numpy(unflatten_like(template, flat), device)
        ae_params, cnn_params = restored["ae"], restored["cnn"]
        ae_opt_state, cnn_opt_state = restored["ae_opt"], restored["cnn_opt"]
        start_iter = int(meta.get("iter", 0)) + 1
        print(f"resumed from {opt.resume} at iteration {start_iter}")
        # continue the i.i.d. streams (crops, coin flips, dropout) from new
        # seeds; the batch window is sequential, so its position is restored
        random.seed(opt.seed + start_iter)
        loader.iterators["train"] = int(meta.get("train_it_pos", 0))

    train_step = make_train_step(cfg, opt.variant, opt.crop_size, cnn_apply, ae_tx, cnn_tx)
    np_rng = np.random.default_rng(opt.seed + start_iter)
    generator = torch.Generator(device=device).manual_seed(opt.seed + 1 + start_iter)

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def eval_split(split):
        loader.reset_iterator(split)
        loss_sum, n_evals, n = 0.0, 0, 0
        while True:
            labels, images, bounds = loader.get_batch_with_images(split, opt.batch_size)
            offsets = center_crop_offsets(len(images), opt.image_size, opt.crop_size)
            loss_sum += float(val_step(cfg, opt.variant, opt.crop_size, cnn_apply, ae_params, cnn_params,
                                       to_dev(images), to_dev(offsets), to_dev(labels)))
            n_evals += 1
            n += labels.shape[1]
            if bounds["wrapped"] or 0 <= opt.val_sentences_use <= n:
                break
        return loss_sum / max(1, n_evals)

    it = start_iter
    loss0, best_score = None, None
    loss_history, val_loss_history = {}, {}
    with contextlib.ExitStack() as stack:
        stack.enter_context(trace(opt.profile_dir, device))
        stack.enter_context(nan_guard(bool(opt.debug_nans)))
        stack.enter_context(fp32_exact())
        while True:
            labels, images, _ = loader.get_batch_with_images("train", opt.batch_size)
            offsets = random_crop_offsets(np_rng, len(images), opt.image_size, opt.crop_size)
            skip = False
            sent_input = np.zeros((labels.shape[1], 2 * cfg.rnn_size), np.float32)
            seq_input = labels
            if opt.variant == "vqa_arch":
                if random.random() <= 0.5 and lstm_mean is not None:  # :296-301
                    skip = True
                    sent_input = np.tile(lstm_mean, (labels.shape[1], 1))
            elif random.random() <= opt.rand_val:  # arch2 zeroing (:291-293)
                seq_input = np.zeros_like(labels)

            finetune = 0 <= opt.finetune_cnn_after <= it
            ae_params, ae_opt_state, cnn_params, cnn_opt_state, loss = train_step(
                skip, finetune, ae_params, ae_opt_state, cnn_params, cnn_opt_state,
                to_dev(images), to_dev(offsets), to_dev(labels), to_dev(sent_input), to_dev(seq_input),
                generator,
            )

            if opt.losses_log_every > 0 and it % opt.losses_log_every == 0:
                f = float(loss)
                loss_history[it] = f
                # the update-magnitude diagnostics (004_train_arch1_...vgg.lua:372-376)
                print(f"iter {it}: loss {f:.4f} | paramsNorm: {_norm(ae_params):.4f} | "
                      f"cnnParamsNorm: {_norm(cnn_params):.4f} (skip={skip} finetune={finetune})")
                if loss0 is None:
                    loss0 = f
                if f > loss0 * 20:
                    print("loss seems to be exploding, quitting.")
                    break

            if it % opt.save_checkpoint_every == 0 or it == opt.max_iters - 1:
                val_loss = eval_split("val")
                val_loss_history[it] = val_loss
                print("validation loss:", val_loss)
                base = os.path.join(ckpt_dir, "model_id" + opt.id)
                with open(base + ".json", "w") as f:
                    json.dump({"opt": dataclasses.asdict(opt), "iter": it, "loss_history": loss_history,
                               "val_loss_history": val_loss_history}, f)
                score = -val_loss
                if best_score is None or score > best_score:
                    best_score = score
                    save_npz(base + ".npz", vision_params_to_numpy({"ae": ae_params, "cnn": cnn_params}),
                             meta={"cfg": cfg._asdict(), "iter": it, "val_loss": val_loss})
                    print("wrote BEST checkpoint to " + base + ".npz")
                if opt.save_train_state:
                    state = {"ae": ae_params, "cnn": cnn_params, "ae_opt": ae_opt_state,
                             "cnn_opt": cnn_opt_state}
                    save_npz(os.path.join(ckpt_dir, "train_state" + opt.id + ".npz"),
                             vision_params_to_numpy(state),
                             meta={"cfg": cfg._asdict(), "iter": it,
                                   # the sequential batch window's position, so a
                                   # resumed run continues mid-epoch
                                   "train_it_pos": int(loader.iterators.get("train", 0))})

            it += 1
            if 0 < opt.max_iters <= it:
                break

    loader.close()


if __name__ == "__main__":
    main()
