"""Compute the mean LSTM sentence vector and mean image vector h5 inputs of
the weak-paired trainers (port of
``novel_vqa_tpu.train.compute_mean_vectors``).

The reference reads ``-lstm_average_path`` / ``-img_average_path`` h5 files
with a ``/mean_vector`` dataset (004_train_arch1_weakpaired_autoencoder_vgg.lua:104-114)
but ships no producer; this tool makes them:

  lstm   a text-AE checkpoint's encoder over a corpus split, the packed
         final [c, h] state averaged -> (1, 2H) ``/mean_vector``; the encode
         is deterministic, so on the card every step runs the step kernel;
         each sentence counts once, the wrapping last batch included;
  image  the rows of an ``images_train`` feature h5 averaged, optionally
         L2-normalized first (the trainer normalizes the mean image vector
         likewise, :110-113) -> (1, D).

The h5 files are read and written by the port's ``core/h5.py``.  Same flags
as the JAX CLI plus ``--device`` (``lstm`` only).

    python -m novel_vqa_torch.train.compute_mean_vectors lstm --ae_model ae/model_id.npz \\
        --input_h5 data.h5 --input_json data.json --out lstm_mean.h5
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from novel_vqa_torch.core.h5 import H5Reader, write_h5


def run_lstm(args):
    from novel_vqa_torch.core.checkpoint import load_npz
    from novel_vqa_torch.core.device import resolve_device
    from novel_vqa_torch.data.corpus import CorpusLoader
    from novel_vqa_torch.models.seq import autoencoder as ae

    device = resolve_device(args.device)
    flat, meta = load_npz(args.ae_model)
    if "lookup" not in flat and any(k.startswith("ae/") for k in flat):
        flat = {k[3:]: v for k, v in flat.items() if k.startswith("ae/")}  # a weak-paired checkpoint
    loader = CorpusLoader(args.input_h5, args.input_json)
    cfg_meta = meta.get("cfg", {})
    cfg = ae.AEConfig(
        vocab_size=loader.vocab_size,
        input_encoding_size=cfg_meta.get("input_encoding_size", args.input_encoding_size),
        rnn_size=cfg_meta.get("rnn_size", args.rnn_size),
        num_layers=cfg_meta.get("num_layers", 1),
        seq_length=loader.seq_length,
        variant=cfg_meta.get("variant", "text_nostart"),
    )

    def t(key):
        return torch.tensor(np.asarray(flat[key], np.float32), device=device)

    n_enc = len({k.split("/")[1] for k in flat if k.startswith("encoder/")})
    params = {"lookup": t("lookup"),
              "encoder": [{p: t(f"encoder/{i}/{p}") for p in ("wx", "bx", "wh", "bh")} for i in range(n_enc)]}

    total = np.zeros((2 * cfg.rnn_size,), np.float64)
    count = 0
    n_split = loader.split_count[args.split]
    loader.reset_iterator(args.split)
    while True:
        start = loader.iterators[args.split]
        labels, bounds = loader.get_batch(args.split, args.batch_size)
        if bounds["wrapped"] and start == n_split - 1:
            # one row left: the loader reads rows [0, B) here, whose first
            # row is row 0 again (the JAX tool counts it twice and never
            # counts row n-1, ROADMAP C1).  Encode the window it reads
            # when more rows are left, [n-1, 0, ..., B-2], first row n-1.
            ds = loader.h5.dataset(f"labels/{args.split}")
            window = np.concatenate([ds[start:n_split], ds[0 : args.batch_size - 1]])
            labels = np.ascontiguousarray(window.astype(np.int32).T)
        with torch.inference_mode():
            c, h = ae.encode(params, cfg, torch.from_numpy(labels).to(device))
            vecs = torch.cat([c[-1], h[-1]], dim=-1).cpu().numpy()  # the [c, h] layout
        if bounds["wrapped"]:
            # the wrapping batch re-reads head sentences: each counts once
            vecs = vecs[: n_split - count]
        total += vecs.sum(axis=0)
        count += vecs.shape[0]
        if bounds["wrapped"] or (0 < args.max_sentences <= count):
            break
    mean = (total / count).astype(np.float32)[None, :]
    write_h5(args.out, {"mean_vector": mean})
    print(f"wrote {args.out} from {count} sentences, shape {mean.shape}")
    loader.close()


def run_image(args):
    with H5Reader(args.input_img_h5) as f:
        feats = f[args.dataset]
    if args.l2_normalize:
        feats = feats / np.linalg.norm(feats, axis=1, keepdims=True)
    mean = feats.mean(axis=0, dtype=np.float64).astype(np.float32)[None, :]
    write_h5(args.out, {"mean_vector": mean})
    print(f"wrote {args.out}, shape {mean.shape}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("lstm")
    p.add_argument("--ae_model", required=True)
    p.add_argument("--input_h5", required=True)
    p.add_argument("--input_json", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--batch_size", default=256, type=int)
    p.add_argument("--max_sentences", default=-1, type=int)
    p.add_argument("--rnn_size", default=512, type=int)
    p.add_argument("--input_encoding_size", default=512, type=int)
    p.add_argument("--out", default="lstm_mean.h5")
    p.add_argument("--device", default="cuda")

    p = sub.add_parser("image")
    p.add_argument("--input_img_h5", required=True)
    p.add_argument("--dataset", default="images_train")
    p.add_argument("--l2_normalize", default=0, type=int)
    p.add_argument("--out", default="img_mean.h5")

    args = ap.parse_args(argv)
    if args.cmd == "lstm":
        run_lstm(args)
    else:
        run_image(args)


if __name__ == "__main__":
    main()
