"""Late-fusion ensemble, on the card by default: port of
``novel_vqa_tpu.train.lf_ensemble`` (002_train_vqa_arch1/
003_compute_lf_answers.lua, score vectors over train/val/test into one h5,
``/<prefix>Out{Train,Val,Test}``, :373-482; and 004_eval_model_lf.lua, a
weighted sum of two stored score sets over the test split -> argmax ->
OE/MC result JSONs, no model forward, :96-188).

Subcommands:
  compute  run an arch1 model over the requested splits, writing each
           split's ``<prefix>Out<Split>`` (n, num_output) float32 score
           matrix to ``--out_h5`` as it finishes (run once per member net,
           e.g. prefix VGG, then Inception).  The forward is the eval
           CLI's (``train/eval_loop.run_full_split``, either store mode):
           on the card each batch runs the seq kernel once per LSTM layer.
  eval     scores = w_vgg * VGGOutTest + w_inception * InceptionOutTest on
           the host, then the OE argmax and the best valid MC choice; the
           JSONs are the JAX tool's byte for byte.

The h5 files go through the port's ``core/h5.py``.  ``update_h5`` replaces
a dataset of the same name and keeps every other one, as h5py's mode
``"a"`` does, by writing the file anew: the kept datasets are copied from
the old file in chunks, so an append costs a copy of the file on disk but
never holds it in memory (the train split's scores are about 1 GB at VQA v1
scale).  Same flags as the JAX CLI plus ``--device`` on ``compute``;
``--data_parallel 1`` under ``torchrun`` forwards each rank's slice of
every batch and rank 0 writes (``parallel/mesh.py``).

    python -m novel_vqa_torch.train.lf_ensemble compute --model_path vgg/lstm.h5 \\
        --input_img_h5 data_img.h5 --input_ques_h5 data_prepro.h5 \\
        --input_json data_prepro.json --prefix VGG
    python -m novel_vqa_torch.train.lf_ensemble eval --input_ques_h5 data_prepro.h5 \\
        --input_json data_prepro.json
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from novel_vqa_torch.core.checkpoint import arch1_from_flat, load_flat_h5
from novel_vqa_torch.core.convert import arch1_params_from_numpy
from novel_vqa_torch.core.h5 import H5Reader, update_h5
from novel_vqa_torch.data.vqa import VQAData
from novel_vqa_torch.models.vqa import arch1
from novel_vqa_torch.parallel.mesh import cli_group
from novel_vqa_torch.train.eval_loop import run_full_split


def run_compute(args):
    group = cli_group(args.data_parallel, args.device, args.batch_size)
    try:
        _compute(args, group)
    finally:
        group.close()


def _compute(args, group):
    device = group.device
    # full fp32 in the fusion/classifier products, as the CPU reference
    torch.backends.cuda.matmul.allow_tf32 = False
    splits = args.splits.split(",")
    # the dataset and the params are split-independent: built once, so the
    # train store is read and L2-normalized once for all splits
    data = VQAData(
        args.input_ques_h5,
        args.input_img_h5,
        args.input_json,
        img_norm=bool(args.img_norm),
        splits=tuple(splits),
    )
    cfg = arch1.Arch1Config(
        vocab_size=data.vocab_size,
        input_encoding_size=args.input_encoding_size,
        rnn_size=args.rnn_size,
        rnn_layer=args.rnn_layer,
        nhimage=args.nhimage,
        common_embedding_size=args.common_embedding_size,
        num_output=args.num_output,
        fusion=args.fusion,
    )
    params = arch1_params_from_numpy(arch1_from_flat(load_flat_h5(args.model_path), cfg), device)
    for split in splits:
        _, _, scores = run_full_split(
            arch1, cfg, params, data, split, args.batch_size,
            hbm_resident=bool(args.hbm_resident), group=group,
            want="scores",
        )
        key = f"{args.prefix}Out{split.capitalize()}"
        if group.is_writer:  # only rank 0 writes
            update_h5(args.out_h5, {key: scores})
            print("wrote", key)


def run_eval(args):
    with H5Reader(args.scores_h5) as f:
        vgg = f["VGGOutTest"]
        inception = f["InceptionOutTest"]
    scores = args.weight_vgg * vgg + args.weight_inception * inception

    with open(args.input_json) as f:
        meta = json.load(f)
    ix_to_ans = meta["ix_to_ans"]
    with H5Reader(args.input_ques_h5) as f:
        qids = f["question_id_test"]
        mc_ans = f["MC_ans_test"] if "MC_ans_test" in f else None
    if scores.shape[0] != qids.shape[0]:
        raise ValueError(
            f"{args.scores_h5}: {scores.shape[0]} test rows of scores, "
            f"{args.input_ques_h5}: {qids.shape[0]} test questions"
        )

    os.makedirs(args.out_path, exist_ok=True)
    pred = scores.argmax(axis=1) + 1
    oe = [
        {"question_id": int(q), "answer": ix_to_ans[str(int(p))]}
        for q, p in zip(qids, pred)
    ]
    oe_path = os.path.join(args.out_path, f"OpenEnded_{args.result_name}_results.json")
    with open(oe_path, "w") as f:
        json.dump(oe, f)
    print("wrote", oe_path)

    if mc_ans is not None:
        mc = []
        for i in range(len(qids)):
            valid = mc_ans[i][mc_ans[i] != 0].astype(np.int64)
            best = (
                int(valid[np.argmax(scores[i, valid - 1])]) if valid.size else int(pred[i])
            )
            mc.append({"question_id": int(qids[i]), "answer": ix_to_ans[str(best)]})
        mc_path = os.path.join(
            args.out_path, f"MultipleChoice_{args.result_name}_results.json"
        )
        with open(mc_path, "w") as f:
            json.dump(mc, f)
        print("wrote", mc_path)


def cli(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("compute")
    p.add_argument("--input_img_h5", required=True)
    p.add_argument("--input_ques_h5", required=True)
    p.add_argument("--input_json", required=True)
    p.add_argument("--model_path", required=True)
    p.add_argument("--out_h5", default="outputVectors.h5")
    p.add_argument("--prefix", default="VGG", help="VGG | Inception")
    p.add_argument("--splits", default="train,val,test")
    p.add_argument("--batch_size", default=500, type=int)
    p.add_argument("--img_norm", default=1, type=int)
    p.add_argument("--input_encoding_size", default=200, type=int)
    p.add_argument("--rnn_size", default=512, type=int)
    p.add_argument("--rnn_layer", default=2, type=int)
    p.add_argument("--nhimage", default=4096, type=int)
    p.add_argument("--common_embedding_size", default=1024, type=int)
    p.add_argument("--num_output", default=1000, type=int)
    p.add_argument("--fusion", default="axb")
    p.add_argument(
        "--data_parallel", default=0, type=int,
        help="1 = data-parallel over the process group (torchrun: one "
        "process per card): each rank forwards its slice of every batch",
    )
    p.add_argument(
        "--hbm_resident", default=1, type=int,
        help="1 = upload each split store once and gather batches on the "
        "device; 0 = stream every batch host->device",
    )
    p.add_argument("--device", default="cuda")

    p = sub.add_parser("eval")
    p.add_argument("--scores_h5", default="outputVectors.h5")
    p.add_argument("--input_ques_h5", required=True)
    p.add_argument("--input_json", required=True)
    p.add_argument("--weight_vgg", default=0.5, type=float)
    p.add_argument("--weight_inception", default=0.5, type=float)
    p.add_argument("--out_path", default="result/")
    p.add_argument("--result_name", default="mscoco_lstm")

    args = parser.parse_args(argv)
    if args.cmd == "compute":
        run_compute(args)
    else:
        run_eval(args)


if __name__ == "__main__":
    cli()
