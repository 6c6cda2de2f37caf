"""Arch1 VQA test-split inference CLI, on the card by default: port of
002_train_vqa_arch1/004_eval_model.lua (and its _wp/_ef variants via
``--fusion`` / ``--nhimage`` / ``--img_norm_split``).

Loads the flat-parameter checkpoint (the h5 form of the reference's
``lstm.t7`` {encoder_w_q, embedding_w_q, multimodal_w}, :149-163), forwards
every test question in fixed-size batches and writes:
  * OpenEnded results: argmax over all answers -> ix_to_ans (:255,:259-260);
  * MultipleChoice results: argmax over the non-zero choices (:258-273).

    python -m novel_vqa_torch.train.eval_vqa_arch1 --model_path model/lstm.h5
    python -m novel_vqa_torch.train.eval_vqa_arch1 ... --device cpu
    torchrun --standalone --nproc_per_node=<cards> -m \\
        novel_vqa_torch.train.eval_vqa_arch1 ... --data_parallel 1
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from novel_vqa_torch.core.checkpoint import arch1_from_flat, load_flat_h5
from novel_vqa_torch.core.config import parse_config
from novel_vqa_torch.core.convert import arch1_params_from_numpy
from novel_vqa_torch.data.vqa import VQAData
from novel_vqa_torch.models.vqa import arch1
from novel_vqa_torch.models.vqa.predict import host_mc_predict
from novel_vqa_torch.parallel.mesh import cli_group
from novel_vqa_torch.train.eval_loop import run_full_split


@dataclasses.dataclass
class EvalConfig:
    input_img_h5: str = "data_img.h5"
    input_ques_h5: str = "data_prepro.h5"
    input_json: str = "data_prepro.json"
    model_path: str = "model/lstm.h5"
    batch_size: int = 500
    nhimage: int = 4096
    input_encoding_size: int = 200
    rnn_size: int = 512
    rnn_layer: int = 2
    common_embedding_size: int = 1024
    num_output: int = 1000
    img_norm: int = 1
    img_norm_split: str = ""  # e.g. "2048,4096" for early-fusion split norm
    fusion: str = "axb"
    out_path: str = "result/"
    result_name: str = "mscoco_val2014_lstm_novel_new_2"
    seed: int = 123
    # 1 = data-parallel over the process group (torchrun: one process per
    # card; parallel/mesh.py): each rank forwards its slice of every batch
    data_parallel: int = 0
    # 1 (default) = upload the test split ONCE and gather batches on the
    # device; 0 = stream each batch host->device (for stores larger than
    # device memory)
    hbm_resident: int = 1
    device: str = "cuda"


def main(argv=None):
    opt = parse_config(EvalConfig, argv, description=__doc__)
    group = cli_group(opt.data_parallel, opt.device, opt.batch_size)
    try:
        return _run(opt, group)
    finally:
        group.close()


def _run(opt: EvalConfig, group):
    device = group.device
    writer = group.is_writer
    # full fp32 in the fusion/classifier products, as the CPU reference
    torch.backends.cuda.matmul.allow_tf32 = False
    if writer:
        os.makedirs(opt.out_path, exist_ok=True)

    split_dims = (
        [int(x) for x in opt.img_norm_split.split(",")] if opt.img_norm_split else None
    )
    data = VQAData(
        opt.input_ques_h5,
        opt.input_img_h5,
        opt.input_json,
        img_norm=bool(opt.img_norm),
        load_test=True,
        img_norm_split_dims=split_dims,
    )
    cfg = arch1.Arch1Config(
        vocab_size=data.vocab_size,
        input_encoding_size=opt.input_encoding_size,
        rnn_size=opt.rnn_size,
        rnn_layer=opt.rnn_layer,
        nhimage=opt.nhimage,
        common_embedding_size=opt.common_embedding_size,
        num_output=opt.num_output,
        fusion=opt.fusion,
    )
    params = arch1_params_from_numpy(
        arch1_from_flat(load_flat_h5(opt.model_path), cfg), device
    )

    pred, mc_pred, scores = run_full_split(
        arch1, cfg, params, data, "test", opt.batch_size,
        hbm_resident=bool(opt.hbm_resident),
        group=group,
        want="predict" if opt.hbm_resident else "scores",
    )
    qids = data.d["question_id_test"]
    if pred is None:
        pred = scores.argmax(axis=1) + 1  # 1-indexed answer ids
    if not writer:  # only rank 0 writes the result files
        return scores, qids

    ix_to_ans = data.ix_to_ans
    oe = [
        {"question_id": int(q), "answer": ix_to_ans[str(int(p))]}
        for q, p in zip(qids, pred)
    ]
    oe_path = os.path.join(opt.out_path, f"OpenEnded_{opt.result_name}_results.json")
    with open(oe_path, "w") as f:
        json.dump(oe, f)
    print("wrote", oe_path)

    mc_ans = data.d.get("mc_ans_test")
    if mc_ans is not None:
        if mc_pred is None:  # streaming path: argmax over the choices on host
            mc_pred = host_mc_predict(scores, mc_ans, pred)
        mc = [
            {"question_id": int(q), "answer": ix_to_ans[str(int(p))]}
            for q, p in zip(qids, mc_pred)
        ]
        mc_path = os.path.join(
            opt.out_path, f"MultipleChoice_{opt.result_name}_results.json"
        )
        with open(mc_path, "w") as f:
            json.dump(mc, f)
        print("wrote", mc_path)

    return scores, qids


if __name__ == "__main__":
    main()
