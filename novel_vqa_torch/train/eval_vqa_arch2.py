"""Arch2 VQA test-split inference CLI, on the card by default: port of
003_train_vqa_arch2/004_eval_model{,_baseline}.lua (cnn_projection ->
encoder -> classifier, :245-253; OE argmax and MC argmax over the choices,
as arch1's eval).

Loads arch2's flat ``lstm.h5`` ({cnn_w, encoder_w_q, multimodal_w}),
forwards every test question in fixed-size batches (each batch's 18
encoder steps through the step kernel at one layer, T=16) and writes the
OpenEnded and MultipleChoice result JSONs.  ``--dump_scores_h5`` adds the
raw score matrix as dataset ``<dump_scores_key>Test`` to that file, keeping
its other datasets (the late-fusion input).

    python -m novel_vqa_torch.train.eval_vqa_arch2 --model_path models_vqa/lstm.h5
    python -m novel_vqa_torch.train.eval_vqa_arch2 ... --device cpu
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from novel_vqa_torch.core.checkpoint import arch2_from_flat, load_flat_h5
from novel_vqa_torch.core.config import parse_config
from novel_vqa_torch.core.convert import arch2_params_from_numpy
from novel_vqa_torch.core.h5 import update_h5
from novel_vqa_torch.data.vqa import VQAData
from novel_vqa_torch.models.vqa import arch2
from novel_vqa_torch.models.vqa.predict import host_mc_predict
from novel_vqa_torch.parallel.mesh import cli_group
from novel_vqa_torch.train.eval_loop import run_full_split


@dataclasses.dataclass
class EvalConfig:
    input_img_h5: str = "data_img.h5"
    input_ques_h5: str = "data_prepro.h5"
    input_json: str = "data_prepro.json"
    model_path: str = "models_vqa/lstm.h5"
    batch_size: int = 500
    input_encoding_size: int = 512
    rnn_size: int = 512
    num_layers: int = 1
    num_output: int = 1000
    img_norm: int = 1
    # per-part L2 dims for early-fusion features, e.g. "2048,4096"
    img_norm_split: str = ""
    nhimage: int = 4096
    drop_prob_ae: float = 0.5
    out_path: str = "result/"
    result_name: str = "mscoco_val2014_lstm_novel_new_2"
    dump_scores_h5: str = ""  # write raw score vectors (late-fusion input)
    dump_scores_key: str = "Out"
    # 1 = data-parallel over the process group (torchrun: one process per
    # card; parallel/mesh.py): each rank forwards its slice of every batch,
    # the encoder's can_skip spanning the global batch
    data_parallel: int = 0
    # 1 (default) = upload the test split once and gather batches on the
    # device; 0 = stream each batch host->device
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
    # full fp32 in the projection/classifier products, as the CPU reference
    torch.backends.cuda.matmul.allow_tf32 = False
    if writer:
        os.makedirs(opt.out_path, exist_ok=True)

    data = VQAData(
        opt.input_ques_h5,
        opt.input_img_h5,
        opt.input_json,
        img_norm=bool(opt.img_norm),
        load_test=True,
        align="left",
        img_norm_split_dims=(
            [int(x) for x in opt.img_norm_split.split(",")] if opt.img_norm_split else None
        ),
    )
    cfg = arch2.Arch2Config(
        vocab_size=data.vocab_size,
        input_encoding_size=opt.input_encoding_size,
        rnn_size=opt.rnn_size,
        num_layers=opt.num_layers,
        nhimage=opt.nhimage,
        num_output=opt.num_output,
        seq_length=data.seq_length,
        dropout=opt.drop_prob_ae,
    )
    params = arch2_params_from_numpy(arch2_from_flat(load_flat_h5(opt.model_path), cfg), device)

    # --dump_scores_h5 needs the score matrix on the host; otherwise only
    # the two prediction vectors come back (device-side argmax)
    need_scores = bool(opt.dump_scores_h5) or not opt.hbm_resident
    pred, mc_pred, scores = run_full_split(
        arch2, cfg, params, data, "test", opt.batch_size,
        hbm_resident=bool(opt.hbm_resident),
        group=group,
        want="scores" if need_scores else "predict",
    )
    qids = data.d["question_id_test"]
    if pred is None:
        pred = scores.argmax(axis=1) + 1  # 1-indexed answer ids
    if not writer:  # only rank 0 writes the result files
        return scores, qids

    ix_to_ans = data.ix_to_ans
    oe = [{"question_id": int(q), "answer": ix_to_ans[str(int(p))]} for q, p in zip(qids, pred)]
    oe_path = os.path.join(opt.out_path, f"OpenEnded_{opt.result_name}_results.json")
    with open(oe_path, "w") as f:
        json.dump(oe, f)
    print("wrote", oe_path)

    mc_ans = data.d.get("mc_ans_test")
    if mc_ans is not None:
        if mc_pred is None:  # streaming path: argmax over the choices on host
            mc_pred = host_mc_predict(scores, mc_ans, pred)
        mc = [{"question_id": int(q), "answer": ix_to_ans[str(int(p))]} for q, p in zip(qids, mc_pred)]
        mc_path = os.path.join(opt.out_path, f"MultipleChoice_{opt.result_name}_results.json")
        with open(mc_path, "w") as f:
            json.dump(mc, f)
        print("wrote", mc_path)

    if opt.dump_scores_h5:
        update_h5(opt.dump_scores_h5, {f"{opt.dump_scores_key}Test": scores})
        print("wrote scores to", opt.dump_scores_h5)
    return scores, qids


if __name__ == "__main__":
    main()
