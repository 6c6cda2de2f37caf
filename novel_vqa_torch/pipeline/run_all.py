"""Full-pipeline orchestrator — BASELINE configs[4] as one command (copy of
``novel_vqa_tpu.pipeline.run_all``; every stage is the port's module).

Chains the numbered reference pipeline end to end:

  stage 0  vqa_preprocessing      (raw VQA v1 -> raw train/test JSONs)
  stage 1  novel_split stats/cluster/split  (or skip: use the frozen split)
  stage 2  prepro_book_corpus     (corpus -> data.{h5,json})
  stage 3  train_text_ae (+ optional train_weakpaired_ae) + convert_ae
  stage 4a prepro_vqa             (novel raw JSONs -> data_prepro.{json,h5})
  stage 4b extract_features       (COCO images -> fc7/pool h5)
  stage 5  train_vqa_arch1/arch2  (AE-initialized)
  stage 6  eval_vqa_* + eval.drivers (OE/MC accuracy incl. novel subset)

Like the reference's own scripts, each stage is skipped when its primary
output already exists (resume-after-crash semantics, e.g.
001_create_novel_statistics.py:89); ``--force`` re-runs everything and
``--dry_run`` prints the plan without executing.  Config is a JSON file of
per-stage argument lists — see ``example_config()`` (printed by
``--print_example_config``) for the shape; any stage can be omitted.  Stage
arguments pass through unchanged: the port's stages that use the card run
on ``cuda`` unless a stage's arguments add ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List


STAGES = [
    # (name, module main, primary output key)
    ("vqa_preprocessing", "novel_vqa_torch.pipeline.vqa_preprocessing", "cli"),
    ("novel_stats", "novel_vqa_torch.pipeline.novel_split", "cli"),
    ("novel_cluster", "novel_vqa_torch.pipeline.novel_split", "cli"),
    ("novel_split", "novel_vqa_torch.pipeline.novel_split", "cli"),
    ("prepro_book_corpus", "novel_vqa_torch.pipeline.prepro_book_corpus", "cli"),
    ("train_text_ae", "novel_vqa_torch.train.train_text_ae", "main"),
    ("train_weakpaired_ae", "novel_vqa_torch.train.train_weakpaired_ae", "main"),
    ("convert_ae", "novel_vqa_torch.train.convert_ae", "main"),
    ("prepro_vqa", "novel_vqa_torch.pipeline.prepro_vqa", "cli"),
    ("extract_features", "novel_vqa_torch.train.extract_features", "main"),
    ("train_vqa_arch1", "novel_vqa_torch.train.train_vqa_arch1", "main"),
    ("train_vqa_arch2", "novel_vqa_torch.train.train_vqa_arch2", "main"),
    ("eval_vqa_arch1", "novel_vqa_torch.train.eval_vqa_arch1", "main"),
    ("eval_vqa_arch2", "novel_vqa_torch.train.eval_vqa_arch2", "main"),
    ("evaluate", "novel_vqa_torch.eval.drivers", "main"),
]


def example_config() -> Dict:
    return {
        "prepro_book_corpus": {
            "args": ["--corpus", "books_p1.txt", "--corpus", "books_p2.txt",
                     "--vqa_vocab", "vocabs/vocab_train.json",
                     "--novel_vocab", "vocabs/list_of_novel_words.json",
                     "--output_h5", "data.h5", "--output_json", "data.json"],
            "output": "data.h5",
        },
        "train_text_ae": {
            "args": ["--input_h5", "data.h5", "--input_json", "data.json",
                     "--checkpoint_path", "ae/"],
            "output": "ae/model_id.npz",
        },
        "convert_ae": {
            "args": ["--ae_model", "ae/model_id.npz", "--out", "converted.h5"],
            "output": "converted.h5",
        },
        "prepro_vqa": {
            "args": ["--input_train_json", "train_raw_novel_2.json",
                     "--input_test_json", "val_raw_novel_2.json",
                     "--num_ans", "1000",
                     "--extern_vocab", "vocabs/vocab_oracle.json",
                     "--extern_ans_vocab", "vocabs/oracle_extern_ans_vocab.json"],
            "output": "data_prepro.h5",
        },
        "extract_features": {
            "args": ["--input_json", "data_prepro.json", "--image_root", "coco/",
                     "--model", "vgg16", "--weights", "vgg16.npz"],
            "output": "data_img.h5",
        },
        "train_vqa_arch1": {
            "args": ["--init_from", "converted.h5", "--rnn_layer", "1",
                     "--input_encoding_size", "512", "--learning_rate", "1e-4",
                     "--max_iters", "25000", "--checkpoint_path", "model/"],
            "output": "model/lstm.h5",
        },
        "eval_vqa_arch1": {
            "args": ["--model_path", "model/lstm.h5", "--out_path", "result/"],
            "output": "result/OpenEnded_mscoco_val2014_lstm_novel_new_2_results.json",
        },
        "evaluate": {
            "args": ["--data_dir", "004_vqa_evaluation",
                     "--ques_id_hist", "ques_id_hist.json"],
        },
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="", help="JSON config of per-stage args")
    ap.add_argument("--dry_run", action="store_true")
    ap.add_argument("--force", action="store_true", help="re-run even if outputs exist")
    ap.add_argument("--print_example_config", action="store_true")
    args = ap.parse_args(argv)

    if args.print_example_config:
        print(json.dumps(example_config(), indent=2))
        return

    with open(args.config) as f:
        config: Dict[str, Dict] = json.load(f)

    known = {name for name, _, _ in STAGES}
    unknown = set(config) - known
    if unknown:
        raise ValueError(f"unknown stages in config: {sorted(unknown)}; known: {sorted(known)}")

    for name, module, entry in STAGES:
        if name not in config:
            continue
        stage = config[name]
        stage_args: List[str] = list(stage.get("args", []))
        output = stage.get("output")
        if output and os.path.exists(output) and not args.force:
            print(f"[{name}] SKIP — output exists: {output}")
            continue
        print(f"[{name}] python -m {module} " + " ".join(stage_args))
        if args.dry_run:
            continue
        import importlib

        mod = importlib.import_module(module)
        getattr(mod, entry)(stage_args)
        if output and not os.path.exists(output):
            print(f"[{name}] WARNING: declared output {output} was not produced",
                  file=sys.stderr)
    print("pipeline complete")


if __name__ == "__main__":
    main()
