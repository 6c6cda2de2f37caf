"""Evaluation drivers (copy of ``novel_vqa_tpu.eval.drivers``) — ports of
004_vqa_evaluation/PythonEvaluationTools/evaluate_{openended,multiplechoice}_{novel,orig}.py.

The reference hardcodes its data dir and the ``_novel_new_2`` suffix; here the
same file-naming scheme is parameterized:

  annotations: <data_dir>/Annotations/<dataType>_<dataSubType><suffix>_annotations.json
  questions:   <data_dir>/Questions/<taskType>_<dataType>_<dataSubType><suffix>_questions.json
  results:     <data_dir>/Results/<taskType>_<dataType>_<dataSubType>_<resultType><suffix>_results.json

Output matches the reference line
``Ov: .. Oth: .. Num: .. Y/N: .. [Nov: ..]`` (evaluate_openended_novel.py:50)
and the five accuracy numbers are returned/dumped as JSON for tooling.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

from novel_vqa_torch.eval.vqa_api import VQA
from novel_vqa_torch.eval.vqa_eval import VQAEval


def evaluate(
    ann_file: str,
    ques_file: str,
    res_file: str,
    ques_id_hist: Optional[str] = None,
    n: int = 2,
) -> Dict[str, float]:
    vqa = VQA(ann_file, ques_file)
    vqaRes = vqa.loadRes(res_file, ques_file)
    vqaEval = VQAEval(vqa, vqaRes, n=n)

    vqaEval.evaluate()
    out = {
        "overall": vqaEval.accuracy["overall"],
        "other": vqaEval.accuracy["perAnswerType"].get("other"),
        "number": vqaEval.accuracy["perAnswerType"].get("number"),
        "yes/no": vqaEval.accuracy["perAnswerType"].get("yes/no"),
        "perQuestionType": vqaEval.accuracy["perQuestionType"],
    }
    if ques_id_hist:
        with open(ques_id_hist) as f:
            hist = json.load(f)
        # bucket '0' = novel question ids (evaluate_openended_novel.py:38,47)
        vqaEval.evaluate(hist["0"])
        out["novel"] = vqaEval.accuracy["overall"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="Official VQA accuracy evaluation")
    ap.add_argument("--task_type", default="OpenEnded", choices=["OpenEnded", "MultipleChoice"])
    ap.add_argument("--data_type", default="mscoco")
    ap.add_argument("--data_subtype", default="val2014")
    ap.add_argument("--suffix", default="_novel_new_2", help="split suffix, e.g. _novel_new_2, _novel, or ''")
    ap.add_argument("--result_type", default="lstm")
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--ann_file", default="", help="override annotation path")
    ap.add_argument("--ques_file", default="", help="override question path")
    ap.add_argument("--res_file", default="", help="override result path")
    ap.add_argument("--ques_id_hist", default="", help="ques_id_hist.json for the novel subset")
    ap.add_argument("--out_json", default="", help="write accuracy dict here")
    args = ap.parse_args(argv)

    d = args.data_dir
    ann = args.ann_file or os.path.join(
        d, "Annotations", f"{args.data_type}_{args.data_subtype}{args.suffix}_annotations.json"
    )
    ques = args.ques_file or os.path.join(
        d, "Questions", f"{args.task_type}_{args.data_type}_{args.data_subtype}{args.suffix}_questions.json"
    )
    res = args.res_file or os.path.join(
        d, "Results", f"{args.task_type}_{args.data_type}_{args.data_subtype}_{args.result_type}{args.suffix}_results.json"
    )
    acc = evaluate(ann, ques, res, ques_id_hist=args.ques_id_hist or None)
    line = "Ov: %.2f Oth: %.2f Num: %.2f Y/N: %.2f" % (
        acc["overall"],
        acc["other"] if acc["other"] is not None else float("nan"),
        acc["number"] if acc["number"] is not None else float("nan"),
        acc["yes/no"] if acc["yes/no"] is not None else float("nan"),
    )
    if "novel" in acc:
        line += " Nov: %.2f" % acc["novel"]
    print(line)
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(acc, f, indent=1)
    return acc


if __name__ == "__main__":
    main()
