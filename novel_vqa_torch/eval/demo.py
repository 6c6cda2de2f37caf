"""Dataset browsing demo (copy of ``novel_vqa_tpu.eval.demo``) — text port of
004_vqa_evaluation/PythonHelperTools/vqaDemo.py.

The reference demo samples random annotations, prints their QA pairs
(vqa.showQA), and displays the image with matplotlib; this environment is
headless, so the port prints the QA pairs plus the image path (pass
``--show 1`` to attempt a matplotlib display when available).

Usage:
  python -m novel_vqa_torch.eval.demo --ann_file ... --ques_file ... [--n 3]
"""

from __future__ import annotations

import argparse
import random

from novel_vqa_torch.eval.vqa_api import VQA


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ann_file", required=True)
    ap.add_argument("--ques_file", required=True)
    ap.add_argument("--img_dir", default="")
    ap.add_argument("--n", default=3, type=int)
    ap.add_argument("--ans_type", default="", help="filter by answer type, e.g. yes/no")
    ap.add_argument("--seed", default=123, type=int)
    ap.add_argument("--show", default=0, type=int)
    args = ap.parse_args(argv)

    vqa = VQA(args.ann_file, args.ques_file)
    random.seed(args.seed)
    ids = vqa.getQuesIds(ansTypes=[args.ans_type] if args.ans_type else [])
    anns = vqa.loadQA(random.sample(ids, min(args.n, len(ids))))

    for ann in anns:
        quesId = ann["question_id"]
        print("Question: %s" % vqa.qqa[quesId]["question"])
        for ans in ann["answers"]:
            print("Answer %d: %s" % (ans["answer_id"], ans["answer"]))
        img_id = ann["image_id"]
        print(f"[image_id {img_id}]", args.img_dir or "")
        if args.show:
            try:
                import matplotlib.pyplot as plt
                import os

                from PIL import Image

                path = os.path.join(
                    args.img_dir, f"COCO_val2014_{img_id:012d}.jpg"
                )
                plt.imshow(Image.open(path))
                plt.axis("off")
                plt.show()
            except Exception as e:
                print(f"(display unavailable: {e})")
        print()
    return anns


if __name__ == "__main__":
    main()
