"""Stage L0: flatten VQA v1 annotations + questions into raw train/test JSONs.

Copy of ``novel_vqa_tpu.pipeline.vqa_preprocessing``, a Python-3 port of
000_create_dataset/000_vqa_preprocessing.py: split 1 trains
on train2014 and tests on val2014; split 2 trains on train2014+val2014 and
tests on test2015 (:44-113).  Output records
``{ques_id, img_path, question, MC_ans[, ans]}`` with COCO image paths
``<subtype>/COCO_<subtype>_<%012d>.jpg`` (:42).

The reference's ``download_vqa`` wget/unzip helper (:14-29) is not usable in
this zero-egress environment; point ``--annotations_dir`` at an existing
download instead.
"""

from __future__ import annotations

import argparse
import json
import os


def main(params):
    ann_dir = params["annotations_dir"]
    train, test = [], []
    imdir = "%s/COCO_%s_%012d.jpg"

    def load(name):
        with open(os.path.join(ann_dir, name)) as f:
            return json.load(f)

    def flatten(anno, ques, subtype, with_ans):
        out = []
        for i in range(len(anno["annotations"])):
            a = anno["annotations"][i]
            q = ques["questions"][i]
            rec = {
                "ques_id": a["question_id"],
                "img_path": imdir % (subtype, subtype, a["image_id"]),
                "question": q["question"],
                "MC_ans": q["multiple_choices"],
            }
            if with_ans:
                rec["ans"] = a["multiple_choice_answer"]
            out.append(rec)
        return out

    train_anno = load("mscoco_train2014_annotations.json")
    val_anno = load("mscoco_val2014_annotations.json")
    train_ques = load("MultipleChoice_mscoco_train2014_questions.json")
    val_ques = load("MultipleChoice_mscoco_val2014_questions.json")

    if params["split"] == 1:
        train = flatten(train_anno, train_ques, "train2014", with_ans=True)
        # split 1 "test" = val2014 without the single-answer field (:64-73)
        test = flatten(val_anno, val_ques, "val2014", with_ans=False)
    else:
        train = flatten(train_anno, train_ques, "train2014", with_ans=True)
        train += flatten(val_anno, val_ques, "val2014", with_ans=True)
        test_ques = load("MultipleChoice_mscoco_test2015_questions.json")
        for q in test_ques["questions"]:
            test.append(
                {
                    "ques_id": q["question_id"],
                    "img_path": imdir % ("test2015", "test2015", q["image_id"]),
                    "question": q["question"],
                    "MC_ans": q["multiple_choices"],
                }
            )

    print("Training sample %d, Testing sample %d..." % (len(train), len(test)))
    with open(params["output_train"], "w") as f:
        json.dump(train, f)
    with open(params["output_test"], "w") as f:
        json.dump(test, f)


def cli(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--annotations_dir", default="annotations/")
    parser.add_argument("--split", default=1, type=int)
    parser.add_argument("--output_train", default="vqa_raw_train.json")
    parser.add_argument("--output_test", default="vqa_raw_test.json")
    args = parser.parse_args(argv)
    main(vars(args))


if __name__ == "__main__":
    cli()
