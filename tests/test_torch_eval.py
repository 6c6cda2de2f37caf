"""The port's VQA evaluator (``novel_vqa_torch.eval``) against the JAX
package's: identical accuracies overall, per answer type, per question type,
per question and on the novel subset, for the OpenEnded and MultipleChoice
result JSONs that the port's eval CLI writes in tests/test_torch_eval_cli.py;
the normalisation cases of tests/test_vqa_eval.py in both packages; and the
same normalisation tables, byte for byte."""

import importlib
import json
from pathlib import Path

import h5py
import numpy as np
import pytest

from novel_vqa_tpu.eval import drivers as jdrivers
from novel_vqa_torch.eval import drivers as tdrivers
from novel_vqa_torch.train import eval_vqa_arch1 as teval
from test_torch_eval_cli import NAMES, _argv, synthetic_dataset  # noqa: F401 (fixture)

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = ("novel_vqa_tpu", "novel_vqa_torch")


def _eval_modules(pkg):
    return (importlib.import_module(f"{pkg}.eval.vqa_api"),
            importlib.import_module(f"{pkg}.eval.vqa_eval"))


def test_normalization_tables_byte_identical():
    ours = ROOT / "novel_vqa_torch" / "eval" / "normalization_tables.json"
    assert ours.read_bytes() == (ROOT / "novel_vqa_tpu" / "eval" / "normalization_tables.json").read_bytes()


# the normalisation cases of tests/test_vqa_eval.py: (method, input, output)
NORMALIZATION_CASES = [
    ("processPunctuation", "red; blue", "red blue"),  # p beside a space: removed
    ("processPunctuation", "red;blue", "red blue"),  # embedded: a space
    ("processPunctuation", "1,000", "1000"),  # commaStrip removes all punctuation
    ("processPunctuation", "u.s.a", "usa"),
    ("processPunctuation", "1.50", "1.50"),  # digits keep their decimal point
    ("processDigitArticle", "a one and the two", "1 and 2"),
    ("processDigitArticle", "none", "0"),
    # the table's ASCII and typographic apostrophes, kept verbatim
    ("processDigitArticle", "couldnt", "couldn't"),
    ("processDigitArticle", "doesnt", "doesn’t"),
]


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("method,text,want", NORMALIZATION_CASES,
                         ids=[f"{m}-{t}" for m, t, _ in NORMALIZATION_CASES])
def test_normalization(pkg, method, text, want):
    _, vqa_eval = _eval_modules(pkg)
    assert getattr(vqa_eval.VQAEval(), method)(text) == want


def _write_simple(tmp_path, answers_per_q, results):
    """tests/test_vqa_eval.py's one-type dataset."""
    ann = {"info": {}, "data_type": "mscoco", "data_subtype": "val2014", "license": {},
           "annotations": [{"question_id": q, "image_id": 100 + q, "question_type": "what is",
                            "answer_type": "other", "multiple_choice_answer": a[0],
                            "answers": [{"answer": x, "answer_confidence": "yes", "answer_id": i + 1}
                                        for i, x in enumerate(a)]}
                           for q, a in answers_per_q.items()]}
    ques = {"info": {}, "task_type": "Open-Ended", "data_type": "mscoco", "data_subtype": "val2014",
            "license": {}, "questions": [{"question_id": q, "image_id": 100 + q, "question": "what is this?"}
                                         for q in answers_per_q]}
    paths = [tmp_path / n for n in ("ann.json", "q.json", "res.json")]
    for p, obj in zip(paths, (ann, ques, [{"question_id": q, "answer": a} for q, a in results.items()])):
        p.write_text(json.dumps(obj))
    return [str(p) for p in paths]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_accuracy_formula(tmp_path, pkg):
    """min(1, matches/3) leave-one-out over 10 answers (vqaEval.py:99-103)."""
    vqa_api, vqa_eval = _eval_modules(pkg)
    ap, qp, rp = _write_simple(tmp_path, {1: ["cat"] * 10, 2: ["cat"] * 3 + ["dog"] * 7, 3: ["dog"] * 10},
                               {1: "cat", 2: "cat", 3: "cat"})
    vqa = vqa_api.VQA(ap, qp)
    ev = vqa_eval.VQAEval(vqa, vqa.loadRes(rp, qp), n=2)
    ev.evaluate()
    assert (ev.evalQA[1], ev.evalQA[2], ev.evalQA[3]) == (100.0, 90.0, 0.0)
    assert ev.accuracy["overall"] == round(100 * (1 + 0.9 + 0) / 3, 2)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_loadres_refuses_other_question_ids(tmp_path, pkg):
    vqa_api, _ = _eval_modules(pkg)
    ap, qp, rp = _write_simple(tmp_path, {1: ["cat"] * 10}, {2: "cat"})
    with pytest.raises(AssertionError, match="Results do not correspond"):
        vqa_api.VQA(ap, qp).loadRes(rp, qp)


# answers with punctuation, digit words, articles and contractions, so the
# comparison runs through every normalisation step
EXTRA_ANSWERS = ["Two", "the ans1", "ans2!", "ans3.", "1,000", "doesnt", "ans 4", "none", "yes", "no"]


def _annotations(tmp, d, rs):
    """An annotation file and OE/MC question files for the fixture's test
    split: each question's ten answers mix the answer table with
    EXTRA_ANSWERS; types drawn at random; the MC choices from MC_ans_test."""
    with h5py.File(d["ques_h5"], "r") as f:
        qids = [int(q) for q in f["question_id_test"][()]]
        img_pos = [int(p) for p in f["img_pos_test"][()]]
        mc = f["MC_ans_test"][()]
    ix_to_ans = json.loads(Path(d["meta_json"]).read_text())["ix_to_ans"]
    pool = list(ix_to_ans.values()) + EXTRA_ANSWERS
    anns = [{"question_id": q, "image_id": p, "multiple_choice_answer": "ans1",
             "question_type": ["what is", "how many", "is the"][rs.randint(3)],
             "answer_type": ["other", "number", "yes/no"][rs.randint(3)],
             "answers": [{"answer": pool[j], "answer_confidence": "yes", "answer_id": i + 1}
                         for i, j in enumerate(rs.randint(0, len(pool), 10))]}
            for q, p in zip(qids, img_pos)]
    head = {"info": {}, "data_type": "mscoco", "data_subtype": "val2014", "license": {}}
    (tmp / "ann.json").write_text(json.dumps({**head, "annotations": anns}))
    for task, task_type in (("OpenEnded", "Open-Ended"), ("MultipleChoice", "Multiple Choice")):
        ques = [{"question_id": q, "image_id": p, "question": "what is it?"} for q, p in zip(qids, img_pos)]
        if task == "MultipleChoice":
            for entry, row in zip(ques, mc):
                entry["multiple_choices"] = [ix_to_ans[str(int(c))] for c in row if c]
        (tmp / f"{task}_questions.json").write_text(json.dumps({**head, "task_type": task_type, "questions": ques}))
    (tmp / "ques_id_hist.json").write_text(json.dumps({"0": qids[::3], "1": qids[1::3]}))
    return qids


@pytest.fixture(scope="module")
def eval_files(synthetic_dataset):  # noqa: F811
    """The port's eval CLI's result JSONs on the fixture's split, and an
    annotation/question pair for them."""
    d = synthetic_dataset
    out = d["tmp"] / "eval_results"
    teval.main(_argv(d, str(out) + "/", 1) + ["--device", "cpu"])
    qids = _annotations(d["tmp"], d, np.random.RandomState(5))
    return d["tmp"], out, qids


@pytest.mark.parametrize("task,name", [("OpenEnded", NAMES[0]), ("MultipleChoice", NAMES[1])])
def test_evaluators_agree_on_the_eval_cli_results(eval_files, task, name):
    tmp, out, qids = eval_files
    ann, ques, res = str(tmp / "ann.json"), str(tmp / f"{task}_questions.json"), str(out / name)
    per_pkg = {}
    for pkg in PACKAGES:
        vqa_api, vqa_eval = _eval_modules(pkg)
        vqa = vqa_api.VQA(ann, ques)
        ev = vqa_eval.VQAEval(vqa, vqa.loadRes(res, ques), n=2)
        ev.evaluate()
        full = (ev.accuracy, ev.evalQA, ev.evalQuesType, ev.evalAnsType)
        ev.evaluate(qids[::3])  # the novel subset, on the normalised answers
        per_pkg[pkg] = (json.dumps(full), json.dumps(ev.accuracy))
    assert per_pkg["novel_vqa_torch"] == per_pkg["novel_vqa_tpu"]
    accuracy = json.loads(per_pkg["novel_vqa_torch"][0])[0]
    assert set(accuracy["perAnswerType"]) == {"other", "number", "yes/no"}
    assert 0 < accuracy["overall"] < 100


@pytest.mark.parametrize("task,name", [("OpenEnded", NAMES[0]), ("MultipleChoice", NAMES[1])])
def test_drivers_agree_line_and_json(eval_files, task, name, capsys):
    """Both drivers, given the port's ``OpenEnded_<result_name>_results.json``
    through ``--res_file``, print the same ``Ov: .. Nov: ..`` line and write
    the same ``--out_json``."""
    tmp, out, _ = eval_files
    lines, dumps = [], []
    for i, drivers in enumerate((jdrivers, tdrivers)):
        acc_json = tmp / f"acc_{task}_{i}.json"
        drivers.main(["--data_dir", str(tmp), "--task_type", task, "--ann_file", str(tmp / "ann.json"),
                      "--ques_file", str(tmp / f"{task}_questions.json"), "--res_file", str(out / name),
                      "--ques_id_hist", str(tmp / "ques_id_hist.json"), "--out_json", str(acc_json)])
        lines.append(capsys.readouterr().out)
        dumps.append(acc_json.read_bytes())
    assert lines[0] == lines[1] and lines[1].startswith("Ov: ") and " Nov: " in lines[1]
    assert dumps[0] == dumps[1]


def test_drivers_default_naming_scheme(tmp_path):
    """Without overrides the files are found under Annotations/, Questions/
    and Results/ by the reference's naming scheme."""
    ap, qp, rp = _write_simple(tmp_path, {1: ["cat"] * 10, 2: ["dog"] * 10}, {1: "cat", 2: "cat"})
    for sub, src, name in (("Annotations", ap, "mscoco_val2014_x_annotations.json"),
                           ("Questions", qp, "OpenEnded_mscoco_val2014_x_questions.json"),
                           ("Results", rp, "OpenEnded_mscoco_val2014_lstm_x_results.json")):
        (tmp_path / sub).mkdir()
        (tmp_path / sub / name).write_text(Path(src).read_text())
    acc = tdrivers.main(["--data_dir", str(tmp_path), "--suffix", "_x"])
    assert acc["overall"] == 50.0 and acc["other"] == 50.0 and acc["number"] is None


def test_demo_prints_the_same_samples(eval_files, capsys):
    from novel_vqa_tpu.eval import demo as jdemo
    from novel_vqa_torch.eval import demo as tdemo

    tmp, _, _ = eval_files
    argv = ["--ann_file", str(tmp / "ann.json"), "--ques_file", str(tmp / "OpenEnded_questions.json"),
            "--n", "4", "--ans_type", "other"]
    outs = []
    for demo in (jdemo, tdemo):
        anns = demo.main(argv)
        outs.append(capsys.readouterr().out)
        assert len(anns) == 4 and all(a["answer_type"] == "other" for a in anns)
    assert outs[0] == outs[1] and outs[1].count("Question: ") == 4
