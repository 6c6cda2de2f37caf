"""The port's pipeline stages (``novel_vqa_torch.pipeline``) against the
JAX package's, stage by stage on the same raw data, mirroring
``tests/test_pipeline.py``'s cases: the tokenizers and the tagger's
helpers give the same tokens; every JSON a stage writes is byte-identical;
every h5 dataset is equal when h5py and the port's reader read both files;
``quality_eval`` too.  Each stage runs in this process, one package after
the other, so their seeded shuffles and the heuristic tagger see the same
inputs."""

import json
import sys
import types
from pathlib import Path

import h5py
import numpy as np
import pytest

from novel_vqa_torch.core.h5 import H5Reader
from novel_vqa_tpu.pipeline import correction as jcorrection
from novel_vqa_tpu.pipeline import novel_split as jnovel
from novel_vqa_tpu.pipeline import pos as jpos
from novel_vqa_tpu.pipeline import prepro_book_corpus as jcorpus
from novel_vqa_tpu.pipeline import prepro_vqa as jprepro
from novel_vqa_tpu.pipeline import quality_eval as jquality
from novel_vqa_tpu.pipeline import tokenize as jtok
from novel_vqa_tpu.pipeline import vqa_preprocessing as jvqa
from novel_vqa_torch.pipeline import correction as tcorrection
from novel_vqa_torch.pipeline import novel_split as tnovel
from novel_vqa_torch.pipeline import pos as tpos
from novel_vqa_torch.pipeline import prepro_book_corpus as tcorpus
from novel_vqa_torch.pipeline import prepro_vqa as tprepro
from novel_vqa_torch.pipeline import quality_eval as tquality
from novel_vqa_torch.pipeline import tokenize as ttok
from novel_vqa_torch.pipeline import vqa_preprocessing as tvqa

SENTENCES = ["What is the man's hat?", "café table!", "what's this?", "what is the man doing?",
             "Is there a cat / dog here?", "how many people are in the photo", "It's 3:45 -- isn't it?"]


def _same_files(jdir: Path, tdir: Path, names=None):
    """Every file of ``jdir`` (or ``names``) byte-identical in ``tdir``."""
    if names is None:
        names = sorted(p.name for p in jdir.iterdir() if p.is_file())
        assert names and sorted(p.name for p in tdir.iterdir() if p.is_file()) == names
    for name in names:
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name


def _same_h5(jpath, tpath):
    """The same datasets, equal, read by h5py from both files and by the
    port's reader from the port's."""
    with h5py.File(jpath, "r") as j, h5py.File(tpath, "r") as t, H5Reader(str(tpath)) as r:
        names = []
        j.visititems(lambda k, v: names.append(k) if isinstance(v, h5py.Dataset) else None)
        assert sorted(r.datasets()) == sorted(names)
        for k in names:
            ref = j[k][()]
            for got in (t[k][()], r[k]):
                assert got.dtype == ref.dtype and got.shape == ref.shape, k
                np.testing.assert_array_equal(got, ref, err_msg=k)
        return names


def test_prepro_sentence():
    for s in SENTENCES:
        assert ttok.prepro_sentence(s) == jtok.prepro_sentence(s)
        assert ttok.prepro_sentence_ascii(s) == jtok.prepro_sentence_ascii(s)
    assert ttok.prepro_sentence("What is the man's hat?") == ["what", "is", "the", "mans", "hat"]
    assert ttok.prepro_sentence_ascii("café table!") == ["caf", "table"]


def test_tokenize_regex():
    for s in SENTENCES:
        assert ttok.tokenize_regex(s) == jtok.tokenize_regex(s)
    assert ttok.tokenize_regex("what's this?") == ["what", "'", "s", "this", "?"]


def test_word_tokenize_data_free():
    for s in SENTENCES:
        assert ttok.word_tokenize(s) == jtok.word_tokenize(s)
        for method in ("nltk", "treebank", "regex"):
            assert ttok.get_tokenizer(method)(s) == jtok.get_tokenizer(method)(s)
    assert ttok.word_tokenize("what is the man doing?") == ["what", "is", "the", "man", "doing", "?"]


def test_spacy_tokenize_with_fake_pipeline(monkeypatch):
    """spaCy is absent here: a minimal fake module gives both packages the
    same pipeline, whose ``norm_`` values are the tokens."""
    class _Tok:
        def __init__(self, norm):
            self.norm_ = norm

    def blank(lang):
        assert lang == "en"
        return lambda s: [_Tok(w.lower()) for w in s.split()]

    fake = types.ModuleType("spacy")
    fake.blank = blank
    monkeypatch.setitem(sys.modules, "spacy", fake)
    for mod in (ttok, jtok):
        monkeypatch.setattr(mod, "_spacy_pipe", None)
    for s in SENTENCES:
        assert ttok.get_tokenizer("spacy")(s) == jtok.get_tokenizer("spacy")(s)
    assert ttok.get_tokenizer("spacy")("What IS this") == ["what", "is", "this"]


def test_spacy_tokenize_clear_error_when_absent(monkeypatch):
    monkeypatch.setattr(ttok, "_spacy_pipe", None)
    monkeypatch.setitem(sys.modules, "spacy", None)  # force ImportError
    with pytest.raises(RuntimeError, match="requires spaCy"):
        ttok.get_tokenizer("spacy")("hello there")
    with pytest.raises(ValueError):
        ttok.get_tokenizer("unknown")


def test_pluralize_and_tagger():
    words = ["cat", "box", "city", "knife", "man", "sheep", "photo", "potato", "day", "bus", "wish",
             "church", "toy", "zoo", "hero", "person", "Fox", "3d", ""]
    assert [tpos.pluralize(w) for w in words] == [jpos.pluralize(w) for w in words]
    for s in SENTENCES:
        toks = ttok.word_tokenize(s.lower())
        assert tpos.pos_tag(toks, "heuristic") == jpos.pos_tag(toks, "heuristic")
        assert tpos.pos_tag(toks) == jpos.pos_tag(toks)  # NLTK's model where installed
    assert tpos.nltk_tagger_available() == jpos.nltk_tagger_available()
    assert [tpos.pluralize(w) for w in ("cat", "box", "city", "knife", "man", "sheep")] == [
        "cats", "boxes", "cities", "knives", "men", "sheep"]


def _raw_item(qid, img, question, ans, n_mc=4):
    return {"ques_id": qid, "img_path": img, "question": question,
            "MC_ans": [ans] + [f"mc{i}" for i in range(n_mc - 1)], "ans": ans}


@pytest.fixture
def raw_vqa(tmp_path):
    train = [
        _raw_item(i, f"train2014/im{i % 4}.jpg", f"what is the {w}?", a)
        for i, (w, a) in enumerate(
            [("cat", "cat"), ("dog", "dog"), ("cat", "cat"), ("hat", "red"),
             ("dog", "dog"), ("cat", "cat"), ("sun", "yes"), ("dog", "no")] * 5
        )
    ]
    test = [{"ques_id": 1000 + i, "img_path": f"val2014/im{i}.jpg", "question": f"is this a {w}?",
             "MC_ans": ["yes", "no", "cat", "dog"]} for i, w in enumerate(["cat", "dog", "pizza"])]
    tr, te = tmp_path / "raw_train.json", tmp_path / "raw_test.json"
    tr.write_text(json.dumps(train))
    te.write_text(json.dumps(test))
    return str(tr), str(te), tmp_path


def _run_both(jcli, tcli, argv_for, tmp_path):
    """``argv_for(out_dir)`` through the JAX and the port's CLI, each into a
    directory of its own; returns the two directories."""
    dirs = []
    for name, cli in (("jax", jcli), ("port", tcli)):
        out = tmp_path / name
        out.mkdir(parents=True)
        cli(argv_for(out))
        dirs.append(out)
    return dirs


@pytest.mark.parametrize("token_method", ["nltk", "treebank"])
def test_prepro_vqa_schema_and_quirks(raw_vqa, token_method):
    tr, te, tmp = raw_vqa
    jdir, tdir = _run_both(jprepro.cli, tprepro.cli, lambda d: [
        "--input_train_json", tr, "--input_test_json", te, "--num_ans", "4",
        "--output_json", str(d / "data_prepro.json"), "--output_h5", str(d / "data_prepro.h5"),
        "--num_val", "6", "--max_length", "8", "--token_method", token_method], tmp)
    _same_files(jdir, tdir, ["data_prepro.json"])
    names = _same_h5(jdir / "data_prepro.h5", tdir / "data_prepro.h5")
    assert {"ques_train", "ques_val", "answers_val", "ques_test", "MC_ans_test", "img_pos_train"} <= set(names)
    with H5Reader(str(tdir / "data_prepro.h5")) as f:
        assert all(f[k].dtype == np.uint32 for k in names)
        assert f["ques_val"].shape[0] == 6 and f["img_pos_train"].min() >= 1


def test_prepro_vqa_extern_vocab_oov_answers(raw_vqa, tmp_path):
    tr, te, tmp = raw_vqa
    (tmp_path / "ans_vocab.json").write_text(json.dumps(["cat", "nonexistent"]))
    (tmp_path / "vocab.json").write_text(json.dumps(["what", "is", "the", "cat", "dog", "UNK"]))
    jdir, tdir = _run_both(jprepro.cli, tprepro.cli, lambda d: [
        "--input_train_json", tr, "--input_test_json", te, "--num_ans", "2",
        "--output_json", str(d / "o.json"), "--output_h5", str(d / "o.h5"),
        "--extern_vocab", str(tmp_path / "vocab.json"), "--extern_ans_vocab", str(tmp_path / "ans_vocab.json"),
        "--save_vocab", "1", "--vocab_save_path", str(d / "vocab.json"),
        "--ans_vocab_save_path", str(d / "ans.json")], tmp_path)
    _same_files(jdir, tdir, ["ans.json", "o.json", "vocab.json"])
    _same_h5(jdir / "o.h5", tdir / "o.h5")
    assert len(json.loads((tdir / "o.json").read_text())["ix_to_ans"]) == 2


def test_prepro_book_corpus(tmp_path):
    corpus = tmp_path / "corpus.txt"
    lines = ["the cat sat on the mat", "a dog ran fast", "the bird flew high over the trees",
             "cats and dogs live together", "café au lait, s'il vous plaît"] * 8
    corpus.write_text("\n".join(lines) + "\n\n")
    (tmp_path / "vqa_vocab.json").write_text(json.dumps(["what", "zebra"]))
    jdir, tdir = _run_both(jcorpus.cli, tcorpus.cli, lambda d: [
        "--corpus", str(corpus), "--corpus", str(corpus), "--output_h5", str(d / "data.h5"),
        "--output_json", str(d / "data.json"), "--num_val", "5", "--num_test", "5",
        "--word_count_threshold", "8", "--max_vocab_size", "12", "--max_length", "6",
        "--vqa_vocab", str(tmp_path / "vqa_vocab.json")], tmp_path)
    _same_files(jdir, tdir, ["data.json"])
    names = _same_h5(jdir / "data.h5", tdir / "data.h5")
    assert sorted(names) == sorted(f"{g}/{s}" for g in ("labels", "label_length") for s in ("train", "val", "test"))
    with H5Reader(str(tdir / "data.h5")) as f:
        assert f["labels/train"].shape == (70, 6) and f["labels/train"].dtype == np.uint32


def test_vqa_preprocessing_flatten(tmp_path):
    ann_dir = tmp_path / "annotations"
    ann_dir.mkdir()

    def anno(qids):
        return {"annotations": [{"question_id": q, "image_id": q * 7, "multiple_choice_answer": f"a{q}",
                                 "answers": []} for q in qids]}

    def ques(qids):
        return {"questions": [{"question_id": q, "image_id": q * 7, "question": f"really {q}?",
                               "multiple_choices": ["yes", "no"]} for q in qids]}

    for name, obj in (("mscoco_train2014_annotations.json", anno([1, 2])),
                      ("mscoco_val2014_annotations.json", anno([3])),
                      ("MultipleChoice_mscoco_train2014_questions.json", ques([1, 2])),
                      ("MultipleChoice_mscoco_val2014_questions.json", ques([3])),
                      ("MultipleChoice_mscoco_test2015_questions.json", ques([8, 9]))):
        (ann_dir / name).write_text(json.dumps(obj))
    for split in ("1", "2"):
        jdir, tdir = _run_both(jvqa.cli, tvqa.cli, lambda d: [
            "--annotations_dir", str(ann_dir), "--split", split,
            "--output_train", str(d / "raw_train.json"), "--output_test", str(d / "raw_test.json")],
            tmp_path / f"split{split}")
        _same_files(jdir, tdir)
    train = json.loads((tmp_path / "split1" / "port" / "raw_train.json").read_text())
    assert train[0]["img_path"] == "train2014/COCO_train2014_%012d.jpg" % 7


def test_novel_split_pipeline(tmp_path):
    """stats -> cluster -> split with the heuristic tagger: every file the
    three stages write is byte-identical."""
    (tmp_path / "question_types.txt").write_text("what is\nis this\nwhat\n")
    nouns = ["cat", "dog", "pizza", "guitar", "chair", "tree", "car", "boat"]
    train = [_raw_item(i, f"train2014/im{i}.jpg", f"what is the {nouns[i % 8]}", nouns[i % 8])
             for i in range(40)]
    test = [{"ques_id": 100 + i, "img_path": f"val2014/im{i}.jpg", "question": f"is this {nouns[i % 8]}",
             "MC_ans": ["yes", "no"]} for i in range(8)]
    (tmp_path / "raw_train.json").write_text(json.dumps(train))
    (tmp_path / "raw_test.json").write_text(json.dumps(test))

    def anno_file(items):
        return {"annotations": [{"question_id": el["ques_id"], "answers": [{"answer": el.get("ans", "yes")}] * 3}
                                for el in items]}

    def q_file(items):
        return {"questions": [{"question_id": el["ques_id"]} for el in items]}

    for name, obj in (("train_anno.json", anno_file(train)), ("val_anno.json", anno_file(test)),
                      ("train_mc.json", q_file(train)), ("train_oe.json", q_file(train)),
                      ("val_mc.json", q_file(test)), ("val_oe.json", q_file(test))):
        (tmp_path / name).write_text(json.dumps(obj))

    def stages(d):
        return [
            ["stats", "--question_types", str(tmp_path / "question_types.txt"),
             "--raw_train", str(tmp_path / "raw_train.json"), "--raw_test", str(tmp_path / "raw_test.json"),
             "--out_dir", str(d / "Statistics") + "/", "--min_count", "2", "--tagger", "heuristic"],
            ["cluster", "--stats_dir", str(d / "Statistics") + "/", "--out_dir", str(d / "Clusters") + "/",
             "--num_clusters", "2", "--n_init", "5", "--max_iter", "50"],
            ["split", "--clusters", str(d / "Clusters" / "clusteredNouns.json"),
             "--raw_train", str(tmp_path / "raw_train.json"), "--raw_test", str(tmp_path / "raw_test.json"),
             "--train_annotations", str(tmp_path / "train_anno.json"),
             "--val_annotations", str(tmp_path / "val_anno.json"),
             "--train_questions_mc", str(tmp_path / "train_mc.json"),
             "--train_questions_oe", str(tmp_path / "train_oe.json"),
             "--val_questions_mc", str(tmp_path / "val_mc.json"),
             "--val_questions_oe", str(tmp_path / "val_oe.json"),
             "--save_base_path", str(d / "out") + "/", "--save_vqa_annotations_path", str(d / "Ann") + "/",
             "--save_vqa_questions_path", str(d / "Ques") + "/", "--tagger", "heuristic"],
        ]

    for name, cli in (("jax", jnovel.cli), ("port", tnovel.cli)):
        for argv in stages(tmp_path / name):
            cli(argv)
    for sub in ("Statistics", "Clusters", "out", "Ann", "Ques"):
        _same_files(tmp_path / "jax" / sub, tmp_path / "port" / sub)
    train_kn = json.loads((tmp_path / "port" / "out" / "train_raw_novel_2.json").read_text())
    val_kn = json.loads((tmp_path / "port" / "out" / "val_raw_novel_2.json").read_text())
    assert len(train_kn) + len(val_kn) == len(train) + len(test)


def test_correction_stage(tmp_path):
    """correct, validate, img-lookup and remap-features: the JSONs
    byte-identical, the remapped store's datasets equal."""
    (tmp_path / "novel.json").write_text(json.dumps(["cat", "guitar", "mr"]))
    train = [_raw_item(0, "a.jpg", "what are the cats doing", "playing"),  # plural leak
             _raw_item(1, "b.jpg", "what is this", "guitar"),  # answer leak
             _raw_item(2, "c.jpg", "what is the dog doing", "running")]  # clean
    anno = {"annotations": [{"question_id": el["ques_id"], "answers": [{"answer": el["ans"]}] * 3}
                            for el in train]}
    qf = {"questions": [{"question_id": el["ques_id"]} for el in train]}
    for name, obj in (("train_raw.json", train), ("train_anno.json", anno), ("train_oe.json", qf),
                      ("train_mc.json", qf), ("test_raw.json", train[:1])):
        (tmp_path / name).write_text(json.dumps(obj))
    prepro = {"unique_img_train": ["a.jpg", "b.jpg"], "unique_img_val": ["c.jpg", "a.jpg"],
              "unique_img_test": ["d.jpg"]}
    (tmp_path / "old_prepro.json").write_text(json.dumps(prepro))
    with h5py.File(tmp_path / "old_img.h5", "w") as f:
        f.create_dataset("images_train", data=np.arange(8, dtype=np.float32).reshape(2, 4))
        f.create_dataset("images_val", data=np.full((2, 4), 9, np.float32))
        f.create_dataset("images_test", data=np.full((1, 4), -1, np.float32))
    new_meta = {"unique_img_train": ["c.jpg", "a.jpg", "zz.jpg"], "unique_img_val": [],
                "unique_img_test": ["d.jpg", "b.jpg"]}
    (tmp_path / "new_prepro.json").write_text(json.dumps(new_meta))

    results = {}
    for name, cli in (("jax", jcorrection.cli), ("port", tcorrection.cli)):
        d = tmp_path / name
        d.mkdir()
        cli(["correct", "--novel_words", str(tmp_path / "novel.json"),
             "--train_raw", str(tmp_path / "train_raw.json"),
             "--train_annotations", str(tmp_path / "train_anno.json"),
             "--train_oe_questions", str(tmp_path / "train_oe.json"),
             "--train_mcq_questions", str(tmp_path / "train_mc.json"),
             "--save_train_raw", str(d / "new_raw.json"), "--save_train_annotations", str(d / "new_anno.json"),
             "--save_train_oe_questions", str(d / "new_oe.json"),
             "--save_train_mcq_questions", str(d / "new_mc.json"),
             "--test_raw", str(tmp_path / "test_raw.json"), "--save_test_raw", str(d / "test_raw.json"),
             "--tagger", "heuristic"])
        cli(["img-lookup", "--original_json", str(tmp_path / "old_prepro.json"),
             "--save_path", str(d / "lookup.json")])
        cli(["remap-features", "--lookup_json", str(d / "lookup.json"),
             "--new_prepro_json", str(tmp_path / "new_prepro.json"),
             "--old_img_h5", str(tmp_path / "old_img.h5"), "--out_h5", str(d / "new_img.h5")])
        mod = jcorrection if name == "jax" else tcorrection
        results[name] = mod.run_validate({"novel_words": str(tmp_path / "novel.json"),
                                          "train_raw": str(tmp_path / "train_raw.json"),
                                          "train_annotations": str(tmp_path / "train_anno.json")})
    _same_files(tmp_path / "jax", tmp_path / "port",
                ["lookup.json", "new_anno.json", "new_mc.json", "new_oe.json", "new_raw.json", "test_raw.json"])
    assert results["port"] == results["jax"]
    _same_h5(tmp_path / "jax" / "new_img.h5", tmp_path / "port" / "new_img.h5")
    assert [el["ques_id"] for el in json.loads((tmp_path / "port" / "new_raw.json").read_text())] == [2]
    with H5Reader(str(tmp_path / "port" / "new_img.h5")) as f:
        np.testing.assert_array_equal(f["images_train"], [[9] * 4, [0, 1, 2, 3], [0] * 4])
        np.testing.assert_array_equal(f["images_test"], [[-1] * 4, [4, 5, 6, 7]])


def test_quality_eval(raw_vqa, capsys):
    """nouns, overlap and sizes: nouns_vqa.json byte-identical, the same
    printed report and the same overlap."""
    tr, te, tmp = raw_vqa
    anns = {"annotations": [{"question_id": el["ques_id"], "answers": [{"answer": el["ans"]}, {"answer": "men"}]}
                            for el in json.loads(Path(tr).read_text())]}
    (tmp / "anns.json").write_text(json.dumps(anns))
    (tmp / "trainNouns.json").write_text(json.dumps(["dog", "hat", "sun"]))
    (tmp / "testNouns.json").write_text(json.dumps(["cat", "pizza", "man"]))
    out = {}
    for name, main in (("jax", jquality.main), ("port", tquality.main)):
        d = str(tmp / name) + "/"
        main(["nouns", "--input_train_json", tr, "--input_test_json", te,
              "--input_train_annotations", str(tmp / "anns.json"), "--save_path", d, "--tagger", "heuristic"])
        overlap = main(["overlap", "--save_path", d, "--train_nouns", str(tmp / "trainNouns.json"),
                        "--test_nouns", str(tmp / "testNouns.json")])
        main(["sizes", "--raw_train_path", tr, "--raw_test_path", te])
        out[name] = (overlap, capsys.readouterr().out.replace(d, "<dir>"))
    _same_files(tmp / "jax", tmp / "port")
    assert out["port"] == out["jax"]
    assert out["port"][0]["novel_in_train"] == ["cat"] and out["port"][0]["plural_in_train"] == ["men"]
