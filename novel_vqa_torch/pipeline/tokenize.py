"""Tokenizers used across the pipeline (copy of
``novel_vqa_tpu.pipeline.tokenize``; NLTK and spaCy are imported at the
first call that needs them, as there).

Three tokenization flavors exist in the reference and must be selectable
per-config because they shape the published vocabs (SURVEY.md section 7
risks):

  * ``prepro_sentence`` — lowercase, strip ASCII punctuation, split
    (002_train_vqa_arch1/000_prepro_vqa.py:27-29; also the corpus prepro,
    001_train_autoencoder/000_prepro_book_corpus.py:18-27 which additionally
    ASCII-strips);
  * ``word_tokenize`` — NLTK treebank tokenization
    (003_train_vqa_arch2/000_prepro_vqa.py:43).  NLTK's ``word_tokenize``
    needs the punkt sentence model (unavailable offline); the
    ``TreebankWordTokenizer`` used directly is data-free and identical for
    single-sentence inputs except for sentence-final-period splitting, which
    questions ("... ?") don't hit;
  * ``tokenize_regex`` — the explicit regex splitter
    (000_prepro_vqa.py:24-25).
"""

from __future__ import annotations

import re
import string
from typing import List

_PUNCT_TABLE = str.maketrans("", "", string.punctuation)


def prepro_sentence(sent: str) -> List[str]:
    """Python-3 equivalent of
    ``sent.encode('utf-8').lower().translate(None, string.punctuation).strip().split()``."""
    return sent.lower().translate(_PUNCT_TABLE).strip().split()


def prepro_sentence_ascii(sent: str) -> List[str]:
    """Corpus variant: non-ASCII characters are dropped first
    (000_prepro_book_corpus.py:18-27 operates on the utf-8 byte string with
    py2 semantics; ASCII-strip reproduces its effect on real text)."""
    ascii_only = sent.encode("ascii", "ignore").decode()
    return prepro_sentence(ascii_only)


_TOKENIZE_RE = re.compile(r"([-.\"',:? !\$#@~()*&\^%;\[\]/\\\+<>\n=])")


def tokenize_regex(sentence: str) -> List[str]:
    """000_prepro_vqa.py:24-25."""
    return [
        i
        for i in _TOKENIZE_RE.split(sentence)
        if i != "" and i != " " and i != "\n"
    ]


_treebank = None
_spacy_pipe = None


def spacy_tokenize(sent: str) -> List[str]:
    """The reference's optional spaCy unigram-paraphrase branch: tokens are
    the pipeline's *norms* (``token.norm_`` — lowercased canonical forms,
    e.g. "n't" -> "not"), 002_train_vqa_arch1/000_prepro_vqa.py:48-49; the
    pipeline is built once per process (:212-214, ``spacy.en.English`` in the
    py2-era API; the modern equivalent is a blank English pipeline, which
    also supplies ``norm_``).  Requires spaCy at runtime — guarded import
    with a clear error when absent (it is not in this image)."""
    global _spacy_pipe
    if _spacy_pipe is None:
        try:
            import spacy
        except ImportError as e:
            raise RuntimeError(
                "token_method 'spacy' requires spaCy (not available "
                "offline); use 'nltk' (arch1), 'treebank' (arch2), or "
                "'regex'"
            ) from e
        _spacy_pipe = spacy.blank("en")
    return [token.norm_ for token in _spacy_pipe(sent)]


def word_tokenize(sent: str) -> List[str]:
    """Data-free treebank tokenization (see module docstring)."""
    global _treebank
    if _treebank is None:
        from nltk.tokenize import TreebankWordTokenizer

        _treebank = TreebankWordTokenizer()
    return _treebank.tokenize(sent)


def get_tokenizer(method: str):
    if method == "nltk":
        # arch1's 'nltk' branch actually calls prepro_sentence
        # (000_prepro_vqa.py:47); arch2's calls word_tokenize — select
        # 'treebank' for the arch2 behavior
        return lambda s: prepro_sentence(s)
    if method == "treebank":
        return lambda s: word_tokenize(str(s).lower())
    if method == "regex":
        return tokenize_regex
    if method == "spacy":
        return spacy_tokenize
    raise ValueError(method)
