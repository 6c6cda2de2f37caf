"""POS tagging + pluralization utilities for the dataset-creation stages
(copy of ``novel_vqa_tpu.pipeline.pos``).

The reference relies on NLTK's averaged-perceptron tagger
(000_create_dataset/001_create_novel_statistics.py:122) and ``pattern.en``'s
``pluralize`` (004_evaluate_quality_part2.py, 005/001_create_corrected_split.py).
NLTK's tagger model and ``pattern`` are data/deps this offline environment may
lack, so:

  * ``pos_tag`` uses NLTK's tagger when its model data is installed and
    otherwise falls back to a small rule tagger (``--tagger heuristic``) that
    is ONLY suitable for smoke tests — reproduced splits then differ from the
    published ones, which ship as frozen artifacts anyway
    (000_create_dataset/{trainNouns,testNouns}.json, Clusters/);
  * ``pluralize`` is a self-contained implementation of English pluralization
    covering the regular rules and the common irregulars pattern.en applies.
"""

from __future__ import annotations

from typing import List, Tuple

_NLTK_OK = None


def nltk_tagger_available() -> bool:
    global _NLTK_OK
    if _NLTK_OK is None:
        try:
            import nltk

            nltk.pos_tag(["test"])
            _NLTK_OK = True
        except LookupError:
            _NLTK_OK = False
    return _NLTK_OK


_DET = {"the", "a", "an", "this", "that", "these", "those", "my", "your", "his",
        "her", "its", "our", "their"}
_PRON = {"i", "you", "he", "she", "it", "we", "they", "what", "which", "who",
         "whom", "whose", "there", "here"}
_VERB_SUFFIX = ("ing", "ed")
_COMMON_NON_NOUNS = {
    "is", "are", "was", "were", "be", "been", "being", "do", "does", "did",
    "have", "has", "had", "can", "could", "will", "would", "shall", "should",
    "may", "might", "must", "not", "no", "yes", "of", "in", "on", "at", "to",
    "for", "with", "by", "from", "up", "down", "and", "or", "but", "if",
    "how", "many", "much", "color", "colour",
}


def _heuristic_tag(tokens: List[str]) -> List[Tuple[str, str]]:
    """Crude NN detector: lowercase alphabetic tokens that are not determiners,
    pronouns, common function words, -ing/-ed forms, or plurals."""
    out = []
    for t in tokens:
        tag = "XX"
        if (
            t.isalpha()
            and t == t.lower()
            and t not in _DET
            and t not in _PRON
            and t not in _COMMON_NON_NOUNS
            and not t.endswith(_VERB_SUFFIX)
            and not (t.endswith("s") and len(t) > 3)
        ):
            tag = "NN"
        out.append((t, tag))
    return out


def pos_tag(tokens: List[str], tagger: str = "auto") -> List[Tuple[str, str]]:
    if tagger == "nltk" or (tagger == "auto" and nltk_tagger_available()):
        import nltk

        return nltk.pos_tag(tokens)
    return _heuristic_tag(tokens)


_IRREGULAR_PLURALS = {
    "man": "men", "woman": "women", "child": "children", "person": "people",
    "foot": "feet", "tooth": "teeth", "goose": "geese", "mouse": "mice",
    "ox": "oxen", "die": "dice", "leaf": "leaves", "knife": "knives",
    "wife": "wives", "life": "lives", "wolf": "wolves", "shelf": "shelves",
    "loaf": "loaves", "thief": "thieves", "half": "halves", "calf": "calves",
    "sheep": "sheep", "deer": "deer", "fish": "fish", "series": "series",
    "species": "species", "aircraft": "aircraft",
}
_VOWELS = "aeiou"


def pluralize(word: str) -> str:
    w = word.lower()
    if w in _IRREGULAR_PLURALS:
        return _IRREGULAR_PLURALS[w]
    if not w or not w[-1].isalpha():
        return w
    if w.endswith(("s", "x", "z", "ch", "sh")):
        return w + "es"
    if w.endswith("y") and len(w) > 1 and w[-2] not in _VOWELS:
        return w[:-1] + "ies"
    if w.endswith("o") and len(w) > 1 and w[-2] not in _VOWELS and w not in (
        "photo", "piano", "halo", "pro", "logo", "kilo", "memo", "zoo", "video",
        "avocado", "taco", "burrito", "flamingo",  # common -o -> -os words
    ):
        return w + "es"
    return w + "s"
