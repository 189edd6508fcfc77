"""The Porter stemmer in NLTK's default mode (``NLTK_EXTENSIONS``).

A copy of ``nltk.stem.porter.PorterStemmer`` (NLTK 3.10, Apache License
2.0, https://www.nltk.org), kept to the one mode that ``rouge-score``'s
``tokenizers.DefaultTokenizer(use_stemmer=True)`` constructs, so that
``eval/metrics.py::rouge_l`` scores as ``rouge-score`` does without
importing ``nltk``. The algorithm is M. F. Porter, "An algorithm for suffix
stripping", Program 14.3 (1980): 130-137, with Martin Porter's later
extensions and NLTK's (the irregular forms below, ``ies``/``ied`` in four
letters, ``y`` after a consonant, ``alli``, ``fulli`` and ``logi``).
``tests/test_torch_eval.py`` holds it to NLTK's on every distinct token of
the demo corpus, its questions and answers, and the repository's prose.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

_IRREGULAR = {
    "sky": ["sky", "skies"],
    "die": ["dying"],
    "lie": ["lying"],
    "tie": ["tying"],
    "news": ["news"],
    "inning": ["innings", "inning"],
    "outing": ["outings", "outing"],
    "canning": ["cannings", "canning"],
    "howe": ["howe"],
    "proceed": ["proceed"],
    "exceed": ["exceed"],
    "succeed": ["succeed"],
}
_POOL = {form: stem for stem, forms in _IRREGULAR.items() for form in forms}
_VOWELS = frozenset("aeiou")

Rule = Tuple[str, str, Optional[Callable[[str], bool]]]


def _is_consonant(word: str, i: int) -> bool:
    """A letter other than a vowel, and other than a ``y`` after a
    consonant (a run of ``y`` alternates)."""
    if word[i] in _VOWELS:
        return False
    if word[i] == "y":
        negate = False
        while i > 0 and word[i] == "y":
            negate = not negate
            i -= 1
        return (word[i] not in _VOWELS) != negate
    return True


def _measure(stem: str) -> int:
    """m of ``[C](VC){m}[V]``: the number of vowel-consonant transitions."""
    cv = "".join("c" if _is_consonant(stem, i) else "v" for i in range(len(stem)))
    return cv.count("vc")


def _positive_measure(stem: str) -> bool:
    return _measure(stem) > 0


def _contains_vowel(stem: str) -> bool:
    return any(not _is_consonant(stem, i) for i in range(len(stem)))


def _ends_double_consonant(word: str) -> bool:
    return len(word) >= 2 and word[-1] == word[-2] and _is_consonant(word, len(word) - 1)


def _ends_cvc(word: str) -> bool:
    return (
        len(word) >= 3
        and _is_consonant(word, len(word) - 3)
        and not _is_consonant(word, len(word) - 2)
        and _is_consonant(word, len(word) - 1)
        and word[-1] not in ("w", "x", "y")
    ) or (len(word) == 2 and not _is_consonant(word, 0) and _is_consonant(word, 1))


def _replace_suffix(word: str, suffix: str, replacement: str) -> str:
    return word + replacement if suffix == "" else word[: -len(suffix)] + replacement


def _apply_rule_list(word: str, rules: Sequence[Rule]) -> str:
    """The first rule whose suffix the word ends with decides: its
    replacement if its condition holds on the stem, else the word as it is.
    The suffix ``*d`` stands for a double consonant."""
    for suffix, replacement, condition in rules:
        if suffix == "*d" and _ends_double_consonant(word):
            stem = word[:-2]
            return stem + replacement if condition is None or condition(stem) else word
        if word.endswith(suffix):
            stem = _replace_suffix(word, suffix, "")
            return stem + replacement if condition is None or condition(stem) else word
    return word


def _step1a(word: str) -> str:
    if word.endswith("ies") and len(word) == 4:
        return _replace_suffix(word, "ies", "ie")
    return _apply_rule_list(word, [("sses", "ss", None), ("ies", "i", None),
                                   ("ss", "ss", None), ("s", "", None)])


def _step1b(word: str) -> str:
    if word.endswith("ied"):
        return _replace_suffix(word, "ied", "ie" if len(word) == 4 else "i")
    if word.endswith("eed"):
        stem = _replace_suffix(word, "eed", "")
        return stem + "ee" if _measure(stem) > 0 else word
    for suffix in ("ed", "ing"):
        if word.endswith(suffix):
            stem = _replace_suffix(word, suffix, "")
            if _contains_vowel(stem):
                break
    else:
        return word
    return _apply_rule_list(stem, [
        ("at", "ate", None),
        ("bl", "ble", None),
        ("iz", "ize", None),
        ("*d", stem[-1], lambda _: stem[-1] not in ("l", "s", "z")),
        ("", "e", lambda s: _measure(s) == 1 and _ends_cvc(s)),
    ])


def _step1c(word: str) -> str:
    return _apply_rule_list(
        word, [("y", "i", lambda s: len(s) > 1 and _is_consonant(s, len(s) - 1))])


def _step2(word: str) -> str:
    if word.endswith("alli") and _positive_measure(_replace_suffix(word, "alli", "")):
        return _step2(_replace_suffix(word, "alli", "al"))
    m = _positive_measure
    rules: List[Rule] = [
        ("ational", "ate", m), ("tional", "tion", m), ("enci", "ence", m),
        ("anci", "ance", m), ("izer", "ize", m), ("bli", "ble", m), ("alli", "al", m),
        ("entli", "ent", m), ("eli", "e", m), ("ousli", "ous", m), ("ization", "ize", m),
        ("ation", "ate", m), ("ator", "ate", m), ("alism", "al", m), ("iveness", "ive", m),
        ("fulness", "ful", m), ("ousness", "ous", m), ("aliti", "al", m),
        ("iviti", "ive", m), ("biliti", "ble", m), ("fulli", "ful", m),
        ("logi", "log", lambda _: _positive_measure(word[:-3])),
    ]
    return _apply_rule_list(word, rules)


def _step3(word: str) -> str:
    m = _positive_measure
    return _apply_rule_list(word, [
        ("icate", "ic", m), ("ative", "", m), ("alize", "al", m), ("iciti", "ic", m),
        ("ical", "ic", m), ("ful", "", m), ("ness", "", m),
    ])


def _step4(word: str) -> str:
    def gt1(stem: str) -> bool:
        return _measure(stem) > 1

    return _apply_rule_list(word, [
        ("al", "", gt1), ("ance", "", gt1), ("ence", "", gt1), ("er", "", gt1),
        ("ic", "", gt1), ("able", "", gt1), ("ible", "", gt1), ("ant", "", gt1),
        ("ement", "", gt1), ("ment", "", gt1), ("ent", "", gt1),
        ("ion", "", lambda s: _measure(s) > 1 and s[-1] in ("s", "t")),
        ("ou", "", gt1), ("ism", "", gt1), ("ate", "", gt1), ("iti", "", gt1),
        ("ous", "", gt1), ("ive", "", gt1), ("ize", "", gt1),
    ])


def _step5a(word: str) -> str:
    if word.endswith("e"):
        stem = _replace_suffix(word, "e", "")
        if _measure(stem) > 1 or (_measure(stem) == 1 and not _ends_cvc(stem)):
            return stem
    return word


def _step5b(word: str) -> str:
    return _apply_rule_list(word, [("ll", "l", lambda _: _measure(word[:-1]) > 1)])


def stem(word: str) -> str:
    """``PorterStemmer().stem(word)`` of NLTK (lowercased first)."""
    out = word.lower()
    if out in _POOL:
        return _POOL[out]
    if len(word) <= 2:
        return out
    for step in (_step1a, _step1b, _step1c, _step2, _step3, _step4, _step5a, _step5b):
        out = step(out)
    return out
