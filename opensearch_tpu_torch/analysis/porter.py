"""Porter stemming algorithm (classic 1980 definition), the port's copy of
opensearch_tpu.analysis.porter.

Behavior: Lucene's PorterStemFilter, exposed by the reference as the
`porter_stem` / `stemmer(english)` token filters registered in
modules/analysis-common (CommonAnalysisModulePlugin). Implemented from the
published algorithm, not from any reference source.
"""

from __future__ import annotations

_VOWELS = set("aeiou")


def _is_consonant(word: str, i: int) -> bool:
    ch = word[i]
    if ch in _VOWELS:
        return False
    if ch == "y":
        return i == 0 or not _is_consonant(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """Count VC sequences [C](VC){m}[V]."""
    m = 0
    prev_vowel = False
    for i in range(len(stem)):
        v = not _is_consonant(stem, i)
        if prev_vowel and not v:
            m += 1
        prev_vowel = v
    return m


def _contains_vowel(stem: str) -> bool:
    return any(not _is_consonant(stem, i) for i in range(len(stem)))


def _ends_double_consonant(word: str) -> bool:
    return (len(word) >= 2 and word[-1] == word[-2] and _is_consonant(word, len(word) - 1))


def _cvc(word: str) -> bool:
    if len(word) < 3:
        return False
    if (_is_consonant(word, len(word) - 3) and not _is_consonant(word, len(word) - 2)
            and _is_consonant(word, len(word) - 1)):
        return word[-1] not in "wxy"
    return False


def porter_stem(word: str) -> str:
    if len(word) <= 2:
        return word
    w = word

    # Step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # Step 1b
    flag_1b = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed"):
        if _contains_vowel(w[:-2]):
            w = w[:-2]
            flag_1b = True
    elif w.endswith("ing"):
        if _contains_vowel(w[:-3]):
            w = w[:-3]
            flag_1b = True
    if flag_1b:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _ends_double_consonant(w) and not w.endswith(("l", "s", "z")):
            w = w[:-1]
        elif _measure(w) == 1 and _cvc(w):
            w += "e"

    # Step 1c
    if w.endswith("y") and _contains_vowel(w[:-1]):
        w = w[:-1] + "i"

    # Step 2
    step2 = [("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
             ("izer", "ize"), ("bli", "ble"), ("alli", "al"), ("entli", "ent"),
             ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
             ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
             ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
             ("logi", "log")]
    for suf, rep in step2:
        if w.endswith(suf):
            if _measure(w[:-len(suf)]) > 0:
                w = w[:-len(suf)] + rep
            break

    # Step 3
    step3 = [("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
             ("ical", "ic"), ("ful", ""), ("ness", "")]
    for suf, rep in step3:
        if w.endswith(suf):
            if _measure(w[:-len(suf)]) > 0:
                w = w[:-len(suf)] + rep
            break

    # Step 4
    step4 = ["al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
             "ment", "ent", "ion", "ou", "ism", "ate", "iti", "ous", "ive", "ize"]
    for suf in sorted(step4, key=len, reverse=True):
        if w.endswith(suf):
            stem = w[:-len(suf)]
            if _measure(stem) > 1:
                if suf == "ion" and not stem.endswith(("s", "t")):
                    continue
                w = stem
            break

    # Step 5a
    if w.endswith("e"):
        m = _measure(w[:-1])
        if m > 1 or (m == 1 and not _cvc(w[:-1])):
            w = w[:-1]

    # Step 5b
    if _measure(w) > 1 and _ends_double_consonant(w) and w.endswith("l"):
        w = w[:-1]

    return w
