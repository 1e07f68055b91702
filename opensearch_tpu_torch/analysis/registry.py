"""Analyzers, tokenizers, token filters and char filters (the port's copy
of opensearch_tpu.analysis.registry): the built-in analyzers `standard`,
`simple`, `whitespace`, `keyword`, `stop` and `english` (standard
tokenizer, lowercase, English stop words, Porter stemmer), and custom
analyzers declared in an index's `settings.analysis`.

Analysis runs on the host at index and query time; the device sees term
postings only. A token stream is a list of (term, position) pairs, so
phrase queries see positions. The standard tokenizer is the regex path
(a UAX#29-approximating word pattern); the reference's native ASCII
tokenizer produces the same token stream, so the port keeps only this
one.
"""

from __future__ import annotations

import functools
import re
import unicodedata
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from opensearch_tpu_torch.analysis.porter import porter_stem
from opensearch_tpu_torch.common.errors import IllegalArgumentError

Token = Tuple[str, int]  # (term, position)

# English stopword set (Lucene EnglishAnalyzer.ENGLISH_STOP_WORDS_SET)
ENGLISH_STOP_WORDS = frozenset([
    "a", "an", "and", "are", "as", "at", "be", "but", "by", "for", "if", "in",
    "into", "is", "it", "no", "not", "of", "on", "or", "such", "that", "the",
    "their", "then", "there", "these", "they", "this", "to", "was", "will", "with",
])

# UAX#29-approximating word pattern: runs of letters/digits stay together
# ("v2"), interior apostrophes/dots join letters ("don't", "U.S.A" — Lucene's
# MidLetter/MidNumLet), and dots/commas join digits ("3.14", "1,000" — MidNum),
# matching Lucene's StandardTokenizer word-break behavior.
_STANDARD_WORD = re.compile(
    r"[^\W_]+(?:['’.](?=[^\W\d_])[^\W\d_]+|[.,](?=\d)\d+)*", re.UNICODE)


# ---------------------------------------------------------------- tokenizers

def standard_tokenizer(text: str, max_token_length: int = 255) -> List[Token]:
    out = []
    for pos, m in enumerate(_STANDARD_WORD.finditer(text)):
        tok = m.group(0)
        if len(tok) <= max_token_length:
            out.append((tok, pos))
    return out


def whitespace_tokenizer(text: str, **_) -> List[Token]:
    return [(t, i) for i, t in enumerate(text.split())]


def keyword_tokenizer(text: str, **_) -> List[Token]:
    return [(text, 0)] if text else []


def letter_tokenizer(text: str, **_) -> List[Token]:
    return [(m.group(0), i) for i, m in enumerate(re.finditer(r"[^\W\d_]+", text, re.UNICODE))]


def lowercase_tokenizer(text: str, **_) -> List[Token]:
    return [(t.lower(), p) for t, p in letter_tokenizer(text)]


def _char_ngrams(text: str, min_gram: int, max_gram: int, edge: bool) -> List[str]:
    grams = []
    if edge:
        for n in range(min_gram, max_gram + 1):
            if n <= len(text):
                grams.append(text[:n])
    else:
        for start in range(len(text)):
            for n in range(min_gram, max_gram + 1):
                if start + n <= len(text):
                    grams.append(text[start:start + n])
    return grams


def ngram_tokenizer(text: str, min_gram: int = 1, max_gram: int = 2, **_) -> List[Token]:
    return [(g, i) for i, g in enumerate(_char_ngrams(text, min_gram, max_gram, edge=False))]


def edge_ngram_tokenizer(text: str, min_gram: int = 1, max_gram: int = 2, **_) -> List[Token]:
    return [(g, i) for i, g in enumerate(_char_ngrams(text, min_gram, max_gram, edge=True))]


TOKENIZERS: Dict[str, Callable[..., List[Token]]] = {
    "standard": standard_tokenizer,
    "whitespace": whitespace_tokenizer,
    "keyword": keyword_tokenizer,
    "letter": letter_tokenizer,
    "lowercase": lowercase_tokenizer,
    "ngram": ngram_tokenizer,
    "edge_ngram": edge_ngram_tokenizer,
}


# -------------------------------------------------------------- token filters
# A filter maps a token list to a token list. Removing a token keeps later
# positions intact (position increments), matching Lucene's StopFilter.

def lowercase_filter(tokens, **_):
    return [(t.lower(), p) for t, p in tokens]


def uppercase_filter(tokens, **_):
    return [(t.upper(), p) for t, p in tokens]


def stop_filter(tokens, stopwords=ENGLISH_STOP_WORDS, **_):
    if isinstance(stopwords, str):
        stopwords = ENGLISH_STOP_WORDS if stopwords == "_english_" else frozenset()
    elif isinstance(stopwords, (list, tuple)):
        stopwords = frozenset(stopwords)
    return [(t, p) for t, p in tokens if t not in stopwords]


def porter_stem_filter(tokens, **_):
    return [(porter_stem(t), p) for t, p in tokens]


def stemmer_filter(tokens, language: str = "english", **_):
    if language in ("english", "porter", "porter2", "light_english"):
        return porter_stem_filter(tokens)
    return tokens  # other languages pass through in round 1


def asciifolding_filter(tokens, **_):
    def fold(t):
        return "".join(c for c in unicodedata.normalize("NFKD", t)
                       if not unicodedata.combining(c))
    return [(fold(t), p) for t, p in tokens]


def trim_filter(tokens, **_):
    return [(t.strip(), p) for t, p in tokens]


def length_filter(tokens, min: int = 0, max: int = 2 ** 31 - 1, **_):
    return [(t, p) for t, p in tokens if min <= len(t) <= max]


def ngram_filter(tokens, min_gram: int = 1, max_gram: int = 2, **_):
    return [(g, p) for t, p in tokens for g in _char_ngrams(t, min_gram, max_gram, False)]


def edge_ngram_filter(tokens, min_gram: int = 1, max_gram: int = 2, **_):
    return [(g, p) for t, p in tokens for g in _char_ngrams(t, min_gram, max_gram, True)]


def shingle_filter(tokens, min_shingle_size: int = 2, max_shingle_size: int = 2,
                   output_unigrams: bool = True, token_separator: str = " ", **_):
    out = list(tokens) if output_unigrams else []
    terms = [t for t, _ in tokens]
    for n in range(min_shingle_size, max_shingle_size + 1):
        for i in range(len(terms) - n + 1):
            out.append((token_separator.join(terms[i:i + n]), tokens[i][1]))
    return out


def reverse_filter(tokens, **_):
    return [(t[::-1], p) for t, p in tokens]


def truncate_filter(tokens, length: int = 10, **_):
    return [(t[:length], p) for t, p in tokens]


def unique_filter(tokens, **_):
    seen = set()
    out = []
    for t, p in tokens:
        if t not in seen:
            seen.add(t)
            out.append((t, p))
    return out


@functools.lru_cache(maxsize=256)
def _compile_synonyms(rules: Tuple[str, ...]) -> Dict[str, List[str]]:
    expand: Dict[str, List[str]] = {}
    for rule in rules:
        if "=>" in rule:
            lhs, rhs = rule.split("=>", 1)
            targets = [s.strip() for s in rhs.split(",") if s.strip()]
            for src in (s.strip() for s in lhs.split(",")):
                if src:
                    expand.setdefault(src, []).extend(targets)
        else:
            group = [s.strip() for s in rule.split(",") if s.strip()]
            for src in group:
                expand.setdefault(src, []).extend(g for g in group)
    return expand


def synonym_filter(tokens, synonyms: Sequence[str] = (), **_):
    """Term→terms expansion from 'a, b => c' / 'a, b, c' rules (compiled once)."""
    expand = _compile_synonyms(tuple(synonyms))
    out: List[Token] = []
    for t, p in tokens:
        if t in expand:
            seen = set()
            for tgt in expand[t]:
                if tgt not in seen:
                    seen.add(tgt)
                    out.append((tgt, p))
        else:
            out.append((t, p))
    return out


TOKEN_FILTERS: Dict[str, Callable[..., List[Token]]] = {
    "lowercase": lowercase_filter,
    "uppercase": uppercase_filter,
    "stop": stop_filter,
    "porter_stem": porter_stem_filter,
    "stemmer": stemmer_filter,
    "asciifolding": asciifolding_filter,
    "trim": trim_filter,
    "length": length_filter,
    "ngram": ngram_filter,
    "edge_ngram": edge_ngram_filter,
    "shingle": shingle_filter,
    "reverse": reverse_filter,
    "truncate": truncate_filter,
    "unique": unique_filter,
    "synonym": synonym_filter,
}

# ----------------------------------------------------------------- char filters

def html_strip_char_filter(text: str, **_) -> str:
    return re.sub(r"<[^>]*>", " ", text)


def mapping_char_filter(text: str, mappings: Sequence[str] = (), **_) -> str:
    for rule in mappings:
        if "=>" in rule:
            src, tgt = rule.split("=>", 1)
            text = text.replace(src.strip(), tgt.strip())
    return text


def pattern_replace_char_filter(text: str, pattern: str = "", replacement: str = "", **_) -> str:
    return re.sub(pattern, replacement, text) if pattern else text


CHAR_FILTERS = {
    "html_strip": html_strip_char_filter,
    "mapping": mapping_char_filter,
    "pattern_replace": pattern_replace_char_filter,
}


# ------------------------------------------------------------------- analyzer

@dataclass
class Analyzer:
    name: str
    tokenizer: Callable[..., List[Token]]
    tokenizer_params: dict
    filters: List[Tuple[Callable, dict]]
    char_filters: List[Tuple[Callable, dict]]

    def analyze(self, text: str) -> List[Token]:
        if text is None:
            return []
        for cf, params in self.char_filters:
            text = cf(text, **params)
        tokens = self.tokenizer(text, **self.tokenizer_params)
        for f, params in self.filters:
            tokens = f(tokens, **params)
        return tokens

    def terms(self, text: str) -> List[str]:
        return [t for t, _ in self.analyze(text)]


def _builtin(name: str) -> Analyzer:
    if name == "standard":
        return Analyzer(name, standard_tokenizer, {}, [(lowercase_filter, {})], [])
    if name == "simple":
        return Analyzer(name, lowercase_tokenizer, {}, [], [])
    if name == "whitespace":
        return Analyzer(name, whitespace_tokenizer, {}, [], [])
    if name == "keyword":
        return Analyzer(name, keyword_tokenizer, {}, [], [])
    if name == "stop":
        return Analyzer(name, lowercase_tokenizer, {}, [(stop_filter, {})], [])
    if name == "english":
        return Analyzer(name, standard_tokenizer, {},
                        [(lowercase_filter, {}), (stop_filter, {}), (porter_stem_filter, {})], [])
    raise IllegalArgumentError(f"failed to find global analyzer [{name}]")


BUILTIN_ANALYZERS = ("standard", "simple", "whitespace", "keyword", "stop", "english")


class AnalysisRegistry:
    """Per-index analyzer registry built from index settings.

    Reference: index/analysis/AnalysisRegistry.java — custom analyzers are
    declared under `index.analysis.analyzer.<name>` with a tokenizer and filter
    chain; custom tokenizers/filters under `index.analysis.{tokenizer,filter,
    char_filter}.<name>` with a `type` plus parameters.
    """

    def __init__(self, analysis_settings: Optional[dict] = None):
        self._analyzers: Dict[str, Analyzer] = {n: _builtin(n) for n in BUILTIN_ANALYZERS}
        cfg = analysis_settings or {}
        custom_tokenizers = cfg.get("tokenizer", {})
        custom_filters = cfg.get("filter", {})
        custom_char_filters = cfg.get("char_filter", {})

        def resolve_tokenizer(name):
            if name in custom_tokenizers:
                params = dict(custom_tokenizers[name])
                typ = params.pop("type", name)
                if typ not in TOKENIZERS:
                    raise IllegalArgumentError(f"failed to find tokenizer type [{typ}]")
                return TOKENIZERS[typ], params
            if name in TOKENIZERS:
                return TOKENIZERS[name], {}
            raise IllegalArgumentError(f"failed to find tokenizer under [{name}]")

        def resolve_filter(name):
            if name in custom_filters:
                params = dict(custom_filters[name])
                typ = params.pop("type", name)
                if typ not in TOKEN_FILTERS:
                    raise IllegalArgumentError(f"failed to find filter type [{typ}]")
                return TOKEN_FILTERS[typ], params
            if name in TOKEN_FILTERS:
                return TOKEN_FILTERS[name], {}
            raise IllegalArgumentError(f"failed to find filter under [{name}]")

        def resolve_char_filter(name):
            if name in custom_char_filters:
                params = dict(custom_char_filters[name])
                typ = params.pop("type", name)
                if typ not in CHAR_FILTERS:
                    raise IllegalArgumentError(f"failed to find char_filter type [{typ}]")
                return CHAR_FILTERS[typ], params
            if name in CHAR_FILTERS:
                return CHAR_FILTERS[name], {}
            raise IllegalArgumentError(f"failed to find char_filter under [{name}]")

        for name, spec in cfg.get("analyzer", {}).items():
            spec = dict(spec)
            typ = spec.get("type", "custom")
            if typ != "custom" and typ in BUILTIN_ANALYZERS:
                base = _builtin(typ)
                if typ == "stop" and "stopwords" in spec:
                    base = Analyzer(name, base.tokenizer, base.tokenizer_params,
                                    [(stop_filter, {"stopwords": spec["stopwords"]})], [])
                self._analyzers[name] = base
                continue
            tok_fn, tok_params = resolve_tokenizer(spec.get("tokenizer", "standard"))
            filters = [resolve_filter(f) for f in spec.get("filter", [])]
            char_filters = [resolve_char_filter(f) for f in spec.get("char_filter", [])]
            self._analyzers[name] = Analyzer(name, tok_fn, tok_params, filters, char_filters)

    def get(self, name: str) -> Analyzer:
        a = self._analyzers.get(name)
        if a is None:
            raise IllegalArgumentError(f"failed to find analyzer [{name}]")
        return a

    def has(self, name: str) -> bool:
        return name in self._analyzers


def analyze_query_text(mapper, ft, text, analyzer_override=None) -> List[str]:
    """The analyzer-resolution chain for query text: the request's
    `analyzer`, else the field's search_analyzer, else its index analyzer.
    Non-text fields take the value as one exact term."""
    if ft is None:
        return []
    if ft.is_text:
        name = analyzer_override or ft.search_analyzer or ft.analyzer
        return mapper.analysis.get(name).terms(str(text))
    return [str(text)]
