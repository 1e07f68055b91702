"""Analyzers for the BM25 path: the built-in `standard`, `simple`,
`whitespace` and `keyword` analyzers.

`standard` is the regex tokenizer of opensearch_tpu.analysis.registry
(a UAX#29-approximating word pattern) followed by the lowercase filter. The
reference's native ASCII tokenizer produces the same token stream, so the
port keeps only the regex path.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

from opensearch_tpu_torch.common.errors import IllegalArgumentError

Token = Tuple[str, int]  # (term, position)

# runs of letters/digits stay together ("v2"), interior apostrophes/dots join
# letters ("don't", "U.S.A"), dots/commas join digits ("3.14", "1,000")
_STANDARD_WORD = re.compile(
    r"[^\W_]+(?:['’.](?=[^\W\d_])[^\W\d_]+|[.,](?=\d)\d+)*", re.UNICODE)
_LETTERS = re.compile(r"[^\W\d_]+", re.UNICODE)


def standard_tokenizer(text: str, max_token_length: int = 255) -> List[Token]:
    out = []
    for pos, m in enumerate(_STANDARD_WORD.finditer(text)):
        tok = m.group(0)
        if len(tok) <= max_token_length:
            out.append((tok, pos))
    return out


def whitespace_tokenizer(text: str) -> List[Token]:
    return [(t, i) for i, t in enumerate(text.split())]


def keyword_tokenizer(text: str) -> List[Token]:
    return [(text, 0)] if text else []


def lowercase_tokenizer(text: str) -> List[Token]:
    return [(m.group(0).lower(), i)
            for i, m in enumerate(_LETTERS.finditer(text))]


def lowercase_filter(tokens: List[Token]) -> List[Token]:
    return [(t.lower(), p) for t, p in tokens]


@dataclass
class Analyzer:
    name: str
    tokenizer: Callable[[str], List[Token]]
    filters: Tuple[Callable[[List[Token]], List[Token]], ...] = ()

    def analyze(self, text: str) -> List[Token]:
        if text is None:
            return []
        tokens = self.tokenizer(text)
        for f in self.filters:
            tokens = f(tokens)
        return tokens

    def terms(self, text: str) -> List[str]:
        return [t for t, _ in self.analyze(text)]


BUILTIN_ANALYZERS: Dict[str, Analyzer] = {
    "standard": Analyzer("standard", standard_tokenizer, (lowercase_filter,)),
    "simple": Analyzer("simple", lowercase_tokenizer),
    "whitespace": Analyzer("whitespace", whitespace_tokenizer),
    "keyword": Analyzer("keyword", keyword_tokenizer),
}


class AnalysisRegistry:
    """The analyzers an index can name (built-ins only in this slice)."""

    def get(self, name: str) -> Analyzer:
        a = BUILTIN_ANALYZERS.get(name)
        if a is None:
            raise IllegalArgumentError(f"failed to find analyzer [{name}]")
        return a

    def has(self, name: str) -> bool:
        return name in BUILTIN_ANALYZERS


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
