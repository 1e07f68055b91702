"""Fetch-phase subphases: per-hit enrichment after the device query phase
(the port of opensearch_tpu.search.fetch, without inner hits, which wait
for nested documents).

docvalue_fields, highlighting and explain are host work over the page's
hits only: the device already chose them. A doc's doc values are found
with two binary searches (the columns keep their pairs sorted by doc), not
a scan of the column.
"""

from __future__ import annotations

import fnmatch
import math
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from opensearch_tpu_torch.index.mapper import format_date_millis
from opensearch_tpu_torch.index.segment import (Segment,
                                                smallfloat_byte4_to_int)
from opensearch_tpu_torch.search import dsl
from opensearch_tpu_torch.search.executor import _doc_slice

DEFAULT_K1 = 1.2
DEFAULT_B = 0.75


# ----------------------------------------------------------- term extraction

def collect_field_terms(node, mapper) -> Dict[str, List[str]]:
    """The analyzed terms per field of a parsed query tree (what the
    highlighter and explain match against)."""
    out: Dict[str, List[str]] = {}

    def add(field: str, terms: List[str]):
        if field:
            out.setdefault(field, []).extend(t for t in terms if t)

    def analyze(field: str, text: Any) -> List[str]:
        ft = mapper.get_field(field)
        if ft is None or text is None:
            return []
        if ft.is_text:
            analyzer = mapper.analysis.get(ft.search_analyzer or ft.analyzer)
            return [t for t, _ in analyzer.analyze(str(text))]
        return [str(text)]

    def walk(n):
        if n is None:
            return
        if isinstance(n, dsl.BoolQuery):
            for child in list(n.must) + list(n.should) + list(n.filter):
                walk(child)  # must_not terms don't highlight
            return
        if isinstance(n, (dsl.ConstantScoreQuery,)):
            walk(n.filter)
            return
        if isinstance(n, dsl.DisMaxQuery):
            for child in n.queries:
                walk(child)
            return
        if isinstance(n, dsl.BoostingQuery):
            walk(n.positive)
            return
        if isinstance(n, (dsl.MatchQuery, dsl.MatchPhraseQuery,
                          dsl.MatchBoolPrefixQuery)):
            add(n.field, analyze(n.field, n.query))
            return
        if isinstance(n, dsl.MultiMatchQuery):
            for f in mapper.expand_field_patterns(list(n.fields)):
                f = f.split("^")[0]
                add(f, analyze(f, n.query))
            return
        if isinstance(n, dsl.TermQuery):
            add(n.field, [str(n.value)])
            return
        if isinstance(n, dsl.TermsQuery):
            add(n.field, [str(v) for v in n.values])
            return
        if isinstance(n, dsl.PrefixQuery):
            # trailing-* marker: highlight_text prefix-matches these
            add(n.field, [str(n.value) + "*"])
            return
        if isinstance(n, dsl.FuzzyQuery):
            add(n.field, [str(n.value)])
            return
        if isinstance(n, (dsl.QueryStringQuery, dsl.SimpleQueryStringQuery)):
            # best effort: bare terms against default/explicit fields
            fields = [f.split("^")[0] for f in (n.fields or [])]
            if getattr(n, "default_field", None):
                fields.append(n.default_field)
            text = re.sub(r'[+\-()"~*?:\\]|AND|OR|NOT', " ", n.query)
            for token in text.split():
                if ":" in token:
                    f, v = token.split(":", 1)
                    add(f, analyze(f, v))
                else:
                    for f in fields:
                        add(f, analyze(f, token))
            return
        # leaf without highlightable terms (range / exists / knn / ...)

    walk(node)
    return {f: list(dict.fromkeys(ts)) for f, ts in out.items()}


# -------------------------------------------------------------- highlighting

_TOKEN_RE = re.compile(r"\w+", re.UNICODE)


def highlight_text(text: str, terms: List[str], pre: str, post: str,
                   fragment_size: int, number_of_fragments: int,
                   analyzer) -> List[str]:
    """Unified-highlighter analog: analyze the stored text, mark the
    offsets of matching terms, cut fragments around the matches."""
    term_set = {t for t in terms if not t.endswith("*")}
    prefixes = tuple(t[:-1] for t in terms if t.endswith("*") and len(t) > 1)
    matches: List[Tuple[int, int]] = []
    for m in _TOKEN_RE.finditer(text):
        raw = m.group(0)
        analyzed = analyzer.analyze(raw) if analyzer else [(raw.lower(), 0)]
        if any(t in term_set or (prefixes and t.startswith(prefixes))
               for t, _ in analyzed):
            matches.append((m.start(), m.end()))
    if not matches:
        return []
    if number_of_fragments == 0:
        # whole-field highlighting
        return [_mark(text, matches, pre, post)]
    fragments: List[str] = []
    used_until = -1
    for start, end in matches:
        if start < used_until:
            continue
        frag_start = max(0, start - max(0, (fragment_size
                                            - (end - start)) // 2))
        # snap to a word boundary
        while frag_start > 0 and text[frag_start - 1].isalnum():
            frag_start -= 1
        frag_end = min(len(text), frag_start + fragment_size)
        while frag_end < len(text) and text[frag_end - 1].isalnum() \
                and not text[frag_end].isspace():
            frag_end += 1
        used_until = frag_end
        inside = [(s, e) for s, e in matches
                  if s >= frag_start and e <= frag_end]
        fragments.append(_mark(text[frag_start:frag_end],
                               [(s - frag_start, e - frag_start)
                                for s, e in inside], pre, post))
        if len(fragments) >= number_of_fragments:
            break
    return fragments


def _mark(text: str, spans: List[Tuple[int, int]], pre: str,
          post: str) -> str:
    out = []
    last = 0
    for s, e in spans:
        out.append(text[last:s])
        out.append(pre + text[s:e] + post)
        last = e
    out.append(text[last:])
    return "".join(out)


def build_highlights(source: Optional[dict], hl_body: dict, field_terms,
                     mapper) -> dict:
    if not source:
        return {}
    pre = (hl_body.get("pre_tags") or ["<em>"])[0]
    post = (hl_body.get("post_tags") or ["</em>"])[0]
    out = {}
    for field_spec, spec in (hl_body.get("fields") or {}).items():
        spec = spec or {}
        # wildcard highlight fields expand to the fields the query matched
        if "*" in field_spec:
            targets = [f for f in field_terms
                       if fnmatch.fnmatchcase(f, field_spec)]
        else:
            targets = [field_spec]
        for field in targets:
            _highlight_one(source, field, spec, hl_body, field_terms,
                           mapper, pre, post, out)
    return out


def _highlight_one(source, field, spec, hl_body, field_terms, mapper,
                   pre, post, out):
    hq = spec.get("highlight_query") or hl_body.get("highlight_query")
    if hq is not None:
        # highlight with another query's terms; one that does not parse
        # highlights nothing
        try:
            field_terms = collect_field_terms(dsl.parse_query(hq), mapper)
        except Exception:   # except-ok: highlighting is best-effort
            field_terms = {}
    terms = field_terms.get(field, [])
    if not terms:
        return
    value = _source_value(source, field)
    if value is None and "." in field:
        # multi-fields (text.fvh) read their parent's source value
        value = _source_value(source, field.rsplit(".", 1)[0])
    if value is None:
        return
    ft = mapper.get_field(field)
    analyzer = None
    if ft is not None and ft.is_text:
        analyzer = mapper.analysis.get(ft.search_analyzer or ft.analyzer)
    frags = highlight_text(
        str(value), terms,
        pre=(spec.get("pre_tags") or [pre])[0],
        post=(spec.get("post_tags") or [post])[0],
        fragment_size=int(spec.get("fragment_size",
                                   hl_body.get("fragment_size", 100))),
        number_of_fragments=int(spec.get(
            "number_of_fragments",
            hl_body.get("number_of_fragments", 5))),
        analyzer=analyzer)
    if frags:
        out[field] = frags


def _source_value(source: dict, path: str):
    cur: Any = source
    for part in path.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            return None
    if isinstance(cur, list):
        return " ".join(str(v) for v in cur)
    return cur


# ------------------------------------------------------------------- explain

def explain_hit(seg: Segment, ord_: int, node, mapper, stats,
                score: float) -> dict:
    """BM25 explanation tree of one hit, in the shape of Lucene's
    BM25Similarity.explain (weight / idf / tf) for the term clauses;
    compound and other queries get a summary node."""
    details = []
    field_terms = collect_field_terms(node, mapper)
    for field, terms in field_terms.items():
        ft = mapper.get_field(field)
        if ft is None or not ft.is_text:
            continue
        norms = seg.norms.get(field)
        dl = float(smallfloat_byte4_to_int(int(norms[ord_]))) \
            if norms is not None else 1.0
        avgdl = stats.avgdl(field)
        doc_count, _ = stats.field_stats(field)
        for term in terms:
            tf = _term_freq(seg, field, term, ord_)
            if tf <= 0:
                continue
            df = stats.df(field, term)
            idf_v = math.log(1.0 + (doc_count - df + 0.5) / (df + 0.5))
            tf_factor = (tf * (DEFAULT_K1 + 1.0)
                         / (tf + DEFAULT_K1 * (1.0 - DEFAULT_B
                                               + DEFAULT_B * dl / avgdl)))
            details.append({
                "value": idf_v * tf_factor,
                "description": f"weight({field}:{term} in {ord_}) "
                               f"[BM25Similarity], result of:",
                "details": [
                    {"value": idf_v,
                     "description": f"idf, computed as log(1 + (N - n + "
                                    f"0.5) / (n + 0.5)) from n={df}, "
                                    f"N={doc_count}",
                     "details": []},
                    {"value": tf_factor,
                     "description": f"tf, computed as freq * (k1 + 1) / "
                                    f"(freq + k1 * (1 - b + b * dl / "
                                    f"avgdl)) from freq={tf}, "
                                    f"k1={DEFAULT_K1}, b={DEFAULT_B}, "
                                    f"dl={dl}, avgdl={avgdl}",
                     "details": []},
                ],
            })
    return {"value": score,
            "description": "sum of:" if details else "score(...), computed "
            "by the TPU query phase",
            "details": details}


def _term_freq(seg: Segment, field: str, term: str, ord_: int) -> float:
    meta = seg.get_term(field, term)
    if meta is None:
        return 0.0
    blocks = slice(meta.start_block, meta.start_block + meta.num_blocks)
    docs = seg.post_docs[blocks].reshape(-1)
    tfs = seg.post_tf[blocks].reshape(-1)
    hit = np.nonzero(docs == ord_)[0]
    return float(tfs[hit[0]]) if len(hit) else 0.0


# ----------------------------------------------------------- field retrieval

def _format_numeric_dv(vals, ft) -> list:
    """Response formatting of numeric doc values, shared by the host
    column lookup and the result page's fused gather."""
    if ft is not None and ft.is_date:
        return [format_date_millis(int(v)) for v in vals]
    if ft is not None and (ft.is_numeric and ft.type in
                           ("integer", "long", "short", "byte")):
        return [int(v) for v in vals]
    return [float(v) for v in vals]


def docvalue_fields(seg: Segment, ord_: int, specs: List[Any],
                    mapper, prefetched: Optional[dict] = None) -> dict:
    """`prefetched`: the result page's fused docvalue gather for this hit
    ({field: [raw values]}, an empty list when the doc has none); those
    fields skip the column lookup, the others (multi-valued, keyword)
    read the host column."""
    out = {}
    for spec in specs or []:
        field = spec["field"] if isinstance(spec, dict) else spec
        if prefetched is not None and field in prefetched:
            vals = prefetched[field]
            if vals:
                out[field] = _format_numeric_dv(vals, mapper.get_field(field))
            continue
        col = seg.numeric_dv.get(field)
        if col is not None:
            vals = col.values[_doc_slice(col.doc_ids, ord_)]
            if len(vals):
                out[field] = _format_numeric_dv(vals,
                                                mapper.get_field(field))
            continue
        ocol = seg.ordinal_dv.get(field)
        if ocol is not None:
            ords = ocol.ords[_doc_slice(ocol.doc_ids, ord_)]
            if len(ords):
                out[field] = [ocol.dictionary[o] for o in ords]
    return out
