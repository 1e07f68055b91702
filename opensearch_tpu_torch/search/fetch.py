"""Fetch-phase subphases: per-hit enrichment after the device query phase
(the port of opensearch_tpu.search.fetch; the parent-join inner hits are
not ported, as the join queries are not).

docvalue_fields, highlighting and explain are host work over the page's
hits only: the device already chose them. A nested query's inner hits
evaluate its child plan once per (segment, nested query) on the device
(the port's `_eval_plan`: K2 / K4 / K15 / K25 as the plan needs), then
copy the dense scores and matches to the host in one copy, memoized
across the page's hits; each hit then slices its root's own nested rows.
A doc's doc values are found with two binary searches (the columns keep
their pairs sorted by doc), not a scan of the column.
"""

from __future__ import annotations

import fnmatch
import math
import re
import time
from dataclasses import fields as dc_fields
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from opensearch_tpu_torch.common.errors import IllegalArgumentError
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


# --------------------------------------------------------------- inner hits

# the inner-hits child evaluations' device-to-host copies: their count,
# bytes and wall ms (the copy, including the wait for the plan)
INNER_HITS_COPIES = {"copies": 0, "bytes": 0, "ms": 0.0}


def _eval_child_scores(plan, arrays, dev) -> Tuple[np.ndarray, np.ndarray]:
    """A nested query's child plan over the whole segment at B=1, then one
    copy of its dense (scores, matches) to the host."""
    from opensearch_tpu_torch.search.executor import stage_single
    from opensearch_tpu_torch.search.plan_eval import _eval_plan
    inputs, _ms = stage_single(plan.flatten_inputs([]), 0.0, dev)
    scores, matches = _eval_plan(plan, arrays, inputs, [0], 1)
    both = torch.stack([scores[0], matches[0].to(torch.float32)])
    t0 = time.perf_counter()
    host = both.cpu().numpy()
    INNER_HITS_COPIES["copies"] += 1
    INNER_HITS_COPIES["bytes"] += host.nbytes
    INNER_HITS_COPIES["ms"] += (time.perf_counter() - t0) * 1000.0
    return host[0], host[1] > 0


def collect_inner_hit_specs(node) -> List[Any]:
    """Every nested query of the tree that carries an inner_hits spec; two
    sections of one name are refused."""
    out: List[Any] = []

    def walk(n):
        if isinstance(n, dsl.NestedQuery) and n.inner_hits is not None:
            out.append(n)
        for f in dc_fields(n):
            sub = getattr(n, f.name, None)
            if isinstance(sub, dsl.QueryNode):
                walk(sub)
            elif isinstance(sub, (list, tuple)):
                for s in sub:
                    if isinstance(s, dsl.QueryNode):
                        walk(s)

    if node is not None:
        walk(node)
    names = [(n.inner_hits or {}).get("name", n.path) for n in out]
    for name in names:
        if names.count(name) > 1:
            raise IllegalArgumentError(
                f"[inner_hits] already contains an entry for key [{name}]")
    return out


def build_inner_hits(ex, seg_i: int, root_ord: int, nested_nodes,
                     cache: Dict) -> Dict[str, dict]:
    """The inner_hits sections of one page hit. `cache` memoizes the child
    evaluation per (segment, nested query) across the page's hits."""
    from opensearch_tpu_torch.search.compile import Compiler
    seg = ex.reader.segments[seg_i]
    arrays, meta = ex.reader.device[seg_i]
    out: Dict[str, dict] = {}
    for node in nested_nodes:
        spec = node.inner_hits or {}
        name = spec.get("name", node.path)
        # every requested section appears, empty where no row matched
        empty = {"hits": {"total": {"value": 0, "relation": "eq"},
                          "max_score": None, "hits": []}}
        if node.path not in seg.nested_paths:
            out[name] = empty
            continue
        pord = seg.nested_paths.index(node.path)
        key = (seg.uid, repr(node.query))
        got = cache.get(key)
        if got is None:
            compiler = Compiler(ex.reader.mapper,
                                ex.reader.stats_snapshot()[0])
            plan = compiler.compile(node.query, seg, meta)
            if len(cache) > 256:
                cache.clear()
            got = cache[key] = _eval_child_scores(
                plan, arrays, ex.reader.torch_device)
        scores, matches = got
        rows = _nested_rows(seg, root_ord)
        rows = rows[(seg.path_ords[rows] == pord) & seg.live[rows]]
        hit_rows = rows[matches[rows]] if len(rows) else rows
        if not len(hit_rows):
            out[name] = empty
            continue
        # offsets index the root's source array in row order
        offset_of = {int(r): i for i, r in enumerate(rows)}
        order = np.argsort(-scores[hit_rows], kind="stable")
        size = int(spec.get("size", 3))
        from_ = int(spec.get("from", 0))
        page = [int(hit_rows[j]) for j in order][from_:from_ + size]
        src_parent = _source_value_raw(seg.sources[root_ord], node.path)
        hits = []
        for r in page:
            off = offset_of[r]
            child_src = (src_parent[off]
                         if isinstance(src_parent, list)
                         and off < len(src_parent) else src_parent)
            hits.append({
                "_index": ex.reader.index_name,
                "_id": seg.doc_ids[root_ord],
                "_nested": {"field": node.path, "offset": off},
                "_score": float(scores[r]),
                "_source": child_src,
            })
        out[name] = {"hits": {
            "total": {"value": int(len(hit_rows)), "relation": "eq"},
            "max_score": float(scores[hit_rows].max()),
            "hits": hits,
        }}
    return out


def _nested_rows(seg: Segment, root_ord: int) -> np.ndarray:
    """A root's nested rows in row order, through a per-segment host CSR
    (built on first use)."""
    csr = getattr(seg, "_host_child_csr", None)
    if csr is None:
        from opensearch_tpu_torch.ops.device_segment import root_child_csr
        csr = seg._host_child_csr = root_child_csr(seg.parent_ptr,
                                                   seg.num_docs)
    start, rows = csr
    return rows[start[root_ord]:start[root_ord + 1]]


def _source_value_raw(source, path: str):
    """A dotted path of a source, lists kept whole (inner hits index the
    nested array by offset)."""
    cur = source
    for part in path.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            return None
    return cur
