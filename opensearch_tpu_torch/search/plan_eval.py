"""Evaluation of compiled plans on a batch of B queries against one segment
(the subset of opensearch_tpu.search.plan_eval the port needs):
`match_all`, `match_none`, `text` (through K2), `precomputed` (host-built
scores and matches: ids, phrases; or a cached filter mask, score 0), the
doc-value filters `num_terms` / `range_num` / `range_ord` (through K4),
`exists`, `knn` (through K7 or K8, then K3), `maxsim` (through K10 or
K11, then K3), `bool`, `dis_max`, `const_score`, and the scoring kinds
`function_score` (K18), `terms_set`, `distance_feature`, `boosting` and
`script_score` (K19; a script's expression is torch ops), their value
columns through K15, as elementwise torch ops on [B, Dp] tensors. Plan
inputs arrive stacked: per-query scalars are [B], per-lane inputs
[B, QB], rank masks [B, Up], precomputed planes [B, Dp], query vectors
[B, dims], query token matrices [B, Tq, dims]."""

from __future__ import annotations

from typing import Dict, List

import torch

from opensearch_tpu_torch.common.errors import QueryShardError
from opensearch_tpu_torch.ops.agg_kernels import dense_numeric as _dense
from opensearch_tpu_torch.ops.bm25 import (ordinal_terms_match,
                                           range_match_on_ranks,
                                           score_text_clause)
from opensearch_tpu_torch.ops.knn import (exact_knn_scores, ivf_knn_scores,
                                          knn_match_topk)
from opensearch_tpu_torch.ops.maxsim import (exact_maxsim_scores,
                                             maxsim_match_topk,
                                             pq_maxsim_scores)
from opensearch_tpu_torch.ops import scoring
from opensearch_tpu_torch.script.painless import compile_score_script
from opensearch_tpu_torch.search.compile import Plan


def dense_numeric(seg: Dict, field: str, d_pad: int, missing: float = 0.0):
    """A per-doc dense value column from a numeric field's (doc, value)
    pairs through K15: (the doc's first (smallest) value, `missing` where
    absent, f32 [Dp]; the field's exists bool [Dp]; the doc's value count
    int32 [Dp]). Shared by matrix_stats and the scoring kinds
    (script_score, function_score, terms_set, distance_feature)."""
    col = seg["numeric"][field]
    value, counts = _dense(col["doc_ids"], col["values_f32"], d_pad, missing)
    return value, col["exists"], counts


def _eval_plan(plan: Plan, seg: Dict[str, torch.Tensor],
               inputs: List[Dict[str, torch.Tensor]], cursor: List[int],
               bsz: int):
    """(scores f32 [B, Dp], matches bool [B, Dp]) of one plan node; scores
    are zero wherever matches is false."""
    my = inputs[cursor[0]]
    cursor[0] += 1
    d_pad = seg["live"].shape[0]
    dev = seg["live"].device
    kind = plan.kind

    if kind == "match_all":
        return (my["boost"][:, None].expand(bsz, d_pad).contiguous(),
                torch.ones(bsz, d_pad, dtype=torch.bool, device=dev))

    if kind == "match_none":
        return (torch.zeros(bsz, d_pad, dtype=torch.float32, device=dev),
                torch.zeros(bsz, d_pad, dtype=torch.bool, device=dev))

    if kind == "text":
        constant = plan.static[0]
        scores, hits = score_text_clause(seg, my)
        matches = hits >= my["min_hits"][:, None]
        if constant:
            scores = torch.where(matches, my["boost"][:, None], 0.0)
        else:
            scores = torch.where(matches, scores, 0.0)
        return scores, matches

    if kind == "precomputed":
        if "scores" in my:
            return my["scores"], my["matches"]
        # a cached filter mask (indices/query_cache.py): a filter scores 0
        return (torch.zeros(bsz, d_pad, dtype=torch.float32, device=dev),
                my["matches"])

    if kind in ("num_terms", "range_num", "range_ord"):
        src = "ordinal" if kind == "range_ord" else "numeric"
        col = seg[src][plan.static[0]]
        ords = col["ords"] if kind == "range_ord" else col["val_ords"]
        ident = plan.static[1] if len(plan.static) > 1 else False
        if kind == "num_terms":
            matches = ordinal_terms_match(col["doc_ids"], ords, my["mask"],
                                          d_pad, ident)
        else:
            matches = range_match_on_ranks(col["doc_ids"], ords, my["lo"],
                                           my["hi"], d_pad, ident)
        return torch.where(matches, my["boost"][:, None], 0.0), matches

    if kind == "exists":
        ctype, key = plan.static
        if ctype == "norms":
            exists = seg["norms"][key] > 0
        else:
            exists = seg[ctype][key]["exists"]
        matches = exists[None, :].expand(bsz, d_pad).contiguous()
        return torch.where(matches, my["boost"][:, None], 0.0), matches

    if kind == "knn":
        field, k, space, method, nprobe = plan.static
        col = seg["vector"][field]
        eligible = (col["exists"] & seg["live"])[None, :].expand(
            bsz, d_pad)
        if plan.children:
            _, fmatches = _eval_plan(plan.children[0], seg, inputs, cursor,
                                     bsz)
            eligible = eligible & fmatches
        if method == "ivf":
            scores, cand = ivf_knn_scores(
                col["ivf_packed_vecs"], col["ivf_packed_ids"],
                col["ivf_centroids"], col["ivf_block_centroid"], d_pad,
                my["query"], space, nprobe)
            eligible = eligible & cand
        else:
            scores = exact_knn_scores(col["vectors"], my["query"], space)
        scores, matches = knn_match_topk(scores, eligible.contiguous(),
                                         seg["live"], k)
        return scores * my["boost"][:, None], matches

    if kind == "maxsim":
        field, k, compression = plan.static
        col = seg["rank_vectors"][field]
        eligible = (col["exists"] & seg["live"])[None, :].expand(
            bsz, d_pad)
        if plan.children:
            _, fmatches = _eval_plan(plan.children[0], seg, inputs, cursor,
                                     bsz)
            eligible = eligible & fmatches
        if compression == "pq":
            scores = pq_maxsim_scores(col["codes"], col["codebook"],
                                      col["token_count"], my["query"],
                                      my["qmask"])
        else:
            scores = exact_maxsim_scores(col["tokens"], col["token_count"],
                                         my["query"], my["qmask"])
        scores, matches = maxsim_match_topk(scores, eligible.contiguous(),
                                            seg["live"], k)
        return scores * my["boost"][:, None], matches

    if kind == "dis_max":
        child = [_eval_plan(c, seg, inputs, cursor, bsz)
                 for c in plan.children]
        matches = torch.zeros(bsz, d_pad, dtype=torch.bool, device=dev)
        best = torch.zeros(bsz, d_pad, dtype=torch.float32, device=dev)
        total = torch.zeros(bsz, d_pad, dtype=torch.float32, device=dev)
        for s, m in child:
            matches = matches | m
            best = torch.maximum(best, s)
            total = total + s
        scores = best + my["tie"][:, None] * (total - best)
        return torch.where(matches, scores * my["boost"][:, None],
                           0.0), matches

    if kind == "bool":
        n_must, n_filter, n_should, _ = plan.static
        child = [_eval_plan(c, seg, inputs, cursor, bsz)
                 for c in plan.children]
        must = child[:n_must]
        filt = child[n_must:n_must + n_filter]
        should = child[n_must + n_filter:n_must + n_filter + n_should]
        must_not = child[n_must + n_filter + n_should:]
        matches = torch.ones(bsz, d_pad, dtype=torch.bool, device=dev)
        scores = torch.zeros(bsz, d_pad, dtype=torch.float32, device=dev)
        for s, m in must:
            matches &= m
            scores += s
        for _, m in filt:
            matches &= m
        if should:
            should_count = torch.zeros(bsz, d_pad, dtype=torch.int32,
                                       device=dev)
            for s, m in should:
                should_count += m.to(torch.int32)
                scores += s
            matches &= should_count >= my["msm"][:, None]
        for _, m in must_not:
            matches &= ~m
        scores = torch.where(matches, scores * my["boost"][:, None], 0.0)
        return scores, matches

    if kind == "const_score":
        _, m = _eval_plan(plan.children[0], seg, inputs, cursor, bsz)
        return torch.where(m, my["boost"][:, None], 0.0), m

    if kind == "script_score":
        source, pkeys, static_params = plan.static
        child_s, child_m = _eval_plan(plan.children[0], seg, inputs,
                                      cursor, bsz)
        new = _run_script(seg, d_pad, source, child_s, pkeys,
                          static_params, my, "p_")
        return scoring.script_score_wrap(child_m, _plane(new, bsz, d_pad,
                                                         dev), my["boost"])

    if kind == "function_score":
        return scoring.function_score(*function_score_inputs(
            plan, seg, inputs, cursor, bsz, my))

    if kind == "terms_set":
        field_msm = plan.static[0]
        child = [_eval_plan(c, seg, inputs, cursor, bsz)
                 for c in plan.children]
        if not child:
            return (torch.zeros(bsz, d_pad, dtype=torch.float32,
                                device=dev),
                    torch.zeros(bsz, d_pad, dtype=torch.bool, device=dev))
        if field_msm is not None:
            msm, msm_exists, _ = dense_numeric(seg, field_msm, d_pad)
            return scoring.terms_set(child, msm, msm_exists, None,
                                     my["boost"])
        return scoring.terms_set(child, None, None, my["msm"], my["boost"])

    if kind == "distance_feature":
        value, exists, _ = dense_numeric(seg, plan.static[0], d_pad)
        return scoring.distance_feature(value, exists, my["origin"],
                                        my["pivot"], my["boost"])

    if kind == "boosting":
        pos_s, pos_m = _eval_plan(plan.children[0], seg, inputs, cursor,
                                  bsz)
        _, neg_m = _eval_plan(plan.children[1], seg, inputs, cursor, bsz)
        return scoring.boosting(pos_s, pos_m, neg_m, my["nb"], my["boost"])

    raise QueryShardError(f"plan kind [{kind}] is not supported by "
                          f"opensearch_tpu_torch yet")


def _run_script(seg, d_pad: int, source: str, score, pkeys, static_params,
                my, prefix: str):
    """A score script's value over the segment: its doc-value columns
    through K15, numeric params as [B, 1] per-query columns."""
    script = compile_score_script(source)
    columns = {f: dense_numeric(seg, f, d_pad) for f in script.fields}
    params = {k: my[f"{prefix}{k}"][:, None] for k in pkeys}
    params.update(dict(static_params))
    return script(columns, score, params)


def _plane(value, bsz: int, d_pad: int, dev) -> torch.Tensor:
    """A script's result as an f32 [B, Dp] plane."""
    return torch.as_tensor(value, dtype=torch.float32, device=dev) \
        .expand(bsz, d_pad)


def function_score_inputs(plan: Plan, seg, inputs, cursor, bsz: int, my):
    """K18's arguments for one function_score node: the child's (scores,
    matches), each function's filter and value source (a K15 column or a
    script's plane), the per-query parameter table and the modes."""
    score_mode, boost_mode, fn_specs = plan.static
    d_pad = seg["live"].shape[0]
    dev = seg["live"].device
    child_s, child_m = _eval_plan(plan.children[0], seg, inputs, cursor,
                                  bsz)
    zeros = torch.zeros(bsz, dtype=torch.float32, device=dev)
    cols = [my["boost"], my["max_boost"], my.get("min_score", zeros)]
    fns = []
    child_i = 1
    for i, spec in enumerate(fn_specs):
        fkind, has_filter = spec[0], spec[-1]
        fmask = None
        if has_filter:
            _, fmask = _eval_plan(plan.children[child_i], seg, inputs,
                                  cursor, bsz)
            child_i += 1
        fn = scoring.ScoreFunction(kind=fkind, filter=fmask,
                                   has_weight=f"f{i}_weight" in my)
        if fkind == "fvf":
            fn.modifier = spec[2]
            if spec[1] is not None:
                fn.value, fn.exists, _ = dense_numeric(seg, spec[1], d_pad)
        elif fkind == "random":
            fn.seed = spec[1]
        elif fkind == "script":
            source, pkeys, static_params = spec[1], spec[2], spec[3]
            fn.plane = _plane(_run_script(seg, d_pad, source, child_s,
                                          pkeys, static_params, my,
                                          f"f{i}_p_"), bsz, d_pad, dev)
        elif fkind == "decay":
            fn.decay = spec[1]
            if spec[2] is not None:
                fn.value, fn.exists, _ = dense_numeric(seg, spec[2], d_pad)
        elif fkind != "weight_only":
            raise QueryShardError(f"unknown score function [{fkind}]")
        fns.append(fn)
        cols.extend(my.get(f"f{i}_{slot}", zeros)
                    for slot in scoring.FN_SLOTS)
    params = torch.stack(cols, dim=1)
    return (child_s, child_m, fns, params, score_mode, boost_mode,
            "min_score" in my)
