"""Evaluation of compiled plans on a batch of B queries against one segment
(the subset of opensearch_tpu.search.plan_eval the port needs):
`match_all`, `match_none`, `text` (through K2), the doc-value filters
`num_terms` / `range_num` / `range_ord` (through K4), `exists`, `bool`,
`dis_max` and `const_score`, as elementwise torch ops on [B, Dp] tensors.
Plan inputs arrive stacked: per-query scalars are [B], per-lane inputs
[B, QB], rank masks [B, Up]."""

from __future__ import annotations

from typing import Dict, List

import torch

from opensearch_tpu_torch.common.errors import QueryShardError
from opensearch_tpu_torch.ops.bm25 import (ordinal_terms_match,
                                           range_match_on_ranks,
                                           score_text_clause)
from opensearch_tpu_torch.search.compile import Plan


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

    raise QueryShardError(f"plan kind [{kind}] is not supported by "
                          f"opensearch_tpu_torch yet")
