"""The multi-shard query phase on one card: the single-device form of
opensearch_tpu.parallel.distributed's DistributedSearcher.

Every (shard, segment) row of a request runs its own query phase against
the reader's resident image: the plan (or, when block-max is admitted,
K20's keep mask and K2 over the kept lanes), the eligibility and its
total, the keyed top-k at k_r = min(k, the row's Dp) (K3), and the
aggregations. The rows' top-k outputs land in one [R, W] buffer, and K21
(`ops/spmd.row_merge`) merges them into the request's k best: the
reference's intra-device top-k, `all_gather` and replicated top-k come to
one selection over the row-major concatenation on one device, and its
`psum` of totals to a sum. One device-to-host copy returns the merged
page, the total, the per-row pruned counts and the rows' aggregation
partials.

The reference stacks every row into a second copy of the index
(`HbmShardSet`) padded to a common shape; on one card that copy would
double the device bytes of every index for no change in any answer, so
the rows here read their readers' own images. Whether a request takes
this path is decided before anything launches (`plan_struct`,
`align_agg_plans`, `layout_compatible`: the reference's structure check
and `canonical_meta`'s raise); after that a kernel that fails raises.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from opensearch_tpu_torch.ops import bm25 as _bm25
from opensearch_tpu_torch.ops.bm25 import (blockmax_keep_mask,
                                           score_text_clause)
from opensearch_tpu_torch.ops.spmd import row_merge, row_value_key
from opensearch_tpu_torch.ops.topk import masked_topk_keyed
from opensearch_tpu_torch.search.aggs.engine import (agg_out_layout,
                                                     agg_statics, eval_aggs,
                                                     pack_agg_rows)
from opensearch_tpu_torch.search.plan_eval import _eval_plan


def spmd_blockmax_admitted(plan, d_pad: int, block_bounds: bool, k: int,
                           sort_spec, agg_plans) -> bool:
    """Block-max admission of the multi-shard query phase: a single bare
    non-constant text clause compiled with the gate on (it carries `tid`),
    a score sort, no aggregations, segments with seal-time bounds, a
    k_eff = min(k, Dp) the slice can cover, and enough lanes. `d_pad` is
    the largest Dp of the request's rows (the reference's stacked
    shape)."""
    k_eff = min(k, d_pad)
    return (plan.kind == "text" and len(plan.static) > 1
            and not plan.static[0] and "tid" in plan.inputs
            and sort_spec is None and not agg_plans
            and bool(block_bounds)
            and 0 < k_eff <= _bm25.BLOCKMAX_SLICE_BLOCKS * 128
            and plan.inputs["ids"].shape[-1] >= _bm25.BLOCKMAX_MIN_BLOCKS)


# agg plan kinds whose static[1] is a bucket cardinality that sizes the
# output bins and the flattened-ordinal stride
_CARD_KINDS = frozenset(
    {"bucket_ord", "bucket_num", "presence_ord", "presence_num", "value_hist"})


def align_agg_plans(per_row: Sequence[Sequence[Any]]) -> None:
    """Raise every row's cardinality statics to the cross-row maximum, in
    place, as the reference does before its structure check (its one
    program traces one agg structure). Raises ValueError where the
    structures diverge (a kind, a fused kind, other statics, a filter
    agg's plan): the request then takes the host loop."""

    def walk(nodes: Sequence[Any]):
        for group in zip(*nodes):
            kinds = {p.kind for p in group}
            if len(kinds) != 1:
                raise ValueError(
                    f"agg plan kinds diverge across rows: {kinds}")
            kind = kinds.pop()
            if kind.endswith("_bits"):
                raise ValueError(
                    f"fused agg kind [{kind}] cannot align across rows")
            if kind in _CARD_KINDS:
                card = max(p.static[1] for p in group)
                for p in group:
                    p.static = (p.static[0], card) + tuple(p.static[2:])
            elif any(p.static != group[0].static for p in group):
                raise ValueError(
                    f"agg statics diverge across rows for kind {kind}")
            walk([p.children for p in group])
            qps = [p.query_plan for p in group]
            if any((q is None) != (qps[0] is None) for q in qps):
                raise ValueError("filter-agg query plans diverge across rows")

    walk(list(per_row))


def plan_struct(p) -> tuple:
    """Shape-free structural signature (kind, static, a filter agg's query
    plan, children) of query plans and agg plans: the rows of one request
    must agree on it."""
    qp = getattr(p, "query_plan", None)
    return (p.kind, p.static,
            plan_struct(qp) if qp is not None else None,
            tuple(plan_struct(c) for c in p.children))


def _tree_layout(arrays: Dict) -> tuple:
    """The nesting and leaf ranks of a segment image (what the reference's
    stacking of the rows requires to agree)."""
    if isinstance(arrays, dict):
        return tuple(sorted((k, _tree_layout(v)) for k, v in arrays.items()))
    return arrays.dim()


def layout_compatible(images: Sequence[Tuple[Dict, Any]]) -> bool:
    """The rows' field layouts agree: norm rows, the numeric / ordinal /
    vector field sets (canonical_meta's check) and the image's nesting
    (the stacking's). A cross-index request whose indices map different
    fields fails it and takes the host loop, as in the reference."""
    arrays0, meta0 = images[0]
    layout0 = _tree_layout(arrays0)
    for arrays, meta in images[1:]:
        if (meta.norm_rows != meta0.norm_rows
                or meta.numeric_fields != meta0.numeric_fields
                or meta.ordinal_fields != meta0.ordinal_fields
                or meta.vector_fields != meta0.vector_fields
                or _tree_layout(arrays) != layout0):
            return False
    return True


class RowSearch:
    """The launched multi-shard query phase of one request: the merged
    page (K21's packed output) and each row's aggregation tail (None for a
    row without device aggregations), fetched together by `fetch`."""

    def __init__(self, merged, k: int, n_rows: int, agg_tails, agg_layouts):
        self.merged = merged
        self.k = k
        self.n_rows = n_rows
        self.agg_tails = agg_tails
        self.agg_layouts = agg_layouts

    def fetch(self):
        """ONE device-to-host copy: (the merged page as numpy f32, each
        row's numpy agg tail [1, W] or None)."""
        from opensearch_tpu_torch.search.executor import _fetch_rows
        tails = [t for t in self.agg_tails if t is not None]
        got = _fetch_rows([self.merged[None, :], *tails])
        it = iter(got[1:])
        return got[0][0], [None if t is None else next(it)
                           for t in self.agg_tails]


def run_rows(rows: Sequence[dict], k: int, sort_spec, bm: Optional[tuple],
             dev: torch.device) -> RowSearch:
    """Launch the query phase of every row and the merge. Each row dict
    carries `plan`, `agg_plans`, `arrays`, `meta`, `seg` (the host
    segment), `inputs` (its staged plan inputs) and `ms` (min_score f32
    [1]). `bm` is (n_terms, k_eff) when block-max is admitted, else None.
    """
    n_rows = len(rows)
    ks = [min(k, r["meta"].d_pad) for r in rows]
    width = max(3 * kr + 1 for kr in ks)
    buf = torch.empty(n_rows, width, dtype=torch.float32, device=dev)
    pruned = torch.zeros(n_rows, dtype=torch.int32, device=dev)
    agg_tails, agg_layouts = [], []
    for r, (row, k_r) in enumerate(zip(rows, ks)):
        arrays, meta, inputs, ms = (row["arrays"], row["meta"],
                                    row["inputs"], row["ms"])
        cursor = [0]
        if bm is not None:
            # the block-max arm: the text branch of _eval_plan over the
            # lanes K20 keeps
            my = inputs[0]
            cursor[0] = 1
            keep, row_pruned = blockmax_keep_mask(arrays, my, bm[0], bm[1],
                                                  ms)
            scores, hits = score_text_clause(arrays, my, block_keep=keep)
            matches = hits >= my["min_hits"][:, None]
            scores = torch.where(matches, scores, 0.0)
            pruned[r:r + 1].copy_(row_pruned)
        else:
            scores, matches = _eval_plan(row["plan"], arrays, inputs, cursor,
                                         1)
        scores, matches = scores.contiguous(), matches.contiguous()
        key = None
        if sort_spec is not None:
            field, order = sort_spec
            key = row_value_key(arrays["numeric"].get(field), order,
                                meta.d_pad, dev)
        masked_topk_keyed(scores, matches, arrays["live"], arrays["root"],
                          meta.num_docs, ms, key, k_r,
                          out=buf[r:r + 1, :3 * k_r + 1])
        if row["agg_plans"]:
            plans = list(row["agg_plans"])
            in_seg = torch.arange(meta.d_pad, device=dev) < meta.num_docs
            eligible = matches & arrays["live"] & arrays["root"] & in_seg \
                & (scores >= ms[:, None])
            outs: List[dict] = []
            eval_aggs(plans, arrays, inputs, cursor, eligible, outs,
                      agg_statics(row["seg"], plans, dev))
            layout = agg_out_layout(plans)[0]
            agg_tails.append(pack_agg_rows(outs, layout, 1, dev))
            agg_layouts.append(layout)
        else:
            agg_tails.append(None)
            agg_layouts.append(None)
    merged = row_merge(buf, ks, pruned, k)
    return RowSearch(merged, k, n_rows, agg_tails, agg_layouts)
