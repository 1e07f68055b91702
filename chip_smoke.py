#!/usr/bin/env python3
"""Smoke test of opensearch_tpu_torch on one NVIDIA GPU.

Run from the repository root, with no arguments, on a machine with one CUDA
card:  python3 chip_smoke.py

Phases, each printing what it finds; any failure exits nonzero:
 1. build the CUDA kernels from opensearch_tpu_torch/ops/csrc (in
    parallel), print the build times and the card's name and power limit;
    make the 1M-passage corpus of the BM25 scale phase and the 10M-doc
    structured segment of the aggregation scale phase (set-up);
 2. run every kernel on the card at its main path's shapes and hold it
    against its plain PyTorch version on the same inputs: K1
    bm25_candidate, K2 score_text_clause, K3 masked_topk at Dp = 2^20 (ids,
    hits and totals exactly, scores within SCORE_ATOL: both sides round
    every BM25 operation once, the kernels build with --fmad=false); K4
    pairs_match, K5 binned_popcount, K6 binned_reduce at B=32 and
    NVp = Dp = 2^24 (masks, counts, min and max exactly, f32 sums within
    n * 2^-24 * sum|v| of the f64 sums, and the same bits on two runs);
    time the kernel (device time, CUDA-graph replay), one wrapper call
    (host checks and launch included), the plain version and the library
    call (CUDA events, median, L2 flushed);
 3. serve on the card through Node().request: a 5,000-passage BM25 index
    and a 5,000-doc structured index (`docs`: tag / views / ts, two
    segments, deletes, multi-valued tags, docs without views), the parity
    bodies and the aggregation bodies through `_search` and a B=32
    `_msearch` each; every response must equal Node(device="cpu")'s (the
    plain versions), and every kernel K1-K6 must have launched during this
    run;
 4. BM25 scale: one shard of 1,000,000 passages from build_shards_fast
    served through SearchExecutor at B=1 and B=32, sample pages checked
    against the plain versions, image bytes and p50/p99 wall times;
 5. aggregation scale: one shard of 10,000,000 structured docs served with
    bench.py's agg_terms and date_hist body families at B=1 and B=32:
    p50/p99 wall times, queries/s, image bytes and the profiler's busy
    share; sampled responses checked against an f64 numpy oracle and
    against the plain versions.

`--out DIR` writes the long outputs (nvcc's ptxas report, the profiler's
per-kernel tables) under DIR. The card's name and power limit are printed in
phase 1 and again on the third line from the end; the line before the last
is the `kernels` JSON; the last line is the result: {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SCORE_ATOL = 0.0          # kernels and plain versions round identically
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12          # H100 SXM f32, outside the tensor cores
SCALE_DOCS = 1_000_000
SCALE_MATERIALIZE_TERMS = 4096
AGG_SCALE_DOCS = 10_000_000   # one shard of a 165M-doc nyc_taxis index
AGG_BATCH = 32
AGG_BODIES_PER_FAMILY = 64
F32_SUM_EPS = 2.0 ** -24


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 15, warmup: int = 3) -> float:
    """Median milliseconds of one call of fn() on the stream, between CUDA
    events, L2 flushed before each rep. A call whose host work outlasts its
    device work (a wrapper's checks and launch, a plain version's syncs)
    is measured with that host time included."""
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(torch, fn, reps: int = 15) -> float:
    """Median device milliseconds of the kernels fn() launches: fn is
    captured once into a CUDA graph and the graph is replayed between CUDA
    events, L2 flushed before each rep, so no host time is counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(torch, graph.replay, reps=reps, warmup=2)


def max_abs_err(np, got, want) -> float:
    both = np.isfinite(got) & np.isfinite(want)
    if not np.array_equal(np.isfinite(got), np.isfinite(want)):
        raise AssertionError("kernel and plain version disagree on which "
                             "slots are -inf")
    return float(np.max(np.abs(got[both] - want[both]), initial=0.0))


def check_rows(np, got, want, k: int, what: str) -> float:
    from opensearch_tpu_torch.ops.topk import unpack_rows
    gs, gi, gt = unpack_rows(got, k)
    ws, wi, wt = unpack_rows(want, k)
    if not np.array_equal(gt, wt):
        raise AssertionError(f"{what}: totals differ")
    if not np.array_equal(gi, wi):
        bad = np.argwhere(gi != wi)[:5].tolist()
        raise AssertionError(f"{what}: ids differ at {bad}")
    err = max_abs_err(np, gs, ws)
    if err > SCORE_ATOL:
        raise AssertionError(f"{what}: scores differ by {err}")
    return err


def stacked_inputs(torch, plans, min_scores, device):
    """The executor's envelope for a batch of plans: packed, uploaded once,
    unpacked into views."""
    import numpy as np
    from opensearch_tpu_torch.search.executor import (
        pack_leaves, stack_flat_inputs, unflatten_inputs, unpack_leaves)
    stacked, treedef = stack_flat_inputs([p.flatten_inputs([])
                                          for p in plans])
    stacked.append(np.asarray(min_scores, np.float32))
    buf, layout = pack_leaves(stacked, pin=device.type == "cuda")
    leaves = unpack_leaves(buf.to(device), layout)
    return unflatten_inputs(treedef, leaves[:-1]), leaves[-1]


def pick_terms(seg, n_terms: int, rows: int, max_blocks: int = 128):
    """Per row, n_terms distinct terms whose blocks sum to at most
    max_blocks lanes' worth, taking the largest such terms first."""
    per = max_blocks // n_terms
    pool = sorted(((tm.num_blocks, t) for (f, t), tm in seg.term_dict.items()
                   if tm.num_blocks <= per), reverse=True)
    out = []
    for r in range(rows):
        start = (r * n_terms) % max(len(pool) - n_terms, 1)
        out.append(" ".join(t for _, t in pool[start:start + n_terms]))
    return out


def phase_kernels(torch, np, seg, mapper, arrays, meta, dev):
    """K1-K3 against their plain versions at the main path's shapes."""
    from opensearch_tpu_torch.ops import bm25, topk
    from opensearch_tpu_torch.search import dsl
    from opensearch_tpu_torch.search.compile import Compiler, ShardStats
    from opensearch_tpu_torch.search.plan_eval import _eval_plan
    from opensearch_tpu_torch.utils.demo import fast_query_terms

    compiler = Compiler(mapper, ShardStats([seg]))

    def plans_for(texts):
        return [compiler.compile(dsl.parse_query(
            {"match": {"body": t}}), seg, meta) for t in texts]

    d_pad = meta.d_pad
    results = {}
    n_posting_blocks = lambda blk: int((blk["ids"] >= 0).sum().item())

    # K1 at B in {1, 32}, n_terms in {1, 4, 16}, up to 16,384 lanes; then
    # B=32 of the scale cell's own 3-term queries (fewer lanes)
    terms = sorted(t for _, t in seg.term_dict)
    cell = [p for p in plans_for(fast_query_terms(64, terms, seed=600,
                                                  terms_per_query=3))
            if p.inputs["ids"].shape[0] * 128 <= bm25.CANDIDATE_MAX_LANES
            and p.static[1] == 3][:32]
    for rows, n_terms in ((1, 1), (1, 4), (1, 16), (32, 1), (32, 4),
                          (32, 16), (32, 3)):
        if n_terms == 3:
            plans = cell
        else:
            plans = plans_for(pick_terms(seg, n_terms, rows))
            if any(p.static[1] != n_terms for p in plans):
                raise AssertionError("term pick produced duplicate terms")
        bsz = len(plans)
        nodes, ms = stacked_inputs(torch, plans, [-np.inf] * bsz, dev)
        blk = nodes[0]
        qb = blk["ids"].shape[1]
        k = 100

        def kern():
            return bm25.bm25_candidate(arrays, blk, n_terms, False, k, ms)

        def plain():
            return bm25.bm25_candidate_plain(arrays, blk, n_terms, False,
                                             k, ms)
        err = check_rows(np, kern().cpu().numpy(), plain().cpu().numpy(),
                         k, f"K1 B={bsz} terms={n_terms}")
        blocks = n_posting_blocks(blk)
        # doc, tf and norm per posting, live and root per doc
        nbytes = (blocks * 128 * (4 + 4 + 4 + 2)
                  + bsz * qb * 8 + bsz * (2 * k + 1) * 4)
        flops = blocks * 128 * 10
        rec = {"shape": f"B={bsz} QB={qb} lanes={qb * 128} "
                        f"terms={n_terms} k={k}",
               "max_abs_err": err, "ms": graph_ms(torch, kern),
               "call_ms": cuda_ms(torch, kern),
               "plain_ms": cuda_ms(torch, plain, reps=5),
               "library_ms": None,
               "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                               flops / F32_FLOPS) * 1e3,
               "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
               >= flops / F32_FLOPS else "operations"}
        results.setdefault("bm25_candidate", []).append(rec)
        log("K1", json.dumps(rec))

    # K2 and K3 at Dp = 2^20 on dense-path queries (20 terms)
    for bsz in (1, 32):
        texts = fast_query_terms(bsz, sorted(t for _, t in seg.term_dict),
                                 seed=90 + bsz, terms_per_query=20)
        plans = plans_for(texts)
        nodes, ms = stacked_inputs(torch, plans, [-np.inf] * bsz, dev)
        blk = nodes[0]

        def kern2():
            return bm25.score_text_clause(arrays, blk)

        def plain2():
            return bm25.score_text_clause_plain(arrays, blk)
        (ks, kh), (ps, ph) = kern2(), plain2()
        if not torch.equal(kh, ph):
            raise AssertionError(f"K2 B={bsz}: hits differ")
        err = float((ks - ps).abs().max().item())
        if err > SCORE_ATOL:
            raise AssertionError(f"K2 B={bsz}: scores differ by {err}")
        blocks = n_posting_blocks(blk)
        qb = blk["ids"].shape[1]
        nbytes = blocks * 128 * 12 + bsz * qb * 8 + bsz * d_pad * 8
        flops = blocks * 128 * 10
        rec = {"shape": f"B={bsz} QB={qb} Dp={d_pad} blocks={blocks}",
               "max_abs_err": err, "ms": graph_ms(torch, kern2),
               "call_ms": cuda_ms(torch, kern2),
               "plain_ms": cuda_ms(torch, plain2, reps=5),
               "library_ms": None,
               "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                               flops / F32_FLOPS) * 1e3,
               "bound_by": "bytes"}
        results.setdefault("score_text_clause", []).append(rec)
        log("K2", json.dumps(rec))

        scores, matches = _eval_plan(plans[0], arrays, [blk], [0], bsz)
        for k in (10, 100, 1000):
            def kern3():
                return topk.masked_topk(scores, matches, arrays["live"],
                                        arrays["root"], meta.num_docs, ms, k)

            def plain3():
                return topk.masked_topk_plain(scores, matches, arrays["live"],
                                              arrays["root"], meta.num_docs,
                                              ms, k)
            err = check_rows(np, kern3().cpu().numpy(),
                             plain3().cpu().numpy(), k, f"K3 B={bsz} k={k}")
            masked = torch.where(matches, scores, float("-inf"))

            def library():
                return torch.topk(masked, k, dim=1)
            nbytes = bsz * d_pad * 5 + d_pad * 2 + bsz * (2 * k + 1) * 4
            rec = {"shape": f"B={bsz} Dp={d_pad} k={k}",
                   "max_abs_err": err, "ms": graph_ms(torch, kern3),
                   "call_ms": cuda_ms(torch, kern3),
                   "plain_ms": cuda_ms(torch, plain3, reps=5),
                   "library_ms": graph_ms(torch, library),
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "bound_by": "bytes"}
            results.setdefault("masked_topk", []).append(rec)
            log("K3", json.dumps(rec))
    return results


def phase_serving(torch, np, device=None):
    """Node() on the card against Node(device='cpu') on the same data: the
    BM25 parity bodies on `passages` and the aggregation bodies on `docs`,
    each as `_search` requests and one B=32 `_msearch`. `device` names
    another device for a rehearsal on the CPU."""
    parity = _parity()
    from opensearch_tpu_torch.node import Node
    from opensearch_tpu_torch.ops import _build

    gpu = Node() if device is None else Node(device=device)
    cpu = Node(device="cpu")
    if gpu.device.type != (device or "cuda"):
        raise AssertionError(f"Node() resolved to {gpu.device}")
    for node in (gpu, cpu):
        parity.load_index(node, "passages", n_docs=5000)
        parity.load_docs_index(node, "docs", n_docs=parity.DOCS_N)
    payload = parity.msearch_ndjson("passages", parity.msearch_bodies(32))
    agg_bodies = dict(parity.AGG_BODIES)
    for mode in ("agg_terms", "date_hist"):
        for j, b in enumerate(parity.bench_agg_bodies(mode, 3)):
            agg_bodies[f"{mode}_{j}"] = b
    agg_payload = parity.msearch_ndjson("docs",
                                        parity.agg_msearch_bodies(32))
    names = sorted(parity.SEARCH_BODIES)
    agg_names = sorted(agg_bodies)
    _build.reset_launches()
    t0 = time.perf_counter()
    got = {n: gpu.request("POST", "/passages/_search",
                          parity.SEARCH_BODIES[n]) for n in names}
    got_m = gpu.request("POST", "/_msearch", payload)
    got_a = {n: gpu.request("POST", "/docs/_search", agg_bodies[n])
             for n in agg_names}
    got_am = gpu.request("POST", "/_msearch", agg_payload)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    log(f"serving: {len(names)} BM25 _search + one B=32 _msearch, "
        f"{len(agg_names)} agg _search + one B=32 agg _msearch on the card "
        f"in {wall * 1e3:.3f} ms; launches {json.dumps(launches)}")
    for n in names:
        if got[n]["_status"] != 200:
            raise AssertionError(f"_search {n}: {got[n]}")
        parity.assert_same_response(
            got[n], cpu.request("POST", "/passages/_search",
                                parity.SEARCH_BODIES[n]), n)
    parity.assert_same_response(got_m, cpu.request("POST", "/_msearch",
                                                   payload), "msearch")
    for n in agg_names:
        if got_a[n]["_status"] != 200 or "aggregations" not in got_a[n]:
            raise AssertionError(f"agg _search {n}: {got_a[n]}")
        parity.assert_same_response(
            got_a[n], cpu.request("POST", "/docs/_search", agg_bodies[n]), n)
    parity.assert_same_response(got_am, cpu.request("POST", "/_msearch",
                                                    agg_payload),
                                "agg msearch")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    log(f"serving: {len(names) + 32} BM25 pages and {len(agg_names) + 32} "
        f"agg responses equal the plain versions'")
    return launches


def _parity():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_common as parity
    return parity


def agg_segment(np, n_docs: int):
    """The aggregation scale cell's shard: structured columns drawn with
    synth_docs' distributions, sealed through segment_from_arrays."""
    from opensearch_tpu_torch.utils.demo import structured_segment
    t0 = time.perf_counter()
    mapper, seg = structured_segment(n_docs, seed=42, seg_id="s0")
    log(f"agg corpus: {seg.num_docs} docs (tag / views / ts), "
        f"{len(seg.numeric_dv['ts'].unique)} distinct ts, built in "
        f"{time.perf_counter() - t0:.3f} s")
    return mapper, seg


def _bytes_bound(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def _same_bits(torch, a, b) -> bool:
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def phase_agg_kernels(torch, np, mapper, seg, dev, bsz: int = AGG_BATCH):
    """K4-K6 against their plain versions at the aggregation scale cell's
    shapes: B queries of bench.py's two families over the structured
    shard (NVp = Dp)."""
    from opensearch_tpu_torch.ops import binned, bm25
    from opensearch_tpu_torch.ops.device_segment import upload_segment
    from opensearch_tpu_torch.search import dsl
    from opensearch_tpu_torch.search.aggs import engine
    from opensearch_tpu_torch.search.aggs.parse import parse_aggs
    from opensearch_tpu_torch.search.compile import Compiler, ShardStats
    from opensearch_tpu_torch.search.plan_eval import _eval_plan
    parity = _parity()

    arrays, meta = upload_segment(seg, dev)
    d_pad = meta.d_pad
    comp = Compiler(mapper, ShardStats([seg]))
    fams = {m: parity.bench_agg_bodies(m, bsz)
            for m in ("agg_terms", "date_hist")}

    def eligible(bodies):
        plans = [comp.compile(dsl.parse_query(b["query"]), seg, meta)
                 for b in bodies]
        nodes, _ms = stacked_inputs(torch, plans, [-np.inf] * bsz, dev)
        _scores, m = _eval_plan(plans[0], arrays, nodes, [0], bsz)
        return (m & arrays["live"] & arrays["root"]).contiguous()
    elig = {m: eligible(b) for m, b in fams.items()}
    views, tag, ts = (arrays["numeric"]["views"], arrays["ordinal"]["tag"],
                      arrays["numeric"]["ts"])
    n = views["doc_ids"].shape[0]
    results = {}

    def record(name, shape, kern, plain, library, nbytes, check):
        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        if not all(_same_bits(torch, g, a) for g, a in zip(got, again)):
            raise AssertionError(f"{name} {shape}: two runs differ")
        err = check(got, want)
        rec = {"shape": shape, "max_abs_err": err,
               "ms": graph_ms(torch, kern), "call_ms": cuda_ms(torch, kern),
               "plain_ms": cuda_ms(torch, plain, reps=5),
               "library_ms": None if library is None
               else graph_ms(torch, library),
               "bound_ms": _bytes_bound(nbytes), "bound_by": "bytes"}
        results.setdefault(name, []).append(rec)
        log(name, json.dumps(rec))

    def exact(got, want):
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError("kernel and plain version differ")
        return 0.0

    # K4: the agg_terms family's range on views, identity and pairs
    # layouts, then a rank-mask (terms) filter
    plans = [comp.compile(dsl.parse_query({"range": {"views": {
        "gte": b["query"]["bool"]["filter"][0]["range"]["views"]["gte"]}}}),
        seg, meta) for b in fams["agg_terms"]]
    nodes, _ms = stacked_inputs(torch, plans, [-np.inf] * bsz, dev)
    lo, hi = nodes[0]["lo"], nodes[0]["hi"]
    up = arrays["numeric"]["views"]["unique_f32"].shape[0]
    ord_mask = torch.from_numpy(
        np.random.default_rng(1).random((bsz, up)) < 0.01).to(dev)
    for ident in (True, False):
        record("pairs_match", f"B={bsz} NVp={n} Dp={d_pad} range "
               f"{'identity' if ident else 'pairs'}",
               lambda ident=ident: (bm25.pairs_match(
                   views["doc_ids"], views["val_ords"], d_pad, ident,
                   lo=lo, hi=hi),),
               lambda ident=ident: (bm25.pairs_match_plain(
                   views["doc_ids"], views["val_ords"], d_pad, ident,
                   lo=lo, hi=hi),),
               None, 8 * n + bsz * d_pad + 8 * bsz, exact)
    record("pairs_match", f"B={bsz} NVp={n} Dp={d_pad} rank mask Up={up}",
           lambda: (bm25.pairs_match(views["doc_ids"], views["val_ords"],
                                     d_pad, True, ord_mask=ord_mask),),
           lambda: (bm25.pairs_match_plain(views["doc_ids"],
                                           views["val_ords"], d_pad, True,
                                           ord_mask=ord_mask),),
           None, 8 * n + bsz * d_pad + bsz * up, exact)

    # K5: the fused presence_bits of the date_hist family's cardinality,
    # and the popcount route of the agg_terms family's bucket counts
    hist_aggs = parse_aggs(fams["date_hist"][0]["aggs"])
    hist_plans = engine.compile_aggs(hist_aggs, mapper, seg, meta, comp)
    kinds = {p.name: p.kind for p in hist_plans}
    log(f"date_hist compiles to {json.dumps(kinds)} at NVp={n}")
    # the root date_histogram (~91 bins x NVp lanes) is fused only while
    # its bitmasks fit AGG_POPCOUNT_MAX_ELEMS; at scale it is bucket_num
    if kinds["uniq"] != "presence_bits" or (
            n >= 1 << 24 and kinds["per_day"] != "bucket_num"):
        raise AssertionError(f"date_hist compiled to {kinds}")
    card_plan = hist_plans[1]
    card = card_plan.static[1]
    bits = torch.from_numpy(
        card_plan.const_inputs["binbits"].view(np.int32)).to(dev)
    tag_bins = engine._Bins(torch.where(tag["doc_ids"] >= 0, tag["ords"],
                                        card), card)
    lanes = tag_bins.lanes.long()
    for label, mask, bbits in (("presence_bits", elig["date_hist"], bits),
                               ("popcount route", elig["agg_terms"],
                                tag_bins.bits())):
        ok = mask[:, :n].to(torch.int32)
        record("binned_popcount", f"B={bsz} n={n} bins={card} {label}",
               lambda mask=mask, bbits=bbits: (binned.binned_popcount(
                   mask, None, None, n, bbits, card),),
               lambda mask=mask, bbits=bbits: (binned.binned_popcount_plain(
                   mask, None, None, n, bbits, card),),
               lambda ok=ok: torch.zeros(bsz, card + 1, dtype=torch.int32,
                                         device=dev).scatter_add_(
                   1, lanes.expand(bsz, -1), ok),
               bsz * d_pad + card * n // 8 + 4 * bsz * card, exact)

    # K6: the avg views sums under terms tag (16 bins), the date_histogram
    # counts (scatter route), the static child-bin max (one bin per doc)
    route = {"sum": engine.binned_route(n, card, "sum"),
             "hist_cnt": engine.binned_route(
                 n, hist_plans[0].static[1], "cnt"),
             "terms_cnt": engine.binned_route(n, card, "cnt")}
    log(f"agg routes at n={n}: {json.dumps(route)}")
    if n >= 1 << 24 and route != {"sum": "scatter", "hist_cnt": "scatter",
                                  "terms_cnt": "popcount"}:
        raise AssertionError(f"unexpected reduction routes {route}")
    csr = tag_bins.csr()
    vals = views["values_f32"]
    ok_f = elig["agg_terms"][:, :n]
    contrib = torch.where(ok_f, vals, 0.0)
    # (padding lanes sit in the extra bin `card`)
    exact_sum = torch.zeros(bsz, card + 1, dtype=torch.float64,
                            device=dev).index_add_(
        1, lanes, contrib.double())[:, :card]
    cnt = torch.zeros(bsz, card + 1, dtype=torch.float64,
                      device=dev).index_add_(1, lanes, ok_f.double())[:, :card]
    sum_bound = cnt * F32_SUM_EPS * exact_sum   # views >= 0: sum|v| = sum

    def within_bound(got, want):
        for side in (got[0], want[0]):
            err = (side.double() - exact_sum).abs()
            if not bool((err <= sum_bound).all()):
                raise AssertionError("f32 sums outside n * 2^-24 * sum|v|")
        return float((got[0] - want[0]).abs().max().item())
    record("binned_reduce", f"B={bsz} n={n} bins={card} sum (avg views "
           f"under terms tag)",
           lambda: (binned.binned_reduce(csr, elig["agg_terms"], None, None,
                                         vals, 0.0, ("sum",), bsz)["sum"],),
           lambda: (binned.binned_reduce_plain(
               csr, elig["agg_terms"], None, None, vals, 0.0, ("sum",),
               bsz)["sum"],),
           lambda: torch.zeros(bsz, card + 1, device=dev).index_add_(
               1, lanes, contrib),
           4 * n + 4 * n + bsz * d_pad + 4 * bsz * card, within_bound)
    # the bucket_num table of the date_histogram (the unfused compile)
    hist_plan = engine.compile_aggs(hist_aggs, mapper, seg, meta, comp,
                                    allow_fused=False)[0]
    htotal = hist_plan.static[1]
    table = torch.from_numpy(hist_plan.inputs["table"]).to(dev)
    hbins = engine._Bins(torch.where(ts["doc_ids"] >= 0,
                                     table[ts["val_ords"].long()], htotal),
                         htotal)
    hcsr = hbins.csr()
    hlanes = hbins.lanes.long()
    hok = elig["date_hist"][:, :n].to(torch.int32)
    record("binned_reduce", f"B={bsz} n={n} bins={hbins.total} cnt "
           f"(date_histogram, scatter route)",
           lambda: (binned.binned_reduce(hcsr, elig["date_hist"], None, None,
                                         None, 0.0, ("cnt",), bsz)["cnt"],),
           lambda: (binned.binned_reduce_plain(
               hcsr, elig["date_hist"], None, None, None, 0.0, ("cnt",),
               bsz)["cnt"],),
           lambda: torch.zeros(bsz, hbins.total + 1, dtype=torch.int32,
                               device=dev).scatter_add_(
               1, hlanes.expand(bsz, -1), hok),
           4 * n + bsz * d_pad + 4 * bsz * hbins.total, exact)
    per_doc = engine._Bins(torch.where(tag["doc_ids"] >= 0, tag["doc_ids"],
                                       -1), d_pad)
    pcsr = per_doc.csr()
    fl = tag_bins.lanes.to(torch.float32)
    pidx = torch.where(tag["doc_ids"] >= 0, tag["doc_ids"],
                       d_pad).long()[None, :]
    record("binned_reduce", f"B=1 n={n} bins={d_pad} max (static child "
           f"bins)",
           lambda: (binned.binned_reduce(pcsr, None, None, None, fl, 0.0,
                                         ("max",), 1)["max"],),
           lambda: (binned.binned_reduce_plain(pcsr, None, None, None, fl,
                                               0.0, ("max",), 1)["max"],),
           lambda: torch.full((1, d_pad + 1), float("-inf"),
                              device=dev).scatter_reduce_(
               1, pidx, fl[None, :], "amax"),
           4 * n + 4 * n + 4 * d_pad, exact)
    del arrays, elig
    torch.cuda.empty_cache()
    return results


def phase_scale(torch, np, mapper, seg, dev, out_dir=None):
    from opensearch_tpu_torch.search.executor import (SearchExecutor,
                                                      ShardReader,
                                                      _envelope_kernel)
    from opensearch_tpu_torch.search import dsl
    from opensearch_tpu_torch.search.compile import Compiler
    from opensearch_tpu_torch.utils.demo import fast_query_terms

    reader = ShardReader(mapper, dev, index_name="msmarco_synth")
    t0 = time.perf_counter()
    reader.add_segment(seg)
    torch.cuda.synchronize()
    log(f"scale: image of {seg.num_docs} docs uploaded in "
        f"{time.perf_counter() - t0:.3f} s: {reader.device_bytes()} bytes "
        f"(Dp={reader.device[0][1].d_pad}, NBp={reader.device[0][1].nb_pad})")
    ex = SearchExecutor(reader)
    terms = sorted(t for _, t in seg.term_dict)
    texts = []
    for n in (2, 3, 4):
        texts += fast_query_terms(200, terms, seed=500 + n,
                                  terms_per_query=n)
    rng = np.random.default_rng(0)
    rng.shuffle(texts)
    bodies = [{"query": {"match": {"body": t}}} for t in texts]
    stats, segs, device = reader.stats_snapshot()
    comp = Compiler(mapper, stats)
    mix = {}
    for b in bodies:
        kind = _envelope_kernel(comp.compile(dsl.parse_query(b["query"]),
                                             segs[0], device[0][1]))
        mix[kind] = mix.get(kind, 0) + 1
    log(f"scale: kernel class mix over {len(bodies)} queries: "
        f"{json.dumps(mix)}")
    if set(mix) != {"candidate", "dense"}:
        raise AssertionError(f"scale queries must take both kernel classes, "
                             f"got {mix}")
    from opensearch_tpu_torch.ops import _build
    for b in bodies[:10]:
        ex.search(b)
    torch.cuda.synchronize()
    _build.reset_launches()
    single = []
    for b in bodies[:300]:
        t = time.perf_counter()
        ex.search(b)
        single.append((time.perf_counter() - t) * 1e3)
    batches = []
    for i in range(0, 32 * 18, 32):
        t = time.perf_counter()
        ex.multi_search(bodies[i:i + 32])
        batches.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    log(f"scale: launches {json.dumps(launches)}")
    _require_launched(launches, ("bm25_candidate", "score_text_clause",
                                 "masked_topk"), "BM25 scale")

    def pct(xs, p):
        return float(np.percentile(np.asarray(xs), p))
    log(f"scale: B=1 _search wall ms p50 {pct(single, 50):.3f} "
        f"p99 {pct(single, 99):.3f} over {len(single)}; "
        f"B=32 _msearch wall ms p50 {pct(batches, 50):.3f} "
        f"p99 {pct(batches, 99):.3f} over {len(batches)} batches "
        f"({32 * 1e3 / pct(batches, 50):.1f} queries/s at p50)")
    busy = profile_waves(torch, ex, bodies, out_dir, "msearch32")
    # sample pages against the plain versions (the same reader on the CPU)
    cpu_reader = ShardReader(mapper, "cpu", index_name="msmarco_synth")
    cpu_reader.add_segment(seg)
    cpu_ex = SearchExecutor(cpu_reader)
    parity = _parity()
    sample = bodies[:6]
    for b in sample:
        parity.assert_same_response(ex.search(b), cpu_ex.search(b), "scale")
    parity.assert_same_response(ex.multi_search(bodies[:32]),
                                cpu_ex.multi_search(bodies[:32]), "scale32")
    log(f"scale: {len(sample) + 32} sampled pages equal the plain versions'")
    return {"image_bytes": reader.device_bytes(),
            "search_p50_ms": pct(single, 50), "search_p99_ms": pct(single, 99),
            "msearch32_p50_ms": pct(batches, 50),
            "msearch32_p99_ms": pct(batches, 99), **busy}


def agg_oracle(np, n_docs: int):
    """The f64 numpy oracle of the aggregation scale cell (bench.py's
    base_one, extended to the whole response): the same columns the
    segment was built from, answered with bincount and unique."""
    import datetime as dt
    from opensearch_tpu_torch.utils.demo import N_TAGS, structured_columns
    tag, views, ts = structured_columns(n_docs, seed=42)
    names = np.array([f"cat{i}" for i in range(N_TAGS)])
    day = 86400_000

    def fmt(ms):
        return dt.datetime.fromtimestamp(ms / 1000, tz=dt.timezone.utc) \
            .strftime("%Y-%m-%dT%H:%M:%S.") + f"{ms % 1000:03d}Z"

    def check(body, resp, what):
        """Exact counts, keys and order; avg within the f32-sum bound."""
        q = body["query"]
        if "bool" in q:
            mask = views >= q["bool"]["filter"][0]["range"]["views"]["gte"]
        else:
            mask = ts < q["range"]["ts"]["lt"]
        if resp["hits"]["total"]["value"] != int(mask.sum()):
            raise AssertionError(f"{what}: hits.total differs")
        aggs = resp["aggregations"]
        if "by_tag" in aggs:
            counts = np.bincount(tag[mask], minlength=N_TAGS)
            sums = np.bincount(tag[mask], weights=views[mask].astype(
                np.float64), minlength=N_TAGS)
            order = sorted((i for i in range(N_TAGS) if counts[i] > 0),
                           key=lambda i: (-counts[i], names[i]))[:20]
            got = aggs["by_tag"]["buckets"]
            if [(b["key"], b["doc_count"]) for b in got] != \
                    [(names[i], int(counts[i])) for i in order]:
                raise AssertionError(f"{what}: terms buckets differ")
            for b, i in zip(got, order):
                bound = counts[i] * F32_SUM_EPS * sums[i]
                err = abs(b["avg_v"]["value"] * counts[i] - sums[i])
                if err > bound:
                    raise AssertionError(
                        f"{what}: avg of {names[i]} off by {err} > {bound}")
            return
        keys, counts = np.unique(ts[mask] // day, return_counts=True)
        want = dict(zip((keys * day).tolist(), counts.tolist()))
        span = range(int(keys[0]), int(keys[-1]) + 1) if len(keys) else []
        exp = [{"key": k * day, "doc_count": want.get(k * day, 0),
                "key_as_string": fmt(k * day)} for k in span]
        if aggs["per_day"]["buckets"] != exp:
            raise AssertionError(f"{what}: date_histogram buckets differ")
        if aggs["uniq"]["value"] != len(np.unique(tag[mask])):
            raise AssertionError(f"{what}: cardinality differs")
    return check


def phase_agg_scale(torch, np, mapper, seg, dev, out_dir=None,
                    per_family: int = AGG_BODIES_PER_FAMILY,
                    bsz: int = AGG_BATCH):
    """One shard of the structured corpus served with bench.py's agg
    families: B=1 `_search` and B=32 `_msearch` latency, queries/s, image
    bytes, busy share; responses against the f64 oracle and the plain
    versions."""
    from opensearch_tpu_torch.ops import _build
    from opensearch_tpu_torch.search.executor import (SearchExecutor,
                                                      ShardReader)
    parity = _parity()

    reader = ShardReader(mapper, dev, index_name="http_logs_synth")
    t0 = time.perf_counter()
    reader.add_segment(seg)
    torch.cuda.synchronize()
    log(f"agg scale: image of {seg.num_docs} docs uploaded in "
        f"{time.perf_counter() - t0:.3f} s: {reader.device_bytes()} bytes "
        f"(Dp={reader.device[0][1].d_pad})")
    ex = SearchExecutor(reader)
    fams = {m: parity.bench_agg_bodies(m, per_family)
            for m in ("agg_terms", "date_hist")}
    for m, bodies in fams.items():   # warm: plans, static sides
        ex.search(bodies[0])
        ex.multi_search(bodies[:bsz])
    torch.cuda.synchronize()
    _build.reset_launches()
    out = {"image_bytes": reader.device_bytes()}
    answers = {}
    for m, bodies in fams.items():
        single = []
        for b in bodies:
            t = time.perf_counter()
            answers[(m, len(single))] = ex.search(b)
            single.append((time.perf_counter() - t) * 1e3)
        batches = []
        for i in range(6):
            lo = (i * bsz) % len(bodies)
            t = time.perf_counter()
            resp = ex.multi_search(bodies[lo:lo + bsz])
            batches.append((time.perf_counter() - t) * 1e3)
            if i == 0:
                answers[(m, "msearch")] = resp

        def pct(xs, p):
            return float(np.percentile(np.asarray(xs), p))
        rec = {"search_p50_ms": pct(single, 50),
               "search_p99_ms": pct(single, 99),
               "msearch32_p50_ms": pct(batches, 50),
               "msearch32_p99_ms": pct(batches, 99),
               "msearch32_qps": bsz * 1e3 / pct(batches, 50)}
        log(f"agg scale {m}: B=1 _search wall ms p50 "
            f"{rec['search_p50_ms']:.3f} p99 {rec['search_p99_ms']:.3f} "
            f"over {len(single)}; B={bsz} _msearch wall ms p50 "
            f"{rec['msearch32_p50_ms']:.3f} p99 "
            f"{rec['msearch32_p99_ms']:.3f} over {len(batches)} batches "
            f"({rec['msearch32_qps']:.1f} queries/s at p50)")
        out[m] = rec
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    log(f"agg scale: launches {json.dumps(launches)}")
    _require_launched(launches, ("masked_topk", "pairs_match",
                                 "binned_popcount", "binned_reduce"),
                      "aggregation scale")
    out["launches"] = launches
    for m, bodies in fams.items():
        waves = [bodies[(i * bsz) % len(bodies):][:bsz] for i in range(6)]
        out[m].update(profile_waves(torch, ex, [b for w in waves for b in w],
                                    out_dir, m))
    # responses against the f64 oracle: 8 _search answers and the first
    # B=32 _msearch of each family
    check = agg_oracle(np, seg.num_docs)
    n_checked = 0
    for m, bodies in fams.items():
        for j in range(0, len(bodies), max(len(bodies) // 8, 1)):
            check(bodies[j], answers[(m, j)], f"{m}[{j}]")
            n_checked += 1
        for j, resp in enumerate(answers[(m, "msearch")]["responses"]):
            check(bodies[j], resp, f"{m} msearch[{j}]")
            n_checked += 1
    log(f"agg scale: {n_checked} responses match the f64 oracle")
    # one body of each family against the plain versions on the CPU; the
    # avg of a bucket may differ by twice the f32-sum bound
    cpu_reader = ShardReader(mapper, "cpu", index_name="http_logs_synth")
    cpu_reader.add_segment(seg)
    cpu_ex = SearchExecutor(cpu_reader)
    for m, bodies in fams.items():
        body = bodies[1]
        got, want = answers[(m, 1)], cpu_ex.search(body)
        tol = {}
        for j, b in enumerate(want["aggregations"].get("by_tag", {}).get(
                "buckets", [])):
            tol[f"{m}.aggregations.by_tag.buckets[{j}].avg_v.value"] = \
                2 * F32_SUM_EPS * b["doc_count"] * b["avg_v"]["value"]
        parity.assert_same_response(got, want, m, agg_sum_tol=tol)
    log("agg scale: one response per family equals the plain versions'")
    del cpu_reader, cpu_ex
    return out


def _require_launched(launches, names, what: str) -> None:
    missing = [k for k in names if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {what} path: "
                             f"{missing}")


def profile_waves(torch, ex, bodies, out_dir, name: str, waves: int = 6):
    """Device busy share of B=32 _msearch waves: kernel time summed from a
    torch.profiler (CUPTI) trace over the wall time of the traced waves.
    Writes the per-kernel table to <out_dir>/profile_<name>.txt when an
    output directory was given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(waves):
            ex.multi_search(bodies[32 * i:32 * (i + 1)])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = float(getattr(evt, "self_device_time_total", 0.0) or 0.0)
        per_kernel[evt.key] = per_kernel.get(evt.key, 0.0) + us
    device_ms = sum(per_kernel.values()) / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    if out_dir is not None:
        with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
            f.write(f"{waves} B=32 waves, wall {wall_ms:.3f} ms, device "
                    f"kernel time {device_ms:.3f} ms\n")
            for key, us in top:
                f.write(f"{us / 1e3:10.3f} ms  {key}\n")
    if device_ms == 0.0:
        log("profile: the trace holds no device time: busy share not "
            "measured")
        return {f"{name}_device_busy": None}
    log(f"profile {name}: {waves} B=32 waves: wall {wall_ms:.3f} ms, device "
        f"kernels {device_ms:.3f} ms, busy share {device_ms / wall_ms:.3f}; "
        f"top: " + "; ".join(f"{k[:48]} {us / 1e3:.3f} ms"
                             for k, us in top[:5]))
    return {f"{name}_device_busy": device_ms / wall_ms}


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None,
                        help="directory for the long outputs (nvcc's ptxas "
                             "report, the profiler's kernel table)")
    out_dir = parser.parse_args(argv).out
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "opensearch_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(opensearch_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from opensearch_tpu_torch.ops import _build
    from opensearch_tpu_torch.ops.device_segment import upload_segment
    from opensearch_tpu_torch.utils.demo import build_shards_fast

    t_all = time.perf_counter()
    # phase 1: build and card
    took = _build.build_all()
    log("build: " + json.dumps({k: round(v, 3) for k, v in took.items()})
        + " s (parallel nvcc, one library per source)")
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "nvcc_log.txt"), "w") as f:
            for name, text in _build.BUILD_LOG.items():
                f.write(f"--- {name}\n{text}\n")
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    mapper, segs, _terms = build_shards_fast(
        SCALE_DOCS, 1, vocab_size=20000, avg_len=60, seed=42,
        materialize_terms=SCALE_MATERIALIZE_TERMS)
    seg = segs[0]
    log(f"corpus: {seg.num_docs} passages, {len(seg.term_dict)} "
        f"materialized terms, {seg.post_docs.shape[0]} posting blocks, "
        f"built in {time.perf_counter() - t0:.3f} s")
    arrays, meta = upload_segment(seg, dev)
    agg_mapper, agg_seg = agg_segment(np, AGG_SCALE_DOCS)

    # phase 2: kernels against their plain versions on the card
    results = phase_kernels(torch, np, seg, mapper, arrays, meta, dev)
    del arrays
    results.update(phase_agg_kernels(torch, np, agg_mapper, agg_seg, dev))
    # phase 3: the main path, serving on the card
    launches = phase_serving(torch, np)
    # phase 4: BM25 scale
    scale = phase_scale(torch, np, mapper, seg, dev, out_dir)
    log("scale: " + json.dumps(scale))
    # phase 5: aggregation scale
    agg_scale = phase_agg_scale(torch, np, agg_mapper, agg_seg, dev,
                                out_dir)
    log("agg scale: " + json.dumps(agg_scale))

    # one representative shape per kernel for the kernels line: the B=32
    # main-path batch (K1 at 4 terms / 16,384 lanes, K3 at k=100; K4 the
    # identity range, K5 the fused cardinality, K6 the avg sums)
    pick = {"bm25_candidate": 4, "score_text_clause": 1, "masked_topk": 4,
            "pairs_match": 0, "binned_popcount": 0, "binned_reduce": 0}
    meta_of = {
        "bm25_candidate": ("opensearch_tpu_torch/ops/csrc/bm25_candidate.cu",
                           "opensearch_tpu/search/executor.py:1325"),
        "score_text_clause": (
            "opensearch_tpu_torch/ops/csrc/score_text_clause.cu",
            "opensearch_tpu/ops/bm25.py:135"),
        "masked_topk": ("opensearch_tpu_torch/ops/csrc/masked_topk.cu",
                        "opensearch_tpu/search/executor.py:1453"),
        "pairs_match": ("opensearch_tpu_torch/ops/csrc/pairs_match.cu",
                        "opensearch_tpu/ops/bm25.py:187"),
        "binned_popcount": (
            "opensearch_tpu_torch/ops/csrc/binned_popcount.cu",
            "opensearch_tpu/search/aggs/engine.py:1108"),
        "binned_reduce": ("opensearch_tpu_torch/ops/csrc/binned_reduce.cu",
                          "opensearch_tpu/search/aggs/engine.py:1146"),
    }
    kernels = []
    for name in _build.KERNELS:
        rec = results[name][pick[name]]
        src, replaces = meta_of[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": max(r["max_abs_err"]
                                           for r in results[name]),
                        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"],
                        "library_ms": rec["library_ms"],
                        "call_ms": rec["call_ms"], "shape": rec["shape"]})
    log(f"total wall {time.perf_counter() - t_all:.3f} s; card: {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
