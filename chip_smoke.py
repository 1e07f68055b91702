#!/usr/bin/env python3
"""Smoke test of opensearch_tpu_torch on one NVIDIA GPU.

Run from the repository root, with no arguments, on a machine with one CUDA
card:  python3 chip_smoke.py

Phases, each printing what it finds; any failure exits nonzero:
 1. build the CUDA kernels from opensearch_tpu_torch/ops/csrc (in
    parallel), print the build times and the card's name and power limit;
    make the 1M-passage corpus of the BM25 scale phase, the 10M-doc
    structured segment of the aggregation scale phase and the two k-NN
    corpora (set-up);
 2. run every kernel on the card at its main path's shapes and hold it
    against its plain PyTorch version on the same inputs (the k-NN kernels
    as below): K1
    bm25_candidate, K2 score_text_clause (ids, hits and totals exactly,
    scores within SCORE_ATOL: both sides round every BM25 operation once,
    the kernels build with --fmad=false; K2 bit for bit, also on two runs,
    with its scratch bytes), K3 masked_topk at Dp = 2^20 and
    B = 1 and 32 (bit for bit, k 10, 100 and 1,000); K4
    pairs_match, K5 binned_popcount, K6 binned_reduce at B=32 and
    NVp = Dp = 2^24 (masks, counts, min and max exactly, f32 sums within
    n * 2^-24 * sum|v| of the f64 sums, and the same bits on two runs; K5
    also at phase 3's 8,192 lanes and on the gathered layout of the tag
    pairs with a parent mask);
    time the kernel (device time, CUDA-graph replay), one wrapper call
    (host checks and launch included), the plain version and the library
    call (CUDA events, median, L2 flushed);
 3. serve on the card through Node().request: a 5,000-passage BM25 index
    and a 5,000-doc structured index (`docs`: tag / views / ts, two
    segments, deletes, multi-valued tags, docs without views), the parity
    bodies and the aggregation bodies through `_search` and a B=32
    `_msearch` each; every response must equal Node(device="cpu")'s (the
    plain versions), and every kernel K1-K9 must have launched during this
    run;
 4. BM25 scale: one shard of 1,000,000 passages from build_shards_fast
    served through SearchExecutor at B=1 and B=32, sample pages checked
    against the plain versions, image bytes and p50/p99 wall times;
 5. aggregation scale: one shard of 10,000,000 structured docs served with
    bench.py's agg_terms and date_hist body families at B=1 and B=32:
    p50/p99 wall times, queries/s, image bytes and the profiler's busy
    share; sampled responses checked against an f64 numpy oracle and
    against the plain versions;
 6. k-NN exact cell: the SIFT-shaped clustered corpus (1,000,000 x 128,
    l2) in one segment, 640 queries at k=10 through SearchExecutor at B=1
    and B=32: walls, queries/s, image bytes, busy share, recall@10 against
    an f64 numpy brute force (f32 ties listed);
 7. k-NN IVF cell: the GloVe-shaped clustered corpus (1,183,514 x 100,
    cosinesimil), its IVF (nlist 256) sealed on the card by K9 and timed,
    served at nprobes 32 like phase 6, recall@10 against the exact
    kernel's pages (>= 0.9);
 8. MaxSim cell: 100,000 ColBERTv2-shaped passages (128-d unit tokens,
    32-128 per passage, capped at 128) as a `rank_vectors` field, 640
    queries of 32 tokens at k=10 through SearchExecutor at B=1 and B=32:
    walls, queries/s, image bytes, busy share, recall@10 against an f64
    oracle (f64 matmuls over doc chunks on the card; f32 ties listed),
    two pages against the plain versions;
 9. hybrid cell: phase 4's 1,000,000 passages plus a 768-d l2 embedding
    each, `hybrid` bodies of a match (2-4 terms) and a knn (k 100) through
    Node().request: B=1 `_search` under a normalization-processor pipeline
    (min_max, arithmetic_mean, weights [0.3, 0.7]) and B=32 `_msearch`
    (the batched hybrid wave, default spec); walls, queries/s, busy share,
    image bytes, two pages against the plain versions;
10. sorted cell: phase 5's 10,000,000 structured docs as one index and,
    the same docs split in doc order, as a four-segment index (and on a
    `search.result_page.enabled` node), through Node().request: the rally
    tracks' field-sorted bodies (http_logs desc / asc_sort_timestamp,
    desc_sort_with_after_timestamp at the 20,000th hit, a nyc_taxis-shaped
    range filter sorted on views, a keyword multi-key sort with
    docvalue_fields and track_total_hits) at B=1 (p50 / p99, the host
    split into query phase, reduce and fetch), then B=32 `_msearch` of
    sorted bodies; busy share; pages against an f64 numpy oracle, the
    one-segment pages against the four-segment ones, and the result-page
    node's against the gate-off node's;
11. agg-kinds cell: 10,000,000 nyc_taxis-shaped docs
    (utils/demo.taxi_segment: tag / views / ts plus `fare` in cents, ~2%
    of docs without one, and `passengers`) as one index's one segment,
    through Node().request: eleven body families of 64 bodies over
    distinct ts spans (big5's range-agg-1, composite-terms /
    composite-date_histogram-daily with `after`, multi_terms-keyword,
    range-auto-date-histo-with-metrics; nyc_taxis' autohisto_agg;
    percentiles, weighted_avg, matrix_stats, adjacency_matrix, filters +
    missing + global, a date_histogram with derivative and max_bucket) at
    B=1 and B=32: walls, queries/s, the first query's wall, busy share,
    image bytes; every B=1 answer a 200 with aggregations; sampled
    responses against an f64 numpy oracle at the full 10M (counts exact,
    percentiles exact from the counts, each f32 sum within the additions
    on a term's path in its kernel times 2^-24 * sum|term|, and every
    avg, weighted_avg and matrix_stats value within that error carried
    through its formula) and, on a 1M-doc shard, against
    Node(device="cpu");
12. relevance cell: phase 4's 1,000,000 passages plus two doc-value
    columns made from the seed (`likes`, a long: lognormal, median 40,
    capped at 10^6, 5% of docs without one; `published`, a date uniform
    over 2019-2024), through Node().request: six families of 64 bodies
    after the OpenSearch documentation's function_score / script_score
    examples (field_value_factor log1p, gauss on a date, three functions
    with sum / sum / max_boost / min_score, script_score with
    Math.log(2 + likes), distance_feature in a should, boosting) over
    2-4 term texts: B=1 p50 / p99, B=32 p50 / p99 and q/s, busy share;
    every timed answer a 200; 16 sampled bodies a family on a
    100,000-passage cut with the same columns against
    Node(device="cpu")'s pages (scores to rtol 2e-6, atol 1e-7).

Phase 2 also holds K18 function_score (three functions: fvf log1p, gauss
on a date, a filtered weight) and K19's four entries (terms_set of three
terms, distance_feature on the date, boosting, script_score's wrap) at
phase 12's shapes (B=32, Dp 2^20) against their plain versions, bit for
bit (0 ulps, NaN at the same places). Phase 3 adds a 600-doc scoring
index (`rel`: text with the standard and the english analyzers, keyword,
long, date, double, integer; two segments, deletes) served with every
function_score kind and mode, script_score, boosting, terms_set,
distance_feature, constant_score, ids, prefix / wildcard / regexp /
fuzzy, match fuzziness, phrases, multi_match's four types, query_string
and simple_query_string, and a `relc` index whose analyzers come from
`settings.analysis`, through `_search` and two `_msearch`.

Phase 2 also holds K15 dense_numeric (the fare and views columns into
Dp 2^24), K16 matrix_moments (fare and views at B=32, at the root, under
terms tag, under a daily date_histogram and under terms fare, each with
both folds of its second pass timed) and K17 adjacency_counts (four doc-value filters at
B=32) at phase 11's shapes against their plain versions (K15 and K17 bit
for bit; K16's counts exactly, the same bits on two runs, its sums and
its plain version's each within the additions on a term's path times
2^-24 * sum|term| of the f64 sums of their f32 terms). Phase 3 adds a
3,000-doc nyc_taxis-shaped index (`taxi`, three segments, deletes)
served with every remaining agg kind at the root, under terms and under
date_histogram, a 33-filter adjacency_matrix (past one K17 launch), and
every pipeline type, through `_search` and a B=32 `_msearch`.

Phase 2 also holds K7 knn_exact (and its top-k mark) at B=32 x 2^20 x 128
in the three spaces, at B=1 and 8 in l2 and at B=32 x 2^20 x 768 (random
rows) in l2, with each shape's contract floor (2 B Dp dims FP32
instructions at the card's top SM clock) beside its bound, and K8
ivf_probe (with its block ranking launch) and K9 kmeans_step at phase 7's
shapes, on the whole GloVe-shaped corpus,
against their plain versions bit for bit (K7 and K8 at B=32; K9 in each
of the seal's 10 steps, whose means also lie within n * 2^-24 * sum|x|
of the f64 means), and phase 7 seals those very centroids again. Phase 3 adds a
5,000-vector index with exact, IVF, filtered and bool k-NN bodies; its
launch window opens before the indices load, since sealing the IVF lists
runs K9.

Phase 2 also holds K10 maxsim_exact and K11 (pq_lut and maxsim_pq) at
phase 8's shapes (bit for bit on the first 16,384 docs at B=4 and on the
whole corpus at B=1; timed at B=1 and B=32; K11's codes uniform random u8
[Dp, 128, 32] against a codebook trained by the port's train_pq on a
20,000-token sample of the corpus; K11's scorer records carry its lookup
floor, one 4-byte shared-memory read per (doc token, query token,
sub-space) at 32 a cycle on each SM), K12 hybrid_window at B=32, two
sub-queries, Dp 2^20, k 10, and K3's masked_topk_threshold at B=32, Dp
2^20, k 20,000. Phase 3 adds a token index (exact and PQ fields), a
hybrid index with its pipeline and a 24,000-vector index (a knn at k
20,000) to the served pages.

Phase 2 also holds K13 sort_key over the 10M-doc structured segment (ts,
views, tag; both orders), K3's keyed entry masked_topk_keyed at B=1, Dp
2^24, k 10, 10,128 and 41,088 (past one CTA's sort), and K14 page_merge
over four 2.5M-doc segments' winners, each bit for bit against its plain
version. Phase 3 adds a three-segment structured index served with field
sorts, search_after pages and the fetch subphases (highlight, explain,
docvalue_fields, version) on a gate-off node and on a result-page node.

Phase 2 also holds K20 blockmax_keep with K1's and K2's keep entries at
B=32 on phase 4's 2-4-term queries and on one-term queries over the same
passages, where lanes are pruned (k 10), K21's row_merge at R = 5, 8 and
4 rows (k 10, 1,000, 40,960, 65,536; and uneven rows with +-0.0 keys)
and its row_value_key over the 10M-doc `views` column, each bit for bit
against its plain version. Phase 3 adds
a 3-shard index and four daily indices behind `logs-*` (the multi-shard
program, the host loop with can-match, DFS, `_msearch`) and, on a
`search.blockmax.enabled` node pair, the zipf corpus on one and two
shards (block-max on the envelope and on the program).
13. sharded cell: phase 4's passages built as 5 shards
    (build_shards_fast(n_shards=5)) in one index, 600 `match` bodies of
    2-4 terms at B=1 (the multi-shard program: 5 rows, K21) and B=32
    `_msearch`, block-max off and on (a second Node): p50 / p99, q/s,
    busy share, image bytes, the share of pruned lanes; block-max pages
    equal the gate-off pages and 64 program pages equal the card's own
    host loop's; 64 `dfs_query_then_fetch` bodies on the 5 shards, each
    page equal to one shard holding the five segments (p50 / p99);
    block-max on phase 4's one-shard envelope (pages equal); phase 10's
    four 2.5M-doc segments as four indices behind `logs-*` against the
    same docs as one index and the f64 oracle; a 100,000-passage 5-shard
    cut against Node(device="cpu"), dfs pages included.
14. nested cell: 2,000,000 StackOverflow-shaped questions with nested
    answers (rally-tracks' nested track, cut from ~11M to one segment of
    Dp 2^23; answers.user a long id, not the track's keyword;
    utils/demo.qa_segment), through Node().request: eight families of 64
    bodies (nested bool{term answers.user, range answers.date} in score
    modes avg / sum / max / min / none, avg with inner_hits of 3, size 0
    nested -> terms answers.user, nested -> monthly date_histogram ->
    reverse_nested -> terms tag): B=1 p50 / p99, B=32 p50 and q/s, busy
    share, the inner hits' copies; terms counts against numpy; a
    20,000-question cut against Node(device="cpu");
15. geo cell: 10,000,000 GeoNames-shaped places around 5,000 city
    centres (rally-tracks' geonames; population mapped as rank_feature,
    not the track's long; utils/demo.geonames_segment), through
    Node().request: seven families of 64 bodies (geo_bounding_box,
    geo_distance 50 km, bool{filter geo_distance 200 km, should
    rank_feature saturation}, distance_feature pivot 10 km filtered by a
    country_code term, size 0 terms country_code -> geo_bounds +
    geo_centroid, geohash_grid precision 5 and geotile_grid zoom 8 over a
    map viewport): walls as phase 14 and the first query's; bbox totals
    against numpy; the grid keys' numpy form against the scalar functions
    on a seeded 100,000-place sample; a 200,000-place cut against
    Node(device="cpu").
16. ingest cell: rally-tracks' http_logs lines (`@timestamp`, `clientip`
    as a keyword, `request`, `status`, `size`; utils/demo.http_logs_docs)
    written through Node().request: 200,000 through `_bulk` in requests of
    5,000 with a refresh after every fourth (ten segments of 20,000 docs,
    Dp 32,768) on an `indices.publish.delta: true` node and on a gate-off
    twin, then 2,000 `_update` partial docs on random ids guarded by
    `if_seq_no` (200 stale: each a 409), 2,000 deletes and a refresh, 32
    single-doc writes with ?refresh=true (one-doc segments, the ones whose
    leaves the delta publish compacts and expand_pad expands) and
    `_forcemerge` to one segment. Every published image equals
    upload_segment's leaf by leaf; `_count`, a range `_count`, a terms agg
    on status and GET of 200 ids (realtime before a refresh, and after)
    equal a host model of the live docs. Prints `_bulk` docs/s and p50,
    refresh p50 / p99 split into seal and publish, the publish's bytes and
    ms gate on and off on one segment (20,000 docs and one doc), live-mask
    bytes a refresh in both states, B=1 `_search` p50 / p99 over ten
    segments and over one, the first search after a refresh, the
    force-merge wall, GET and `_update` p50; expand_pad's launches on this
    path go into the kernels line.

Phase 2 also holds row 16's expand_pad against its plain version bit for
bit on every leaf a 40-doc ingest segment compacts (ragged and bucketed
prefixes), on phase 5's 10M-doc image (Dp 2^24: live, views' min_rank /
exists / values, tag's doc ids), phase 6's vectors (1M x 128 into
[2^20, 128]) and phase 8's PQ codes (u8 [100,000, 128, 32] into
[131,072, 128, 32]), timed beside its bound and F.pad. Those leaves take
its 16-byte vector path (the codes and the vectors fold to one axis) or,
for the ragged small leaves, its element path.

Every phase from 3 on ends by requiring that every response was answered
by every shard: no shard's query or fetch failed (`_shards.failed` 0, the
controller's SHARD_FAILURES) and the multi-shard program never raised and
fell back to the per-shard host loop (spmd.HOST_FALLBACKS); else the
phase fails.

Phase 2 also holds K22 nested_join (sum, avg, max), K23 nested_aggs
(nested under the root, reverse_nested under a monthly date_histogram,
also with the first 10,000 nested rows moved under one root) at phase
14's shapes (B=32, Dp 2^23) and K24 binned_scatter
(geo_centroid's sums and geo_bounds' extrema under terms country_code)
and K25's four geo / rank_feature entries at phase 15's (B=32, Dp
2^24), each against its plain version (K22, K24 and K25 bit for bit,
K23 exactly, K24's sums also within n * 2^-24 * sum|v| of the f64 sums).
Phase 3 adds the Q&A index (`qa`: nested answers, two segments,
re-indexed and deleted blocks) with every score mode, inner hits and the
aggregations under nested / reverse_nested, and the places index (`geo`)
with the geo and rank_feature queries and the geo aggregations.

`--cells a,b` runs only the named cells after the build (scale, knn,
maxsim, hybrid, sorted, aggkinds, relevance, sharded, nested, geo,
ingest: phases 4, 6's exact cell, 8, 9, 10, 11, 12, 13, 14, 15, 16;
aggs: phase 5; topk: phase 2's records of K3, its threshold and its keyed
entry on their own, each with the device ms of each launch of a call;
binned: phase 2's records of K5, K6, K23's reverse_nested and K24 on
their own, each with the device ms of each kernel of a call, K23's and
K24's with their scratch bytes; textpq: phase 2's records of K2 (B=1,
B=32 and its keep entry on the block-max batches, with its scratch
bytes) and of K11's scorer (the B=4 slice, B=1 and B=32, with its lookup
floor), each with the device ms of each kernel of a call), one JSON line
each, so that one card compares two checkouts cell by cell.

Each record of K3's three entries also prints `full_reads`: per row, the
passes of their radix select that read the whole input (2, unless a bin
held more keys than the candidate buffer), read from the scratch of one
more call after the timed replays.

`--out DIR` writes the long outputs (nvcc's ptxas report, the profiler's
per-kernel tables, a copy of the log) under DIR. The card's name and power limit are printed in
phase 1 and again on the third line from the end; the line before the last
is the `kernels` JSON; the last line is the result: {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SCORE_ATOL = 0.0          # kernels and plain versions round identically
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
LEAD_CYCLES = 20_000_000   # ~10 ms at 1.98 GHz: twice Python's GIL interval
F32_FLOPS = 67e12          # H100 SXM f32, outside the tensor cores
SCALE_DOCS = 1_000_000
SCALE_MATERIALIZE_TERMS = 4096
AGG_SCALE_DOCS = 10_000_000   # one shard of a 165M-doc nyc_taxis index
AGG_BATCH = 32
AGG_BODIES_PER_FAMILY = 64
F32_SUM_EPS = 2.0 ** -24
SIFT_SHAPE = (1_000_000, 128)      # ann-benchmarks sift-128-euclidean
GLOVE_SHAPE = (1_183_514, 100)     # ann-benchmarks glove-100-angular
KNN_QUERIES = 640
MAXSIM_SHAPE = (100_000, 128, 128)  # ColBERTv2: passages, max tokens, dims
MAXSIM_MIN_TOKENS = 32
MAXSIM_QUERIES = 640
MAXSIM_QUERY_TOKENS = 32            # ColBERT's query length
MAXSIM_SLICE = 16384                # docs the plain versions score at B=4
MAXSIM_ORACLE_QUERIES = 64
PQ_M = 32                           # 4-dim subvectors of 128 dims
PQ_SAMPLE = 20_000
HYBRID_DIMS = 768                   # msmarco-distilbert-base-tas-b
HYBRID_QUERIES = 320
SORTED_SEGMENTS = 4                 # the sorted cell's multi-segment index
SORTED_SINGLES = 100                # B=1 requests per body and index
SORTED_DEEP_SINGLES = 1             # of the deep search_after body (cut
                                    # from 20, then 2, to fit phases 14-16)
TIMING_BUDGET_MS = 1000.0           # of one timed measurement's reps
SORTED_CURSOR_HIT = 20000           # search_after's depth, in hits
AGGKIND_BODIES_PER_FAMILY = 64      # the agg-kinds cell's bodies a family
RELEVANCE_BODIES_PER_FAMILY = 64    # the relevance cell's bodies a family
RELEVANCE_SAMPLE = 16               # of them checked against the plain
RELEVANCE_CUT_DOCS = 100_000        # versions, on a cut of the passages
# the scoring kinds' pages against the plain versions: transcendental
# functions may differ by an ulp or two between the card and the CPU
SCORING_RTOL, SCORING_ATOL = 2e-6, 1e-7
DAY_MS = 86400_000


# with --out DIR, every log line also goes to DIR/log.txt (a runner that
# keeps only the end of the standard output loses the early phases)
_LOG_FILE = None
_T0 = time.perf_counter()


def log(*args):
    print(*args, flush=True)
    if _LOG_FILE is not None:
        # the log file's lines carry the seconds since the script started
        print(f"[{time.perf_counter() - _T0:.1f} s]", *args, file=_LOG_FILE,
              flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_mhz():
    """The card's top SM clock (nvidia-smi clocks.max.sm), MHz, or None
    where nvidia-smi does not answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def cuda_ms(torch, fn, reps: int = 15, warmup: int = 3,
            lead: bool = False) -> float:
    """Median milliseconds of one call of fn() on the stream, between CUDA
    events, L2 flushed before each rep. A call whose host work outlasts its
    device work (a wrapper's checks and launch, a plain version's syncs)
    is measured with that host time included; a call slower than
    TIMING_BUDGET_MS / reps gets fewer reps. With `lead` the stream
    first spins for about 10 ms, so that the events and fn's launches are
    all queued before the first event runs and a stall of the host thread
    (another thread holding the GIL) is not counted."""
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if warmup:
        # a slow call is timed fewer times: about TIMING_BUDGET_MS of reps
        each = (time.perf_counter() - t0) * 1e3 / warmup
        reps = max(1, min(reps, int(TIMING_BUDGET_MS / max(each, 1e-3))))
    times = []
    for _ in range(reps):
        flush.zero_()
        if lead:
            torch.cuda._sleep(LEAD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def plain_ms(torch, fn) -> float:
    """Median milliseconds of up to 3 calls of a plain version, timed as
    cuda_ms times them, right after its check ran it (that call is the
    warm-up): as cuda_ms(fn, reps=3, warmup=1), a call slower than
    TIMING_BUDGET_MS / 3 is timed fewer times."""
    times = [cuda_ms(torch, fn, reps=1, warmup=0)]
    reps = max(1, min(3, int(TIMING_BUDGET_MS / max(times[0], 1e-3))))
    times += [cuda_ms(torch, fn, reps=1, warmup=0) for _ in range(reps - 1)]
    return statistics.median(times)


def graph_ms(torch, fn, reps: int = 15) -> float:
    """Median device milliseconds of the kernels fn() launches: fn is
    captured once into a CUDA graph and the graph is replayed between CUDA
    events behind a lead (see cuda_ms), L2 flushed before each rep, so no
    host time is counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(torch, graph.replay, reps=reps, warmup=2, lead=True)


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
    from opensearch_tpu_torch.search.executor import stage_inputs
    return stage_inputs([p.flatten_inputs([]) for p in plans],
                        np.asarray(min_scores, np.float32), device)


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
    from opensearch_tpu_torch.ops import bm25
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
               "plain_ms": plain_ms(torch, plain),
               "library_ms": None,
               "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                               flops / F32_FLOPS) * 1e3,
               "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
               >= flops / F32_FLOPS else "operations"}
        results.setdefault("bm25_candidate", []).append(rec)
        log("K1", json.dumps(rec))

    # K2 and K3 at Dp = 2^20 on dense-path queries (20 terms)
    for bsz in (1, 32):
        plans, blk, ms = dense_batch(torch, np, seg, mapper, meta, bsz, dev)
        k2_record(torch, arrays, blk, d_pad, results)
        scores, matches = _eval_plan(plans[0], arrays, [blk], [0], bsz)
        k3_records(torch, np, scores, matches, arrays, meta, ms, results)
    return results


def k2_record(torch, arrays, blk, d_pad: int, results, keep=None,
              label: str = "", passes: bool = False):
    """One record of K2 `score_text_clause` (with K20's `keep` mask: its
    keep entry): two runs bit for bit with each other and with the plain
    version (hits exactly); device ms (graph replay), a call's, the plain
    version's; the byte bound (each kept block's docs, tfs and norms
    read, the ids and weights, the dense scores and hits written); the
    device memory a call takes beyond what it returns (its scratch, read
    from the allocator's peak); with `passes`, each kernel's device ms a
    call."""
    from opensearch_tpu_torch.ops import bm25
    bsz, qb = blk["ids"].shape
    kept = blk if keep is None else dict(
        blk, ids=torch.where(keep, blk["ids"], -1))
    name = "score_text_clause" if keep is None else "score_text_clause_keep"

    def kern():
        return bm25.score_text_clause(arrays, blk, block_keep=keep)

    def plain():
        return bm25.score_text_clause_plain(arrays, kept)
    (ks, kh), (ks2, kh2), (ps, ph) = kern(), kern(), plain()
    torch.cuda.synchronize()
    if not (_same_bits(torch, ks, ks2) and torch.equal(kh, kh2)):
        raise AssertionError(f"{name} B={bsz}{label}: two runs differ")
    if not torch.equal(kh, ph):
        raise AssertionError(f"{name} B={bsz}{label}: hits differ")
    if not _same_bits(torch, ks, ps):
        err = float((ks - ps).abs().max().item())
        raise AssertionError(f"{name} B={bsz}{label}: scores differ by "
                             f"{err}")
    blocks = int((kept["ids"] >= 0).sum().item())
    nbytes = blocks * 128 * 12 + bsz * qb * (8 if keep is None else 9) \
        + bsz * d_pad * 8
    bound_ms, bound_by = _bound(nbytes, blocks * 128 * 10)
    rec = {"shape": f"B={bsz}{label} QB={qb} blocks={blocks} Dp={d_pad}",
           "max_abs_err": 0.0, "ms": graph_ms(torch, kern),
           "call_ms": cuda_ms(torch, kern),
           "plain_ms": plain_ms(torch, plain), "library_ms": None,
           "bound_ms": bound_ms, "bound_by": bound_by}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    outs = kern()
    torch.cuda.synchronize()
    rec["peak_scratch_bytes"] = torch.cuda.max_memory_allocated() - before \
        - sum(o.numel() * o.element_size() for o in outs)
    del outs
    if passes:
        rec["passes"] = launch_ms(torch, kern, by_name=True)
    results.setdefault(name, []).append(rec)
    log(name, json.dumps(rec))
    return rec


def dense_batch(torch, np, seg, mapper, meta, bsz: int, dev):
    """Phase 2's dense-path batch of B 20-term match queries on the scale
    corpus: (plans, the staged input block, min_score)."""
    from opensearch_tpu_torch.search import dsl
    from opensearch_tpu_torch.search.compile import Compiler, ShardStats
    from opensearch_tpu_torch.utils.demo import fast_query_terms
    compiler = Compiler(mapper, ShardStats([seg]))
    texts = fast_query_terms(bsz, sorted(t for _, t in seg.term_dict),
                             seed=90 + bsz, terms_per_query=20)
    plans = [compiler.compile(dsl.parse_query({"match": {"body": t}}), seg,
                              meta) for t in texts]
    nodes, ms = stacked_inputs(torch, plans, [-np.inf] * bsz, dev)
    return plans, nodes[0], ms


def select_reads(torch, entry: str, args, bsz: int, d_pad: int, k: int):
    """Per row, the passes of the masked top-k family's select that read
    the whole input: `entry` called once more on args with a scratch of
    its own, read back after the timed replays. None on a tree whose
    select keeps no such count (a parent checkout in an A/B)."""
    from opensearch_tpu_torch.ops import topk
    if not hasattr(topk, "select_full_reads"):
        return None
    scratch = topk.select_scratch(entry, bsz, d_pad, k, "cuda")
    getattr(topk, entry)(*args, scratch=scratch)
    return topk.select_full_reads(scratch, bsz)


def select_record(torch, results, name, shape, kern, plain, library,
                  nbytes, reads, passes: bool = False):
    """One record of the masked top-k family (K3, its threshold and keyed
    entries): two runs of kern and its plain version, bit for bit; device
    ms (graph replay), a call's ms, the plain version's and torch.topk's;
    the byte bound; then each row's full reads (`reads()`) and, with
    `passes`, the device ms of each of a call's launches."""
    got, again, want = kern(), kern(), plain()
    torch.cuda.synchronize()
    if not _same_bits(torch, got, again):
        raise AssertionError(f"{name} {shape}: two runs differ")
    if not _same_bits(torch, got, want):
        raise AssertionError(f"{name} {shape}: kernel and plain version "
                             f"differ")
    rec = {"shape": shape, "max_abs_err": 0.0, "ms": graph_ms(torch, kern),
           "call_ms": cuda_ms(torch, kern),
           "plain_ms": plain_ms(torch, plain),
           "library_ms": graph_ms(torch, library),
           "bound_ms": _bytes_bound(nbytes), "bound_by": "bytes",
           "library": "torch.topk", "full_reads": reads()}
    if passes:
        rec["passes"] = launch_ms(torch, kern)
    results.setdefault(name, []).append(rec)
    log(name, json.dumps(rec))


def k3_records(torch, np, scores, matches, arrays, meta, ms, results,
               passes: bool = False):
    """K3 at k 10, 100 and 1,000 on one dense batch (scores and matches
    [B, Dp]) against its plain version; torch.topk of the masked scores
    is the library yardstick."""
    from opensearch_tpu_torch.ops import topk
    bsz, d_pad = scores.shape
    masked = torch.where(matches, scores, float("-inf"))
    for k in (10, 100, 1000):
        args = (scores, matches, arrays["live"], arrays["root"],
                meta.num_docs, ms, k)
        # scores and match flags a query, live and root once, the rows out
        nbytes = bsz * d_pad * 5 + d_pad * 2 + bsz * (2 * k + 1) * 4
        select_record(torch, results, "masked_topk",
                      f"B={bsz} Dp={d_pad} k={k}",
                      lambda args=args: topk.masked_topk(*args),
                      lambda args=args: topk.masked_topk_plain(*args),
                      lambda k=k: torch.topk(masked, k, dim=1), nbytes,
                      lambda args=args, k=k: select_reads(
                          torch, "masked_topk", args, bsz, d_pad, k), passes)


def keyed_records(torch, np, seg, arrays, meta, dev, results,
                  passes: bool = False):
    """K3-keyed at B=1 on the 10M-doc structured segment keyed by ts desc
    (K13's value ranks): over the sorted cell's nyc_taxis-shaped filter
    (views >= 2,000) at k 10, 10,128 and 41,088 (past one CTA's sort), and
    over every doc (the rally `desc_sort_timestamp` body, match_all) at k
    10 and 41,088, where the k-th key's first-digit bin holds more ranks
    than the candidate buffer (the overflow rule: three full reads).
    torch.topk of the masked key is the library yardstick."""
    from opensearch_tpu_torch.ops import sort_key, topk
    d_pad = meta.d_pad
    views = arrays["numeric"]["views"]
    lo = int(np.searchsorted(seg.numeric_dv["views"].unique, 2000))
    scores = torch.ones(1, d_pad, device=dev)
    ms = torch.full((1,), float("-inf"), device=dev)
    key = sort_key.build_sort_key(arrays, ("ts", "desc"))
    filters = (("views>=2000", (views["min_rank"] >= lo)[None, :]
                .contiguous(), (10, 10128, 41088)),
               ("match_all", torch.ones(1, d_pad, dtype=torch.bool,
                                        device=dev), (10, 41088)))
    for label, matches, ks in filters:
        masked = torch.where(matches[0] & arrays["live"], key,
                             float("-inf"))
        for k in ks:
            args = (scores, matches, arrays["live"], arrays["root"],
                    meta.num_docs, ms, key, k)
            # score, match, live, root and key a lane; the rows out
            nbytes = d_pad * (4 + 1 + 1 + 1 + 4) + 12 * k + 4
            select_record(torch, results, "masked_topk_keyed",
                          f"B=1 Dp={d_pad} k={k} {label}",
                          lambda args=args: topk.masked_topk_keyed(*args),
                          lambda args=args: topk.masked_topk_keyed_plain(
                              *args),
                          lambda k=k, masked=masked: torch.topk(masked, k),
                          nbytes,
                          lambda args=args, k=k: select_reads(
                              torch, "masked_topk_keyed", args, 1, d_pad,
                              k), passes)


def threshold_record(torch, results, bsz: int, dev, gen,
                     passes: bool = False):
    """K3's threshold entry at the knn node's shape past MAX_K: B rows of
    Dp 2^20 uniform scores, half the lanes matching, k 20,000;
    torch.topk of the masked scores is the library yardstick."""
    from opensearch_tpu_torch.ops import topk
    d, kt = 1 << 20, 20000
    live = torch.ones(d, dtype=torch.bool, device=dev)
    ms = torch.full((bsz,), float("-inf"), device=dev)
    scores = torch.rand(bsz, d, generator=gen, device=dev)
    matches = torch.rand(bsz, d, generator=gen, device=dev) < 0.5
    masked = torch.where(matches, scores, float("-inf"))
    args = (scores, matches, live, live, d, ms, kt)
    # scores and match flags a query, live and root once, the mark out
    select_record(torch, results, "masked_topk_threshold",
                  f"B={bsz} Dp={d} k={kt}",
                  lambda: topk.masked_topk_threshold(*args),
                  lambda: topk.masked_topk_threshold_plain(*args),
                  lambda: torch.topk(masked, kt, dim=1),
                  bsz * d * 6 + 2 * d,
                  lambda: select_reads(torch, "masked_topk_threshold", args,
                                       bsz, d, kt), passes)


def phase_topk_cell(torch, np, dev) -> dict:
    """The masked top-k family alone, at phase 2's shapes and on its
    corpora (K3 on the scale corpus' dense batches at B=1 and B=32, K3's
    threshold entry at B=32, K3-keyed on the 10M-doc structured segment),
    each record with the device ms of each launch of a call (`passes`):
    one script's records on two checkouts compare their kernels on one
    card."""
    from opensearch_tpu_torch.ops.device_segment import upload_segment
    from opensearch_tpu_torch.search.plan_eval import _eval_plan
    from opensearch_tpu_torch.utils.demo import build_shards_fast
    results = {}
    mapper, (seg,), _terms = build_shards_fast(
        SCALE_DOCS, 1, vocab_size=20000, avg_len=60, seed=42,
        materialize_terms=SCALE_MATERIALIZE_TERMS)
    arrays, meta = upload_segment(seg, dev)
    for bsz in (1, 32):
        plans, blk, ms = dense_batch(torch, np, seg, mapper, meta, bsz, dev)
        scores, matches = _eval_plan(plans[0], arrays, [blk], [0], bsz)
        k3_records(torch, np, scores, matches, arrays, meta, ms, results,
                   passes=True)
    del arrays, seg
    threshold_record(torch, results, 32, dev,
                     torch.Generator(device=dev).manual_seed(31), passes=True)
    _m, agg = agg_segment(np, AGG_SCALE_DOCS)
    arrays, meta = upload_segment(agg, dev)
    keyed_records(torch, np, agg, arrays, meta, dev, results, passes=True)
    del arrays, agg
    torch.cuda.empty_cache()
    return {name: [{key: r[key] for key in ("shape", "ms", "library_ms",
                                              "bound_ms", "full_reads",
                                              "passes")}
                   for r in recs] for name, recs in results.items()}


def phase_binned_cell(torch, np, dev) -> dict:
    """K5's, K6's, K23 reverse_nested's and K24's records alone, at phase
    2's shapes and on its corpora (K5 and K6 on the 10M-doc structured
    segment: K5's fused cardinality, popcount route, phase 3's lane count
    and gathered layout with pmask; K6's avg sums under terms, the
    date_histogram counts, the static child-bin max; K23's reverse_nested
    under a monthly date_histogram and with a 10,000-row root, and K24's
    dynamic child-bin max on the nested cell's image; K24 on the geo
    cell's: cnt + sum, cnt + min + max, and cnt + sum past
    SCATTER_MAX_BINS bins), each record with each kernel's device ms a
    call (`passes`):
    one script's records on two checkouts compare their kernels on one
    card."""
    from opensearch_tpu_torch.utils.demo import geonames_segment, qa_segment
    results = {}
    mapper, agg = agg_segment(np, AGG_SCALE_DOCS)
    results.update(phase_agg_kernels(torch, np, mapper, agg, dev,
                                     parts=("k5", "k6"), passes=True))
    del agg
    _qm, qa_seg = qa_segment(NESTED_QUESTIONS)
    _gm, geo_seg = geonames_segment(GEO_PLACES)
    results.update(phase_nested_geo_kernels(torch, np, qa_seg, geo_seg, dev,
                                            parts=("k23r", "k24"),
                                            passes=True))
    del qa_seg, geo_seg
    torch.cuda.empty_cache()
    keys = ("shape", "ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
            "max_abs_err", "peak_scratch_bytes", "passes")
    return {name: [{k: r[k] for k in keys if k in r} for r in recs]
            for name, recs in results.items()}


def phase_textpq_cell(torch, np, dev) -> dict:
    """K2's and K11's records alone, at phase 2's shapes and on its
    corpora: K2 at B=1 and B=32 on the scale corpus' dense batches and its
    keep entry on the block-max batches (2-4 terms, one term), K11's
    scorer on the MaxSim corpus (the B=4 slice, B=1 and B=32; codebook as
    phase 2 trains it; then B=1 with every code byte 0, which takes the
    table reads' bank conflicts away), each with its kernels' device ms a
    call (`passes`): one script's records on two checkouts compare the
    kernels on one card."""
    from concurrent.futures import ThreadPoolExecutor
    from opensearch_tpu_torch.ops.device_segment import upload_segment
    from opensearch_tpu_torch.ops.maxsim import train_pq
    from opensearch_tpu_torch.utils.demo import build_shards_fast
    results = {}
    mc = maxsim_corpus(torch, np, dev)
    pool = ThreadPoolExecutor(max_workers=1)
    codebook_job = pool.submit(train_pq, pq_sample(np, mc), PQ_M)
    mapper, (seg,), _terms = build_shards_fast(
        SCALE_DOCS, 1, vocab_size=20000, avg_len=60, seed=42,
        materialize_terms=SCALE_MATERIALIZE_TERMS)
    arrays, meta = upload_segment(seg, dev)
    for bsz in (1, 32):
        _plans, blk, _ms = dense_batch(torch, np, seg, mapper, meta, bsz, dev)
        k2_record(torch, arrays, blk, meta.d_pad, results, passes=True)
    del arrays
    results.update(phase_spmd_kernels(
        torch, np, mapper, seg, sorted(t for _, t in seg.term_dict), None,
        dev, keep_only=True, passes=True))
    del seg
    codebook = codebook_job.result()
    pool.shutdown()
    results.update(phase_maxsim_kernels(torch, np, mc, codebook, dev,
                                        k11_only=True))
    torch.cuda.empty_cache()
    keys = ("shape", "ms", "call_ms", "plain_ms", "bound_ms",
            "lookup_floor_ms", "peak_scratch_bytes", "passes")
    return {name: [{k: r[k] for k in keys if k in r} for r in recs]
            for name, recs in results.items()}


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
    # the result page (K14) is a node-start setting
    page_settings = {"search.result_page.enabled": True}
    gpu_page = Node(settings=page_settings) if device is None \
        else Node(device=device, settings=page_settings)
    cpu_page = Node(device="cpu", settings=page_settings)
    # block-max (K20 and K1's / K2's keep entries) is a node-start setting
    bm_settings = {"search.blockmax.enabled": True}
    gpu_bm = Node(settings=bm_settings) if device is None \
        else Node(device=device, settings=bm_settings)
    cpu_bm = Node(device="cpu", settings=bm_settings)
    if gpu.device.type != (device or "cuda"):
        raise AssertionError(f"Node() resolved to {gpu.device}")
    # the k-NN path starts at indexing: a refresh seals the IVF lists of
    # `v_ivf` (K9), so the launch window opens before the loads
    _build.reset_launches()
    t_load = time.perf_counter()
    for node in (gpu, cpu):
        parity.load_index(node, "passages", n_docs=5000)
        parity.load_docs_index(node, "docs", n_docs=parity.DOCS_N)
        parity.load_vecs_index(node, "vecs", n_docs=parity.VECS_N)
        parity.load_mx_index(node, "mx")
        parity.load_hyb_index(node, "hyb")
        parity.load_big_index(node, "big")
        parity.load_sorted_index(node, "sorted")
        parity.load_taxi_index(node, "taxi")
        parity.load_rel_index(node, "rel")
        parity.load_rel_custom_index(node, "relc")
        # the multi-shard slice: a 3-shard index of two segments a shard
        # (6 rows) and four one-shard daily indices behind logs-*
        parity.load_sharded_index(node, "s3", 3)
        parity.load_logs_indices(node)
        # nested documents and places (K22-K25)
        parity.load_qa_index(node, "qa")
        parity.load_geo_index(node, "geo")
        if node is gpu:
            log(f"serving: seventeen indices loaded on the card in "
                f"{(time.perf_counter() - t_load) * 1e3:.3f} ms")
    for node in (gpu_page, cpu_page):
        parity.load_sorted_index(node, "sorted")
    for node in (gpu_bm, cpu_bm):
        parity.load_zipf_index(node, "zipf", 1)
        parity.load_zipf_index(node, "zipf2", 2)
    payload = parity.msearch_ndjson("passages", parity.msearch_bodies(32))
    knn_bodies = parity.knn_bodies()
    knn_payload = parity.msearch_ndjson("vecs",
                                        parity.knn_msearch_bodies(32))
    knn_names = sorted(knn_bodies)
    agg_bodies = dict(parity.AGG_BODIES)
    for mode in ("agg_terms", "date_hist"):
        for j, b in enumerate(parity.bench_agg_bodies(mode, 3)):
            agg_bodies[f"{mode}_{j}"] = b
    agg_payload = parity.msearch_ndjson("docs",
                                        parity.agg_msearch_bodies(32))
    names = sorted(parity.SEARCH_BODIES)
    agg_names = sorted(agg_bodies)
    t0 = time.perf_counter()
    got = {n: gpu.request("POST", "/passages/_search",
                          parity.SEARCH_BODIES[n]) for n in names}
    got_m = gpu.request("POST", "/_msearch", payload)
    got_a = {n: gpu.request("POST", "/docs/_search", agg_bodies[n])
             for n in agg_names}
    got_am = gpu.request("POST", "/_msearch", agg_payload)
    got_k = {n: gpu.request("POST", "/vecs/_search", knn_bodies[n])
             for n in knn_names}
    got_km = gpu.request("POST", "/_msearch", knn_payload)
    # late interaction, hybrid and a knn past K3's sort limit: (path,
    # body, params) per request, then the B=32 _msearch payloads
    late = [("/mx/_search", b, {}) for b in parity.maxsim_bodies().values()]
    late += [("/hyb/_search", b, {"search_pipeline": "hyb_norm"})
             for b in parity.hybrid_bodies().values()]
    late.append(("/hyb/_search", {**parity.hybrid_msearch_bodies(1)[0],
                                  "search_pipeline": parity.HYB_PIPELINE},
                 {}))
    late.append(("/big/_search", parity.big_knn_body(), {}))
    late_payloads = [
        parity.msearch_ndjson("mx", parity.maxsim_msearch_bodies(32)),
        parity.msearch_ndjson("hyb", parity.hybrid_msearch_bodies(32))]
    got_l = [gpu.request("POST", path, b, **params)
             for path, b, params in late]
    got_lm = [gpu.request("POST", "/_msearch", pl) for pl in late_payloads]
    # the general path: field sorts, a search_after page and the fetch
    # subphases, on the gate-off node and on the result-page node
    sort_names = sorted(parity.SORT_BODIES)
    sorted_bodies = [parity.SORT_BODIES[n] for n in sort_names] + [
        {"sort": [{"views": "desc"}, {"ts": "asc"}], "size": 50,
         "search_after": [5000, 1700000000000]},
        {"sort": [{"views": "asc"}], "size": 20, "search_after": [7000]},
        {"query": {"match": {"body": "w00011 w00004"}}, "size": 5,
         "highlight": {"fields": {"body": {"fragment_size": 40}}},
         "explain": True, "docvalue_fields": ["views", "tag", "ts"],
         "version": True}]
    got_s = [(n.request("POST", "/sorted/_search", b), b, twin)
             for b in sorted_bodies
             for n, twin in ((gpu, cpu), (gpu_page, cpu_page))]
    sorted_payload = parity.msearch_ndjson("sorted", sorted_bodies[:8])
    got_sm = [(n.request("POST", "/_msearch", sorted_payload), twin)
              for n, twin in ((gpu, cpu), (gpu_page, cpu_page))]
    # the remaining agg kinds and every pipeline type on `taxi`
    kind_names = sorted(parity.AGG_KIND_BODIES)
    got_t = {n: gpu.request("POST", "/taxi/_search",
                            parity.AGG_KIND_BODIES[n]) for n in kind_names}
    kind_payload = parity.msearch_ndjson(
        "taxi", [parity.AGG_KIND_BODIES[n] for n in kind_names[:32]])
    got_tm = gpu.request("POST", "/_msearch", kind_payload)
    # the scoring and lexical query kinds, and the analyzers' indices
    rel_requests = [("/rel/_search", n, b) for n, b in sorted(
        {**parity.SCORING_BODIES, **parity.QUERY_KIND_BODIES}.items())]
    rel_requests += [("/relc/_search", n, b)
                     for n, b in sorted(parity.CUSTOM_BODIES.items())]
    got_r = [gpu.request("POST", path, b) for path, _n, b in rel_requests]
    rel_payloads = [
        parity.msearch_ndjson("rel", [parity.SCORING_BODIES[n] for n in
                                      sorted(parity.SCORING_BODIES)]),
        parity.msearch_ndjson("rel", [parity.QUERY_KIND_BODIES[n] for n in
                                      sorted(parity.QUERY_KIND_BODIES)])]
    got_rm = [gpu.request("POST", "/_msearch", pl) for pl in rel_payloads]
    # multi-shard and multi-index bodies (the program: K21, K3-keyed; the
    # host loop with can-match; DFS), and block-max on the envelope (zipf:
    # K20, K1's keep entry) and on the program (zipf2: K20, K2's keep
    # entry, K21)
    shard_requests = [(f"/{ix}/_search", b) for ix in ("s3", "logs-*")
                      for b in parity.SHARD_BODIES.values()]
    got_sh = [gpu.request("POST", path, b) for path, b in shard_requests]
    shard_payload = parity.msearch_ndjson(
        "s3", list(parity.SHARD_BODIES.values()))
    got_shm = gpu.request("POST", "/_msearch", shard_payload)
    bm_requests = [(f"/{ix}/_search", b) for ix in ("zipf", "zipf2")
                   for b in parity.zipf_bodies((10, 100))]
    got_bm = [gpu_bm.request("POST", path, b) for path, b in bm_requests]
    bm_payload = parity.msearch_ndjson("zipf", parity.zipf_bodies())
    got_bmm = gpu_bm.request("POST", "/_msearch", bm_payload)
    # nested documents (K22, K23, K24) and places (K24, K25): every score
    # mode, inner hits, the aggregations under nested / reverse_nested,
    # geo queries, rank_feature and the geo aggregations
    nest_requests = [("/qa/_search", parity.qa_match_body(u, 40 * u, m))
                     for u, m in enumerate(parity.NESTED_MODES)]
    nest_requests += [("/qa/_search", parity.qa_match_body(
        0, 0, "avg", {"size": 2, "name": "ans"}, size=20))]
    nest_requests += [("/qa/_search", {"size": 0, "aggs": {"n": b}})
                      for b in parity.NESTED_AGG_BODIES.values()]
    nest_requests += [("/geo/_search", b)
                      for b in parity.GEO_QUERY_BODIES.values()]
    nest_requests += [("/geo/_search", {"size": 0, "aggs": b})
                      for b in parity.GEO_AGG_BODIES.values()]
    got_nest = [gpu.request("POST", path, b) for path, b in nest_requests]
    nest_payload = parity.msearch_ndjson("qa", [
        parity.qa_match_body(u, 20 * u, parity.NESTED_MODES[u % 5])
        for u in range(32)])
    got_nestm = gpu.request("POST", "/_msearch", nest_payload)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    log(f"serving: {len(names)} BM25 _search + one B=32 _msearch, "
        f"{len(agg_names)} agg _search + one B=32 agg _msearch, "
        f"{len(knn_names)} knn _search + one B=32 knn _msearch, "
        f"{len(late)} maxsim / hybrid / k=20000 _search + two B=32 "
        f"_msearch, {len(got_s)} sorted _search + two B=8 sorted _msearch, "
        f"{len(kind_names)} agg-kind / pipeline _search + one B=32 _msearch, "
        f"{len(rel_requests)} scoring / lexical _search + two _msearch, "
        f"{len(shard_requests)} multi-shard / multi-index _search + one "
        f"_msearch, {len(bm_requests)} block-max _search + one B=15 "
        f"_msearch on the card in {wall * 1e3:.3f} ms; launches (loads "
        f"included) {json.dumps(launches)}")
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
    for n in knn_names:
        if got_k[n]["_status"] != 200 or not got_k[n]["hits"]["hits"]:
            raise AssertionError(f"knn _search {n}: {got_k[n]}")
        parity.assert_same_response(
            got_k[n], cpu.request("POST", "/vecs/_search", knn_bodies[n]), n)
    parity.assert_same_response(got_km, cpu.request("POST", "/_msearch",
                                                    knn_payload),
                                "knn msearch")
    for (path, b, params), got_one in zip(late, got_l):
        if got_one["_status"] != 200 or not got_one["hits"]["hits"]:
            raise AssertionError(f"{path}: {got_one}")
        parity.assert_same_response(
            got_one, cpu.request("POST", path, b, **params), path)
    for pl, got_one in zip(late_payloads, got_lm):
        if any(r.get("status") != 200 for r in got_one["responses"]):
            raise AssertionError(f"late msearch: {got_one}")
        parity.assert_same_response(got_one, cpu.request("POST", "/_msearch",
                                                         pl), "late msearch")
    for got_one, b, twin in got_s:
        if got_one["_status"] != 200 or not got_one["hits"]["hits"]:
            raise AssertionError(f"sorted _search {b}: {got_one}")
        parity.assert_same_response(
            got_one, twin.request("POST", "/sorted/_search", b), str(b))
    for got_one, twin in got_sm:
        parity.assert_same_response(
            got_one, twin.request("POST", "/_msearch", sorted_payload),
            "sorted msearch")
    for n in kind_names:
        if got_t[n]["_status"] != 200 or "aggregations" not in got_t[n]:
            raise AssertionError(f"agg kind _search {n}: {got_t[n]}")
        want = cpu.request("POST", "/taxi/_search", parity.AGG_KIND_BODIES[n])
        parity.assert_same_response(
            got_t[n], want, n, agg_sum_tol=parity.matrix_stats_tol(want, n))
    want = cpu.request("POST", "/_msearch", kind_payload)
    parity.assert_same_response(
        got_tm, want, "kinds msearch",
        agg_sum_tol=parity.matrix_stats_tol(want, "kinds msearch"))
    for (path, name, b), got_one in zip(rel_requests, got_r):
        if got_one["_status"] != 200 or not got_one["hits"]["hits"]:
            raise AssertionError(f"{path} {name}: {got_one}")
        parity.assert_same_response(
            got_one, cpu.request("POST", path, b), name,
            score_rtol=SCORING_RTOL, score_atol=SCORING_ATOL)
    for pl, got_one in zip(rel_payloads, got_rm):
        if any(r.get("status") != 200 for r in got_one["responses"]):
            raise AssertionError(f"scoring msearch: {got_one}")
        parity.assert_same_response(
            got_one, cpu.request("POST", "/_msearch", pl), "rel msearch",
            score_rtol=SCORING_RTOL, score_atol=SCORING_ATOL)
    for (path, b), got_one in zip(shard_requests, got_sh):
        if got_one["_status"] != 200:
            raise AssertionError(f"{path}: {got_one}")
        parity.assert_same_response(got_one, cpu.request("POST", path, b),
                                    path)
    parity.assert_same_response(got_shm, cpu.request("POST", "/_msearch",
                                                     shard_payload),
                                "shard msearch")
    for (path, b), got_one in zip(bm_requests, got_bm):
        if got_one["_status"] != 200 or not got_one["hits"]["hits"]:
            raise AssertionError(f"{path}: {got_one}")
        parity.assert_same_response(got_one,
                                    cpu_bm.request("POST", path, b), path)
    parity.assert_same_response(got_bmm, cpu_bm.request("POST", "/_msearch",
                                                        bm_payload),
                                "block-max msearch")
    for (path, b), got_one in zip(nest_requests, got_nest):
        if got_one["_status"] != 200:
            raise AssertionError(f"{path}: {got_one}")
        want = cpu.request("POST", path, b)
        parity.assert_same_response(
            got_one, want, path, score_rtol=SCORING_RTOL,
            score_atol=SCORING_ATOL,
            agg_sum_tol={**parity.matrix_stats_tol(want),
                         **parity.centroid_tol(want)})
    parity.assert_same_response(got_nestm, cpu.request("POST", "/_msearch",
                                                       nest_payload),
                                "nested msearch")
    if not any(r["hits"]["total"]["relation"] == "gte"
               for r in got_bm + got_bmm["responses"]):
        raise AssertionError("block-max pruned nothing on the zipf corpus")
    if got_l[-1]["hits"]["total"]["value"] != 20000:
        raise AssertionError(f"knn k=20000: {got_l[-1]['hits']['total']}")
    for node in (gpu, cpu):
        seg = node.indices.get("vecs").shards[0].engine.segments[0]
        if seg.vector_dv["v_ivf"].ivf is None:
            raise AssertionError("the vecs index sealed no IVF index")
    # expand_pad runs on the delta publish: the ingest cell (phase 16)
    # holds its launches
    missing = [k for k, v in launches.items() if v == 0
               and k != "expand_pad"]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    from opensearch_tpu_torch.indices.query_cache import QUERY_CACHE
    log(f"serving: filter cache (mask fills on the card and the CPU) "
        f"{json.dumps(QUERY_CACHE.stats())}")
    log(f"serving: {len(names) + 32} BM25 pages, {len(agg_names) + 32} "
        f"agg responses, {len(knn_names) + 32} knn pages, {len(late) + 64} "
        f"maxsim / hybrid / k=20000 pages, {len(got_s) + 16} sorted / "
        f"search_after / fetch pages (result page off and on) and "
        f"{len(kind_names) + 32} agg-kind / pipeline responses and "
        f"{len(rel_requests) + sum(len(r['responses']) for r in got_rm)} "
        f"scoring / lexical pages, {len(shard_requests) + len(parity.SHARD_BODIES)} "
        f"multi-shard / multi-index responses and "
        f"{len(bm_requests) + len(got_bmm['responses'])} block-max pages "
        f"and {len(nest_requests) + 32} nested / geo responses "
        f"equal the plain versions' (matrix_stats "
        f"within matrix_stats_tol, the scoring kinds' scores to rtol "
        f"{SCORING_RTOL})")
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


def sorted_segments(np, n_docs: int):
    """The sorted cell's four-segment index: agg_segment's docs (the same
    columns and `_id`s) split in doc order into four segments."""
    from opensearch_tpu_torch.utils.demo import structured_segments
    t0 = time.perf_counter()
    _mapper, segs = structured_segments(n_docs, SORTED_SEGMENTS, seed=42)
    log(f"sorted corpus: the {n_docs} docs in {len(segs)} segments of "
        f"{[s.num_docs for s in segs]} docs, built in "
        f"{time.perf_counter() - t0:.3f} s")
    return segs


def _bytes_bound(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def _same_bits(torch, a, b) -> bool:
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def phase_agg_kernels(torch, np, mapper, seg, dev, bsz: int = AGG_BATCH,
                      parts=("k4", "k5", "k6"), passes: bool = False):
    """K4-K6 (those in `parts`) against their plain versions at the
    aggregation scale cell's shapes: B queries of bench.py's two families
    over the structured shard (NVp = Dp); with `passes`, K6's records carry
    each kernel's device ms a call."""
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
               "plain_ms": plain_ms(torch, plain),
               "library_ms": None if library is None
               else graph_ms(torch, library),
               "bound_ms": _bytes_bound(nbytes), "bound_by": "bytes"}
        if passes and name in ("binned_reduce", "binned_popcount"):
            rec["passes"] = launch_ms(torch, kern, by_name=True)
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
    for ident in ((True, False) if "k4" in parts else ()):
        record("pairs_match", f"B={bsz} NVp={n} Dp={d_pad} range "
               f"{'identity' if ident else 'pairs'}",
               lambda ident=ident: (bm25.pairs_match(
                   views["doc_ids"], views["val_ords"], d_pad, ident,
                   lo=lo, hi=hi),),
               lambda ident=ident: (bm25.pairs_match_plain(
                   views["doc_ids"], views["val_ords"], d_pad, ident,
                   lo=lo, hi=hi),),
               None, 8 * n + bsz * d_pad + 8 * bsz, exact)
    if "k4" in parts:
        record("pairs_match", f"B={bsz} NVp={n} Dp={d_pad} rank mask Up={up}",
               lambda: (bm25.pairs_match(views["doc_ids"], views["val_ords"],
                                         d_pad, True, ord_mask=ord_mask),),
               lambda: (bm25.pairs_match_plain(views["doc_ids"],
                                               views["val_ords"], d_pad,
                                               True, ord_mask=ord_mask),),
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
    for label, mask, bbits in ((("presence_bits", elig["date_hist"], bits),
                                ("popcount route", elig["agg_terms"],
                                 tag_bins.bits())) if "k5" in parts else ()):
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
    if "k5" in parts:
        # phase 3's lane count: the first 8,192 lanes as a Dp 8,192 image
        small = 8192
        s_mask = elig["date_hist"][:, :small].contiguous()
        s_bits = bits[:, :small // 32].contiguous()
        s_ok = s_mask.to(torch.int32)
        s_lanes = lanes[:small]
        record("binned_popcount", f"B={bsz} n={small} Dp={small} bins={card} "
               f"presence_bits (phase 3's lanes)",
               lambda: (binned.binned_popcount(s_mask, None, None, small,
                                               s_bits, card),),
               lambda: (binned.binned_popcount_plain(s_mask, None, None,
                                                     small, s_bits, card),),
               lambda: torch.zeros(bsz, card + 1, dtype=torch.int32,
                                   device=dev).scatter_add_(
                   1, s_lanes.expand(bsz, -1), s_ok),
               bsz * small + card * small // 8 + 4 * bsz * card, exact)
        # the gathered layout with a parent mask: the tag pairs' doc ids,
        # the agg_terms queries under the date_hist queries' mask
        t_docs = tag["doc_ids"]
        n_t = t_docs.shape[0]
        t_safe = torch.where(t_docs >= 0, t_docs, 0).long()
        t_ok = (elig["agg_terms"][:, t_safe] & elig["date_hist"][:, t_safe]
                & (t_docs >= 0)[None, :]).to(torch.int32)
        record("binned_popcount", f"B={bsz} n={n_t} Dp={d_pad} bins={card} "
               f"gathered (tag pairs) with pmask",
               lambda: (binned.binned_popcount(elig["agg_terms"],
                                               elig["date_hist"], t_docs, n_t,
                                               tag_bins.bits(), card),),
               lambda: (binned.binned_popcount_plain(
                   elig["agg_terms"], elig["date_hist"], t_docs, n_t,
                   tag_bins.bits(), card),),
               lambda: torch.zeros(bsz, card + 1, dtype=torch.int32,
                                   device=dev).scatter_add_(
                   1, lanes.expand(bsz, -1), t_ok),
               4 * n_t + 2 * bsz * d_pad + card * n_t // 8
               + 4 * bsz * card, exact)
        del s_mask, s_ok, t_ok, t_safe

    if "k6" not in parts:
        del arrays, elig
        torch.cuda.empty_cache()
        return results
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
    # the same sums over a sparse pairs field: one doc in 64 holds a value
    # (uniform f32 in [0, 1000), 16 uniform bins); K6 then packs nothing
    # and reads each lane's mask byte (binned.k6_packs)
    gen = torch.Generator(device=dev).manual_seed(14)
    sp_docs = torch.randperm(d_pad, generator=gen, device=dev)[
        :d_pad // 64].sort()[0].to(torch.int32)
    n_sp = sp_docs.shape[0]
    sp_bins = torch.randint(0, card, (n_sp,), generator=gen, device=dev,
                            dtype=torch.int32)
    sp_vals = torch.rand(n_sp, generator=gen, device=dev) * 1000
    sp_csr = binned.bin_csr(sp_bins, card)
    packs = getattr(binned, "k6_packs", None)   # (older trees: none)
    if packs is not None and packs(n_sp, d_pad):
        raise AssertionError(f"K6 packs the mask at {n_sp} lanes, Dp "
                             f"{d_pad}")
    sp_ok = elig["agg_terms"][:, sp_docs.long()]
    sp_contrib = torch.where(sp_ok, sp_vals, 0.0)
    sp_exact = torch.zeros(bsz, card, dtype=torch.float64,
                           device=dev).index_add_(
        1, sp_bins.long(), sp_contrib.double())
    sp_bound = torch.zeros_like(sp_exact).index_add_(
        1, sp_bins.long(), sp_ok.double()) * F32_SUM_EPS * sp_exact

    def sparse_within(got, want):
        for side in (got[0], want[0]):
            if not bool(((side.double() - sp_exact).abs()
                         <= sp_bound).all()):
                raise AssertionError("f32 sums outside n * 2^-24 * sum|v|")
        return float((got[0] - want[0]).abs().max().item())
    record("binned_reduce", f"B={bsz} n={n_sp} Dp={d_pad} bins={card} sum "
           f"(sparse pairs field, one doc in 64)",
           lambda: (binned.binned_reduce(sp_csr, elig["agg_terms"], None,
                                         sp_docs, sp_vals, 0.0, ("sum",),
                                         bsz)["sum"],),
           lambda: (binned.binned_reduce_plain(
               sp_csr, elig["agg_terms"], None, sp_docs, sp_vals, 0.0,
               ("sum",), bsz)["sum"],),
           lambda: torch.zeros(bsz, card, device=dev).index_add_(
               1, sp_bins.long(), sp_contrib),
           # each lane's doc id and value, and its mask byte a query
           8 * n_sp + bsz * n_sp + 4 * bsz * card, sparse_within)
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
    # the lanes' values kept in CSR order beside each CSR (K6's static
    # copies; the identity layouts need no doc ids)
    ordered = {name: getattr(c, "ordered_bytes", lambda: None)()
               for name, c in (("terms tag", csr), ("date_histogram", hcsr),
                               ("child bins", pcsr))}
    log(f"binned_reduce: CSR-order copies' device bytes {json.dumps(ordered)}")
    del arrays, elig
    torch.cuda.empty_cache()
    return results


def taxi_segment(np, n_docs: int):
    """The agg-kinds cell's shard: utils/demo.taxi_segment (the structured
    columns plus nyc_taxis-shaped `fare` and `passengers`), sealed through
    segment_from_arrays."""
    from opensearch_tpu_torch.utils.demo import taxi_segment as make
    t0 = time.perf_counter()
    mapper, seg = make(n_docs, seed=42, seg_id="t0")
    log(f"taxi corpus: {seg.num_docs} docs (tag / views / ts / fare / "
        f"passengers), {len(seg.numeric_dv['fare'].unique)} distinct fares, "
        f"{int((~seg.numeric_dv['fare'].exists).sum())} docs without one, "
        f"built in {time.perf_counter() - t0:.3f} s")
    return mapper, seg


def aggkind_queries(np, n: int):
    """n distinct `ts` spans, from np.random.RandomState(13) as bench.py's
    date_hist family draws them: each body's query."""
    from opensearch_tpu_torch.utils.demo import BASE_TS
    rng = np.random.RandomState(13)
    spans = 1 + 79 * rng.permutation(n) / max(n, 1)
    return [{"range": {"ts": {"lt": int(BASE_TS + s * DAY_MS)}}}
            for s in spans]


def phase_aggkind_kernels(torch, np, mapper, seg, dev, bsz: int = AGG_BATCH):
    """K15 dense_numeric, K16 matrix_moments and K17 adjacency_counts
    against their plain versions at the agg-kinds cell's shapes: the 10M
    taxi docs (Dp = 2^24), B queries of phase 11's ts spans. K15 and K17
    bit for bit; K16's counts exactly, the same bits on two runs, and each
    sum within depth * 2^-24 * sum|term| of the f64 sum of its f32 terms,
    depth the additions on a term's path: the kernel's
    agg_kernels.moments_sum_depth, the plain version's chunk length plus
    its bin's chunks (scatter_add_ in any order, chunk then bin), and the
    two sides' sum between them. K16 at the root, under terms tag, under
    a daily date_histogram and under terms fare (~13,000 one-chunk bins),
    each with both folds of pass 2 timed."""
    from opensearch_tpu_torch.ops import agg_kernels
    from opensearch_tpu_torch.ops.device_segment import upload_segment
    from opensearch_tpu_torch.search import dsl
    from opensearch_tpu_torch.search.compile import Compiler, ShardStats
    from opensearch_tpu_torch.search.plan_eval import _eval_plan, dense_numeric

    arrays, meta = upload_segment(seg, dev)
    d_pad = meta.d_pad
    comp = Compiler(mapper, ShardStats([seg]))

    def matches(queries):
        plans = [comp.compile(dsl.parse_query(q), seg, meta)
                 for q in queries]
        nodes, _ms = stacked_inputs(torch, plans, [-np.inf] * bsz, dev)
        _scores, m = _eval_plan(plans[0], arrays, nodes, [0], bsz)
        return (m & arrays["live"] & arrays["root"]).contiguous()
    elig = matches(aggkind_queries(np, bsz))
    results = {}

    def record(name, shape, kern, plain, library, bound, check,
               library_note=None):
        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        if not all(_same_bits(torch, g, a) for g, a in zip(got, again)):
            raise AssertionError(f"{name} {shape}: two runs differ")
        err = check(got, want)
        rec = {"shape": shape, "max_abs_err": err,
               "ms": graph_ms(torch, kern), "call_ms": cuda_ms(torch, kern),
               "plain_ms": plain_ms(torch, plain),
               "library_ms": None if library is None
               # a library call that syncs (bincount) is timed per call
               else (cuda_ms(torch, library) if library_note
                     else graph_ms(torch, library)),
               "bound_ms": bound[0], "bound_by": bound[1]}
        if library_note:
            rec["library"] = library_note
        results.setdefault(name, []).append(rec)
        log(name, json.dumps(rec))

    def exact(got, want):
        for g, w in zip(got, want):
            if not _same_bits(torch, g, w):
                raise AssertionError("kernel and plain version differ")
        return 0.0

    # K15: the fare column (~10M pairs, ~2% of docs without one) and views;
    # the bound counts the real pairs (a padding pair carries no value)
    for field in ("fare", "views"):
        col = arrays["numeric"][field]
        nv = col["doc_ids"].shape[0]
        n_pairs = int((col["doc_ids"] >= 0).sum())
        idx = torch.where(col["doc_ids"] >= 0, col["doc_ids"], d_pad).long()
        vals = col["values_f32"]
        record("dense_numeric", f"NVp={nv} Dp={d_pad} {field}",
               lambda col=col: agg_kernels.dense_numeric(
                   col["doc_ids"], col["values_f32"], d_pad),
               lambda col=col: agg_kernels.dense_numeric_plain(
                   col["doc_ids"], col["values_f32"], d_pad),
               lambda idx=idx, vals=vals: (
                   torch.full((d_pad + 1,), float("inf"),
                              device=dev).scatter_reduce_(0, idx, vals,
                                                          "amin"),
                   torch.bincount(idx, minlength=d_pad + 1)),
               _bound(8 * n_pairs + 8 * d_pad, 0), exact,
               library_note="scatter_reduce_ amin + bincount, one call each "
                            "(bincount syncs: CUDA events, not a graph)")

    # K16: matrix_stats of fare and views at the root, under terms tag and
    # under a daily date_histogram of ts (its host values: exact days)
    fields = ("fare", "views")
    dense = [dense_numeric(arrays, f, d_pad) for f in fields]
    vals = torch.stack([v for v, _e, _c in dense]).contiguous()
    exists = torch.stack([e for _v, e, _c in dense]).contiguous()
    tag = arrays["ordinal"]["tag"]
    pbin = torch.full((d_pad,), -1, dtype=torch.int32, device=dev)
    pbin[tag["doc_ids"][tag["doc_ids"] >= 0].long()] = \
        tag["ords"][tag["doc_ids"] >= 0]
    n_tags = len(seg.ordinal_dv["tag"].dictionary)
    ts_col = seg.numeric_dv["ts"]
    day = ts_col.values // DAY_MS
    day = (day - day.min()).astype(np.int32)
    n_days = int(day.max()) + 1
    dbin = torch.full((d_pad,), n_days, dtype=torch.int32, device=dev)
    dbin[torch.from_numpy(ts_col.doc_ids.astype(np.int64)).to(dev)] = \
        torch.from_numpy(day).to(dev)
    # and under a terms of fare (each distinct fare a bin of one chunk)
    fare_col = seg.numeric_dv["fare"]
    n_fares = len(fare_col.unique)
    fbin = torch.full((d_pad,), n_fares, dtype=torch.int32, device=dev)
    fbin[torch.from_numpy(fare_col.doc_ids.astype(np.int64)).to(dev)] = \
        torch.from_numpy(fare_col.value_ords.astype(np.int32)).to(dev)
    groups = agg_kernels.moment_groups(len(fields))
    chunk = agg_kernels.MOMENTS_CHUNK
    for label, card, lanes in (
            ("root", 1, torch.zeros(d_pad, dtype=torch.int32, device=dev)),
            ("under terms tag", n_tags,
             torch.where(pbin >= 0, pbin, n_tags)),
            ("under date_histogram 1d", n_days, dbin),
            ("under terms fare", n_fares, fbin)):
        csr = agg_kernels.moments_csr(lanes, card)
        block = agg_kernels.moments_block_fold(csr)
        rel = {f: agg_kernels.moments_sum_depth(chunk, csr.max_bin_chunks, f)
               * F32_SUM_EPS for f in (False, True)}
        rel_plain = (chunk + csr.max_bin_chunks) * F32_SUM_EPS
        blong = torch.where(lanes < card, lanes, card).long()
        exact_sums = []       # (group, sum, f64 sum, f64 sum|term|) per bin
        for g, (a, b) in enumerate(groups):
            own = elig & exists[a] & exists[b]
            xa, xb = vals[a], vals[b]
            x2 = xa * xa
            terms = ((xa, x2, x2 * xa, x2 * x2) if a == b
                     else (xa * xb, xa, xb))
            for k, t in enumerate(terms):
                t = torch.where(own, t, 0.0).double()
                ex = torch.zeros(bsz, card + 1, dtype=torch.float64,
                                 device=dev).index_add_(1, blong, t)
                ab = torch.zeros_like(ex).index_add_(1, blong, t.abs())
                exact_sums.append((g, k, ex[:, :card], ab[:, :card]))
                del t

        def within(got, want, fold=block):
            cnt, sums = got
            if not torch.equal(cnt, want[0]):
                raise AssertionError("matrix_moments counts differ")
            worst = 0.0
            for g, k, ex, ab in exact_sums:
                mine = sums[k, g].double()
                plain = want[1][k, g].double()
                for side, r, what in (
                        (mine, rel[fold], "kernel"),
                        (plain, rel_plain, "plain version")):
                    if not bool(((side - ex).abs() <= r * ab).all()):
                        raise AssertionError(
                            f"matrix_moments ({what}) group {g} sum {k} "
                            f"outside {r:.3g} * sum|term| of the f64 sum")
                gap = (mine - plain).abs()
                if not bool((gap <= (rel[fold] + rel_plain) * ab).all()):
                    raise AssertionError(
                        f"matrix_moments group {g} sum {k}: kernel and "
                        f"plain version differ by more than their bounds")
                worst = max(worst, float(gap.max()))
            return worst
        # the library yardstick: the same sums as one GEMM of the query
        # masks by the per-doc term columns (TF32 off), terms built before
        term_mat = mask_f = None
        if card == 1:
            cols = []
            for a, b in groups:
                e = (exists[a] & exists[b]).float()
                xa, xb = vals[a] * e, vals[b] * e
                x2 = xa * xa
                cols += [e] + ([xa, x2, x2 * xa, x2 * x2] if a == b
                               else [xa * xb, xa, xb])
            term_mat = torch.stack(cols, dim=1).contiguous()
            mask_f = elig.float()
            torch.backends.cuda.matmul.allow_tf32 = False
        # f32 operations a doc and query: a field's 3 products and 4 sums,
        # a pair's product and 3 sums
        n_cross = len(groups) - len(fields)
        shape = (f"B={bsz} Dp={d_pad} F={len(fields)} parent_card={card} "
                 f"({label}; largest bin {csr.max_bin_chunks} chunks)")
        record("matrix_moments", shape,
               lambda csr=csr: agg_kernels.matrix_moments(
                   csr, elig, None, vals, exists),
               lambda csr=csr: agg_kernels.matrix_moments_plain(
                   csr, elig, None, vals, exists),
               (lambda: torch.matmul(mask_f, term_mat)) if card == 1
               else None,
               _bound(bsz * d_pad + len(fields) * 5 * d_pad
                      + (4 * d_pad if card > 1 else 0),
                      bsz * d_pad * (7 * len(fields) + 4 * n_cross)),
               within)
        # pass 2's other fold on the same parent: held to its own bound
        # and timed beside the chosen one
        other = not block

        def run_other(csr=csr, other=other):
            return agg_kernels.matrix_moments(csr, elig, None, vals, exists,
                                              other)
        got = run_other()
        within(got, agg_kernels.matrix_moments_plain(
            csr, elig, None, vals, exists), fold=other)
        rec = results["matrix_moments"][-1]
        folds = {"block" if block else "warp": rec["ms"],
                 "block" if other else "warp": graph_ms(torch, run_other)}
        rec.update({"fold": "block" if block else "warp",
                    "fold_ms": folds})
        log(f"matrix_moments {label}: pass-2 fold chosen "
            f"{rec['fold']}; graph ms by fold {json.dumps(folds)}")
        del exact_sums, mask_f, term_mat, got

    # K17: four filters of phase 11's adjacency body (doc-value filters:
    # the arrays-built segment has no postings, so no keyword term query)
    filters = [{"term": {"passengers": 1}}, {"range": {"fare": {"gte": 2000}}},
               {"terms": {"passengers": [5, 6]}},
               {"range": {"views": {"lt": 2500}}}]
    masks = [matches([f] * bsz) for f in filters]
    n_f = len(filters)
    pairs = agg_kernels.adjacency_pairs(n_f)
    mq = torch.stack([m & elig for m in masks], dim=1).float()
    record("adjacency_counts", f"B={bsz} Dp={d_pad} n={n_f} parent_card=1",
           lambda: (agg_kernels.adjacency_counts(masks, elig, None, None,
                                                 1),),
           lambda: (agg_kernels.adjacency_counts_plain(masks, elig, None,
                                                       None, 1),),
           lambda: torch.bmm(mq, mq.transpose(1, 2)),
           _bound((n_f + 1) * bsz * d_pad, 0), exact)
    got = agg_kernels.adjacency_counts(masks, elig, None, None, 1)
    gram = torch.bmm(mq, mq.transpose(1, 2))
    for p, (i, j) in enumerate(pairs):
        if not torch.equal(got[:, p, 0].double(), gram[:, i, j].double()):
            raise AssertionError("adjacency_counts differs from the Gram "
                                 "matrix of the masks")
    del mq, gram, masks, arrays, elig, vals, exists
    torch.cuda.empty_cache()
    return results


def _bound(nbytes: float, ops: float):
    """(bound ms, what bounds it) for the bytes a function must move and
    the f32 operations it must do."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def phase_sort_kernels(torch, np, seg, four, dev):
    """K13, K3's keyed entry and K14 against their plain versions, bit for
    bit, at the sorted cell's shapes: K13 over the 10M-doc structured
    segment (ts, views, tag; both orders), K3-keyed at B=1, Dp = 2^24 over
    a views range filter keyed by ts desc (k 10, 10,128, 41,088), K14 over
    the four 2.5M-doc segments' winners (k 138 each, views desc, ts as a
    fused docvalue field)."""
    from opensearch_tpu_torch.ops import page, sort_key, topk
    from opensearch_tpu_torch.ops.device_segment import upload_segment

    arrays, meta = upload_segment(seg, dev)
    d_pad = meta.d_pad
    results = {}

    def record(name, shape, kern, plain, library, nbytes, lib_note=None):
        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        if not _same_bits(torch, got, again):
            raise AssertionError(f"{name} {shape}: two runs differ")
        if not _same_bits(torch, got, want):
            raise AssertionError(f"{name} {shape}: kernel and plain "
                                 f"version differ")
        rec = {"shape": shape, "max_abs_err": 0.0,
               "ms": graph_ms(torch, kern),
               "call_ms": cuda_ms(torch, kern),
               "plain_ms": plain_ms(torch, plain),
               "library_ms": None if library is None
               else graph_ms(torch, library),
               "bound_ms": _bytes_bound(nbytes), "bound_by": "bytes"}
        if lib_note:
            rec["library"] = lib_note
        results.setdefault(name, []).append(rec)
        log(name, json.dumps(rec))
        return got

    # K13: the numeric key reads rank + exists and writes the key (9 B a
    # lane); the ordinal key reads the pairs (8 B each) and exists, writes
    # the key
    for field in ("ts", "views", "tag"):
        for order in ("desc", "asc"):
            def kern(field=field, order=order):
                return sort_key.build_sort_key(arrays, (field, order))

            def plain(field=field, order=order):
                return sort_key.sort_key_plain(arrays, (field, order))
            library = lib_note = None
            if field == "tag":
                col = arrays["ordinal"]["tag"]
                nbytes = col["doc_ids"].shape[0] * 8 + d_pad * 5
                init = 1 << 30 if order == "asc" else -1
                # padding pairs (doc -1) land in one extra, dropped lane
                idx = torch.where(col["doc_ids"] >= 0, col["doc_ids"],
                                  d_pad).long()
                missing = torch.tensor(-1e30, device=dev)

                def library(col=col, order=order, init=init, idx=idx,
                            missing=missing):
                    dense = torch.full((d_pad + 1,), init, dtype=torch.int32,
                                       device=dev).scatter_reduce_(
                        0, idx, col["ords"],
                        "amin" if order == "asc" else "amax")[:d_pad]
                    return torch.where(col["exists"], dense.float(),
                                       missing)
                lib_note = "scatter_reduce_ + where"
            else:
                nbytes = d_pad * 9
            record("sort_key", f"{field} {order} Dp={d_pad}", kern, plain,
                   library, nbytes, lib_note)

    keyed_records(torch, np, seg, arrays, meta, dev, results)
    # the filter cache's mask program (no kernel of its own): the views
    # range's plan through _eval_plan (K4 on the card), then the bool
    # [Dp] mask's one copy to the host
    from opensearch_tpu_torch.indices.query_cache import _eval_filter_mask
    from opensearch_tpu_torch.search import dsl
    from opensearch_tpu_torch.search.compile import Compiler, ShardStats
    from opensearch_tpu_torch.utils.demo import STRUCTURED_MAPPING
    from opensearch_tpu_torch.index.mapper import MapperService
    plan = Compiler(MapperService(STRUCTURED_MAPPING), ShardStats([seg])
                    ).compile(dsl.parse_query({"range": {"views": {
                        "gte": 2000, "lte": 8000}}}), seg, meta)
    mask = _eval_filter_mask(plan, arrays)
    want = ((seg.numeric_dv["views"].values >= 2000)
            & (seg.numeric_dv["views"].values <= 8000))
    if not np.array_equal(mask[:seg.num_docs], want):
        raise AssertionError("filter mask differs from the f64 range")
    rec = {"shape": f"views range, Dp={d_pad}",
           "call_ms": cuda_ms(torch, lambda: _eval_filter_mask(plan,
                                                               arrays)),
           "mask_bytes": int(mask.nbytes)}
    results["filter_mask"] = [rec]
    log("filter_mask", json.dumps(rec))
    del arrays
    torch.cuda.empty_cache()

    # K14: four segments' keyed rows (views desc, k 138 each) into one page
    # of 138 with ts as a fused docvalue field
    images = [upload_segment(s, dev) for s in four]
    rows, sort_cols, dv_cols = [], [], []
    for arr, m in images:
        key = sort_key.build_sort_key(arr, ("views", "desc"))
        rows.append(topk.masked_topk_keyed(
            torch.ones(1, m.d_pad, device=dev),
            torch.ones(1, m.d_pad, dtype=torch.bool, device=dev),
            arr["live"], arr["root"], m.num_docs,
            torch.full((1,), float("-inf"), device=dev), key, 138)[0])
        sort_cols.append(arr["numeric"]["views"])
        dv_cols.append([arr["numeric"]["ts"]])
    stride = max(m.d_pad for _a, m in images)
    desc, n_lanes = page.page_descriptor(rows, "desc", sort_cols, dv_cols)

    def kern():
        return page.page_merge_launch(desc, n_lanes, "desc", 138, stride)

    def plain():
        return page.page_merge_plain(rows, "desc", sort_cols, dv_cols, 138,
                                     stride)
    cat = torch.cat([r[:138] for r in rows])

    def library():
        return torch.topk(cat, 138)
    # the winners' rows read, the page's lanes gathered and written
    nbytes = sum(r.numel() for r in rows) * 4 + 138 * 4 * (7 + 3)
    got = record("page_merge", f"S=4 k=138 each, k_page=138, 1 dv field",
                 kern, plain, library, nbytes,
                 "torch.topk of the concatenated row keys")
    page_all = page.page_merge(rows, "desc", sort_cols, dv_cols, 138, stride)
    if not torch.equal(page_all, got):
        raise AssertionError("page_merge: the wrapper's page differs from "
                             "the launch's")
    del images, rows, desc
    torch.cuda.empty_cache()
    return results


def phase_spmd_kernels(torch, np, mapper, seg, terms, agg_seg, dev,
                       bsz: int = 32, keep_only: bool = False,
                       passes: bool = False):
    """K20 blockmax_keep with K1's and K2's keep entries at B=32 on phase
    4's 2-4-term queries and on one-term queries, which prune lanes
    (compiled with block-max's inputs, at least 16 lanes each; k 10),
    K21's row_merge at R = 5, 8 and 4 rows of k_r = k
    lanes (k 10, 1,000, 40,960, 65,536; keys from 40 values, so ties cross
    rows) and on uneven rows with +-0.0 keys, and K21's row_value_key over
    the 10M-doc `views` column, each bit for bit against its plain
    version. With `keep_only`, K2's keep records alone (K20 runs unrecorded
    to make the masks; `agg_seg` is not read), each with its kernels'
    device ms a call when `passes`."""
    from opensearch_tpu_torch.ops import bm25, spmd as kspmd
    from opensearch_tpu_torch.ops.device_segment import upload_segment
    from opensearch_tpu_torch.search import dsl
    from opensearch_tpu_torch.search.compile import Compiler, ShardStats
    from opensearch_tpu_torch.utils.demo import fast_query_terms

    arrays, meta = upload_segment(seg, dev)
    results = {}

    def record(name, shape, kern, plain, library, nbytes, ops=0.0,
               lib_note=None):
        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        for a, b, what in ((got, again, "two runs differ"),
                           (got, want, "kernel and plain version differ")):
            pairs = zip(a, b) if isinstance(a, tuple) else ((a, b),)
            if not all(_same_bits(torch, x, y) for x, y in pairs):
                raise AssertionError(f"{name} {shape}: {what}")
        bound_ms, bound_by = _bound(nbytes, ops)
        rec = {"shape": shape, "max_abs_err": 0.0,
               "ms": graph_ms(torch, kern), "call_ms": cuda_ms(torch, kern),
               "plain_ms": plain_ms(torch, plain),
               "library_ms": None if library is None
               else graph_ms(torch, library),
               "bound_ms": bound_ms, "bound_by": bound_by}
        if lib_note:
            rec["library"] = lib_note
        results.setdefault(name, []).append(rec)
        log(name, json.dumps(rec))
        return got

    # K20 and the keep entries, on two batches of 32 queries over phase 4's
    # passages: its 2-4-term mix (whose slices hold no doc with two terms,
    # so theta stays under every lane's bound and nothing is pruned), and
    # one-term queries (theta is the 10th best posting of the term's top-8
    # blocks, above the bound of many of its other blocks: lanes drop)
    comp = Compiler(mapper, ShardStats([seg]), blockmax=True)
    for label, per_query, seed in (("2-4 terms", (2, 3, 4), 800),
                                   ("1 term", (1,), 900)):
        plans, n = [], 0
        while len(plans) < bsz:
            q = fast_query_terms(1, terms, seed=seed + n,
                                 terms_per_query=per_query[n % len(
                                     per_query)])[0]
            n += 1
            p = comp.compile(dsl.parse_query({"match": {"body": q}}), seg,
                             meta)
            lanes = p.inputs["ids"].shape[0] if p.kind == "text" else 0
            if bm25.BLOCKMAX_MIN_BLOCKS <= lanes \
                    and lanes * 128 <= bm25.CANDIDATE_MAX_LANES:
                plans.append(p)
        nodes, ms = stacked_inputs(torch, plans, [-np.inf] * bsz, dev)
        blk = nodes[0]
        n_terms, k = max(p.static[1] for p in plans), 10
        qb = blk["ids"].shape[1]
        real = int((blk["ids"] >= 0).sum().item())

        def k20(blk=blk, n_terms=n_terms, k=k, ms=ms):
            return bm25.blockmax_keep_mask(arrays, blk, n_terms, k, ms)

        def k20_plain(blk=blk, n_terms=n_terms, k=k, ms=ms):
            return bm25.blockmax_keep_mask_plain(arrays, blk, n_terms, k, ms)
        if per_query == (1,) and int(k20()[1].sum().item()) == 0:
            raise AssertionError("blockmax_keep pruned no lane of the "
                                 "one-term batch")
        if keep_only:
            keep, _pruned = k20()
            k2_record(torch, arrays, blk, meta.d_pad, results, keep=keep,
                      label=f" {label} ({real} real blocks)", passes=passes)
            del nodes, blk
            continue
        # per lane: id, w, tid, its bound and the keep byte; per query the
        # slice's 1,024 postings (doc, tf, norm, live, root); the bound
        # arithmetic, the slice's partials and run-sums (f32 operations)
        keep, pruned = record(
            "blockmax_keep", f"B={bsz} {label} QB={qb} lanes={real} "
            f"terms<={n_terms} k={k}", k20, k20_plain, None,
            bsz * qb * 17 + bsz * 1024 * 14 + bsz * 4,
            bsz * (qb * 6 + 1024 * (10 + n_terms)))
        kept_blocks = int(((blk["ids"] >= 0) & keep).sum().item())
        log(f"blockmax_keep: {int(pruned.sum())} of {real} lanes pruned at "
            f"B={bsz}, {label}, k={k}")
        kept = dict(blk, ids=torch.where(keep, blk["ids"], -1))

        def k1(blk=blk, n_terms=n_terms, k=k, ms=ms, keep=keep,
               pruned=pruned):
            return bm25.bm25_candidate(arrays, blk, n_terms, False, k, ms,
                                       block_keep=keep, pruned=pruned)

        def k1_plain(kept=kept, n_terms=n_terms, k=k, ms=ms, pruned=pruned):
            rows = bm25.bm25_candidate_plain(arrays, kept, n_terms, False, k,
                                             ms)
            return torch.cat([rows, pruned[:, None].view(torch.float32)], 1)
        record("bm25_candidate_keep", f"B={bsz} {label} QB={qb} kept "
               f"blocks={kept_blocks} of {real} k={k}", k1, k1_plain, None,
               kept_blocks * 128 * 14 + bsz * qb * 9 + bsz * (2 * k + 2) * 4,
               kept_blocks * 128 * 10)

        k2_record(torch, arrays, blk, meta.d_pad, results, keep=keep,
                  label=f" {label} ({real} real blocks)")
        del nodes, blk, kept
    del arrays
    torch.cuda.empty_cache()
    if keep_only:
        return results

    # K21's merge: R rows of K3's keyed layout, each sorted in the total
    # order of its bits (K21's precondition): R of 5, 8 and 4 rows of k_r =
    # k lanes (keys from 40 values, so ties cross rows), k up to the sorted
    # cell's cursor (40,960) and the k-growth cap; then uneven rows with
    # +-0.0 keys (a row's zeros all -0.0 or all +0.0), an empty row and one
    # past k
    gen = torch.Generator(device=dev).manual_seed(21)
    shapes = [([k] * n_rows, k, False) for n_rows in (5, 8, 4)
              for k in (10, 1000, 40960, 65536)]
    shapes += [([k, k // 2, 0, k, 3], k, True) for k in (1000, 40960)]
    shapes += [([65536, 40960, 1, 0, 40960, 7, 65536, 20000], 40960, True)]
    for ks, k, signed in shapes:
        n_rows = len(ks)
        buf = torch.zeros(n_rows, 3 * max(ks) + 1, device=dev)
        for r, kr in enumerate(ks):
            keys = (torch.randint(-20, 20, (kr,), generator=gen, device=dev)
                    if signed else torch.randint(0, 40, (kr,), generator=gen,
                                                 device=dev)).float()
            keys[torch.rand(kr, generator=gen, device=dev) < 0.05] = \
                float("-inf")
            if signed:
                keys[keys == 0] = -0.0 if r % 2 else 0.0
            buf[r, :kr] = torch.sort(keys, descending=True).values
            buf[r, kr:2 * kr] = torch.rand(kr, generator=gen, device=dev)
            buf[r, 2 * kr:3 * kr] = torch.randint(
                0, 1 << 20, (kr,), generator=gen, device=dev,
                dtype=torch.int32).view(torch.float32)
            buf[r, 3 * kr] = torch.tensor(
                [kr], dtype=torch.int32, device=dev).view(torch.float32)
        pruned = torch.zeros(n_rows, dtype=torch.int32, device=dev)

        def k21(buf=buf, ks=ks, pruned=pruned, k=k):
            return kspmd.row_merge(buf, ks, pruned, k)

        def k21_plain(buf=buf, ks=ks, pruned=pruned, k=k):
            return kspmd.row_merge_plain(buf, ks, pruned, k)
        cat = torch.cat([buf[r, :kr] for r, kr in enumerate(ks)])
        take = min(k, cat.shape[0])

        def library(cat=cat, take=take):
            return torch.topk(cat, take)
        label = f"R={n_rows} k={k}" if len(set(ks)) == 1 \
            else f"R={n_rows} ks={ks} k={k} +-0.0"
        # each row's keys, scores and ords read; the packed page written
        record("row_merge", label, k21, k21_plain, library,
               sum(3 * kr + 1 for kr in ks) * 4
               + kspmd.merged_width(k, n_rows) * 4, 0.0,
               "torch.topk of the concatenated row keys")
        del buf, cat

    # K21's key entry over the 10M-doc views column
    col = agg_seg.numeric_dv["views"]
    d_pad = 1 << int(np.ceil(np.log2(agg_seg.num_docs)))
    min_rank = np.full(d_pad, np.iinfo(np.int32).max, np.int32)
    max_rank = np.full(d_pad, -1, np.int32)
    np.minimum.at(min_rank, col.doc_ids, col.value_ords)
    np.maximum.at(max_rank, col.doc_ids, col.value_ords)
    exists = np.zeros(d_pad, bool)
    exists[:agg_seg.num_docs] = col.exists
    u_pad = 1 << int(np.ceil(np.log2(max(len(col.unique), 8))))
    uniq = np.zeros(u_pad, np.float32)
    uniq[:len(col.unique)] = col.unique.astype(np.float32)
    dcol = {"min_rank": torch.from_numpy(min_rank).to(dev),
            "max_rank": torch.from_numpy(max_rank).to(dev),
            "exists": torch.from_numpy(exists).to(dev),
            "unique_f32": torch.from_numpy(uniq).to(dev)}
    for order in ("desc", "asc"):
        def kv(order=order):
            return kspmd.row_value_key(dcol, order, d_pad, dev)

        def kv_plain(order=order):
            return kspmd.row_value_key_plain(dcol, order)
        # per doc the rank and exists bytes read and the key written; the
        # values table (u_pad floats, cache resident) read once
        record("row_value_key", f"views {order} Dp={d_pad}", kv, kv_plain,
               None, d_pad * (4 + 1 + 4) + u_pad * 4)
    del dcol
    torch.cuda.empty_cache()
    return results


def knn_corpora(np, names=("sift", "glove")):
    """The k-NN cells' corpora (set-up): the SIFT-shaped 1M x 128 and the
    GloVe-shaped 1,183,514 x 100 clustered corpora, each with its
    queries from the same stream."""
    from opensearch_tpu_torch.utils.demo import clustered_vectors
    out = {}
    for name in names:
        n, dims = {"sift": SIFT_SHAPE, "glove": GLOVE_SHAPE}[name]
        t0 = time.perf_counter()
        out[name] = clustered_vectors(n, dims, n_queries=KNN_QUERIES)
        log(f"{name} corpus: {n} x {dims} clustered vectors and "
            f"{KNN_QUERIES} queries in {time.perf_counter() - t0:.3f} s")
    return out


def phase_knn_kernels(torch, np, corpora, dev, bsz: int = 32):
    """K7-K9 against their plain versions: K7 on B queries x the SIFT-shaped
    corpus padded to Dp = 2^20 in the three spaces (and B=1 and 8 in l2;
    B at 768 random dims in l2), its top-k mark after K3; K9's 10 seal
    steps, K8's block ranking and K8 at B queries on the whole
    GloVe-shaped corpus (cosine, nlist 256, nprobes 32), as the IVF cell
    runs them. Leaves the sealed IVFIndex in corpora["glove_ivf"]."""
    from opensearch_tpu_torch.index.segment import pad_bucket
    from opensearch_tpu_torch.ops import knn, topk
    results = {}

    def record(name, shape, kern, plain, library, nbytes, ops, check):
        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        if not all(_same_bits(torch, g, a) for g, a in zip(got, again)):
            raise AssertionError(f"{name} {shape}: two runs differ")
        err = check(got, want)
        bound, by = _bound(nbytes, ops)
        rec = {"shape": shape, "max_abs_err": err,
               "ms": graph_ms(torch, kern), "call_ms": cuda_ms(torch, kern),
               "plain_ms": plain_ms(torch, plain),
               "library_ms": None if library is None
               else graph_ms(torch, library),
               "bound_ms": bound, "bound_by": by}
        results.setdefault(name, []).append(rec)
        log(name, json.dumps(rec))
        return rec

    def same_bits(got, want):
        for g, w in zip(got, want):
            if not _same_bits(torch, g, w):
                raise AssertionError("kernel and plain version differ")
        return 0.0

    # K7 on the SIFT-shaped corpus, zero rows past the 1M docs
    vecs, queries = corpora["sift"]
    n, dims = vecs.shape
    d_pad = pad_bucket(n)
    vectors = torch.zeros(d_pad, dims, device=dev)
    vectors[:n] = torch.from_numpy(vecs).to(dev)
    q32 = torch.from_numpy(queries[:bsz]).to(dev)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    sm_mhz = max_sm_clock_mhz()

    def k7(column, q, space):
        b, width = q.shape[0], column.shape[1]
        rec = record(
            "knn_exact", f"B={b} Dp={d_pad} dims={width} {space}",
            lambda: (knn.exact_knn_scores(column, q, space),),
            lambda: (knn.exact_knn_scores_plain(column, q, space),),
            lambda: torch.matmul(q, column.t()),
            4 * d_pad * width + 4 * b * width + 4 * b * d_pad,
            2 * b * d_pad * width + 2 * d_pad * width, same_bits)
        # the bit-equality contract's floor: every multiply and add its own
        # FP32 instruction, 132 SMs x 128 lanes at the card's top SM clock
        # (beside the table's bound, which counts f32 operations at 67
        # TFLOP/s)
        rec["contract_floor_ms"] = None if sm_mhz is None else \
            2 * b * d_pad * width / (132 * 128 * sm_mhz * 1e6) * 1e3
        log(f"knn_exact B={b} dims={width} {space}: contract floor "
            f"{rec['contract_floor_ms']} ms (2 B Dp dims FP32 instructions "
            f"at {sm_mhz} MHz), bound {rec['bound_ms']:.4f} ms, kernel "
            f"{rec['ms']:.4f} ms")
    for space, q in (("l2", q32), ("cosinesimil", q32),
                     ("innerproduct", q32), ("l2", q32[:1].contiguous()),
                     ("l2", q32[:8].contiguous())):
        k7(vectors, q, space)
    # B=32 at the hybrid cell's 768 dims over Dp = 2^20 random rows
    gen = torch.Generator(device=dev).manual_seed(7)
    wide = torch.randn(d_pad, HYBRID_DIMS, generator=gen, device=dev)
    k7(wide, torch.randn(bsz, HYBRID_DIMS, generator=gen, device=dev), "l2")
    del wide
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = prev_tf32

    # knn_topk_mark on K7's l2 scores after K3 (k = 10, eligible: the docs)
    scores = knn.exact_knn_scores(vectors, q32, "l2")
    live = torch.arange(d_pad, device=dev) < n
    eligible = live[None, :].expand(bsz, d_pad).contiguous()
    k = 10
    packed = topk.masked_topk(scores, eligible, live, live, d_pad,
                              torch.full((bsz,), float("-inf"), device=dev),
                              k)
    record("knn_topk_mark", f"B={bsz} Dp={d_pad} k={k}",
           lambda: knn.knn_topk_mark(packed, scores, k),
           lambda: knn.knn_topk_mark_plain(packed, scores, k),
           None, 5 * bsz * d_pad + 4 * bsz * (2 * k + 1) + 4 * bsz * k, 0,
           same_bits)
    del scores, eligible, packed, vectors

    # K8 and K9 on the whole GloVe-shaped corpus, as the IVF cell runs
    # them: K9's 10 seal steps from the reference's initial centroids, then
    # K8 at B=32 over the index they build
    vecs, queries = corpora["glove"]
    n, dims = vecs.shape
    nlist = 256
    data = torch.from_numpy(vecs).to(dev)
    init = torch.from_numpy(vecs[np.random.RandomState(17).choice(
        n, size=nlist, replace=False)]).to(dev)
    x = data.double()
    abs_x = x.abs()

    def within_bound(got, want):
        if not torch.equal(got[1], want[1]):
            raise AssertionError("K9 assignments differ from the plain "
                                 "version's")
        if not _same_bits(torch, got[0], want[0]):
            raise AssertionError("K9 means differ from the plain version's "
                                 "(both sum in one chunked member order)")
        a = got[1].long()
        sums = torch.zeros(nlist, dims, dtype=torch.float64,
                           device=dev).index_add_(0, a, x)
        abss = torch.zeros_like(sums).index_add_(0, a, abs_x)
        cnt = torch.bincount(a, minlength=nlist).double()[:, None]
        ok = cnt[:, 0] > 0
        exact = sums[ok] / cnt[ok]
        # a mean of c members: the f32 sum within c * 2^-24 * sum|x|,
        # over c, plus the division's rounding
        bound = F32_SUM_EPS * abss[ok] + 2 * F32_SUM_EPS * exact.abs()
        for side in (got[0], want[0]):
            if not bool(((side[ok].double() - exact).abs() <= bound).all()):
                raise AssertionError("K9 means outside n * 2^-24 * sum|x|")
        return float((got[0] - want[0]).abs().max().item())
    rec = record("kmeans_step", f"n={n} nlist={nlist} dims={dims} (library: "
                 f"the assignment alone, cdist + argmin)",
                 lambda: knn.kmeans_step(data, init),
                 lambda: knn.kmeans_step_plain(data, init),
                 lambda: torch.cdist(data, init).argmin(1),
                 4 * n * dims + 8 * nlist * dims + 4 * n,
                 2 * n * nlist * dims + 2 * n * dims, within_bound)
    rec["split_ms"] = device_split_ms(torch,
                                      lambda: knn.kmeans_step(data, init))
    log(f"kmeans_step device ms per call by launch: "
        f"{json.dumps(rec['split_ms'])}")
    cent, errs = init, []
    for _ in range(10):
        got = knn.kmeans_step(data, cent)
        errs.append(within_bound(got, knn.kmeans_step_plain(data, cent)))
        cent = got[0]
    rec["max_abs_err"] = max([rec["max_abs_err"], *errs])
    ivf = knn.build_ivf(vecs, np.ones(n, bool), nlist=nlist, nprobe=32,
                        device=dev)
    if not np.array_equal(cent.cpu().numpy(), ivf.centroids):
        raise AssertionError("build_ivf's centroids are not the 10 checked "
                             "K9 steps'")
    log(f"kmeans_step: the seal's 10 steps equal the plain steps bit for "
        f"bit (means within the f64 bound); build_ivf sealed those "
        f"centroids")
    corpora["glove_ivf"] = ivf
    del x, abs_x, data
    packed_np, ids_np = knn.pack_ivf_lists(vecs, ivf.lists)
    pv, pi = (torch.from_numpy(packed_np).to(dev),
              torch.from_numpy(ids_np).to(dev))
    del packed_np, ids_np
    cent = torch.from_numpy(ivf.centroids).to(dev)
    bc = torch.from_numpy(ivf.block_centroid).to(dev)
    nb = bc.shape[0]
    d = pad_bucket(n)
    gq = torch.from_numpy(queries[:bsz]).to(dev)
    record("ivf_block_keys", f"B={bsz} nlist={nlist} blocks={nb} "
           f"dims={dims}",
           lambda: (knn.ivf_block_keys(cent, bc, gq),),
           lambda: (knn.ivf_block_keys_plain(cent, bc, gq),), None,
           4 * nlist * dims + 4 * nb + 4 * bsz * dims + 4 * bsz * nb,
           2 * bsz * nlist * dims + 2 * nlist * dims, same_bits)
    budget = knn.ivf_budget(32, nlist, nb)
    rows = bsz * budget * 256
    for space in ("cosinesimil", "l2", "innerproduct"):
        record("ivf_probe", f"B={bsz} n={n} dims={dims} nlist={nlist} "
               f"blocks={nb} budget={budget} d={d} {space}",
               lambda space=space: knn.ivf_knn_scores(pv, pi, cent, bc, d,
                                                      gq, space, 32),
               lambda space=space: knn.ivf_knn_scores_plain(
                   pv, pi, cent, bc, d, gq, space, 32),
               None,
               rows * (4 * dims + 4) + 4 * nlist * dims + 4 * nb
               + 4 * bsz * dims + 5 * bsz * d,
               4 * rows * dims + 2 * bsz * nlist * dims + 2 * nlist * dims,
               same_bits)
    del pv, pi
    torch.cuda.empty_cache()
    return results


def device_split_ms(torch, fn, reps: int = 5):
    """Device ms per call of each CUDA kernel that `fn` launches, from a
    torch.profiler (CUPTI) trace of `reps` calls; {} when the trace holds
    no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = float(getattr(evt, "self_device_time_total", 0.0) or 0.0)
        name = (re.findall(r"(\w+)\(", evt.key) or [evt.key[:40]])[0]
        out[name] = out.get(name, 0.0) + us / 1e3 / reps
    return out


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


def csr_order_bytes(seg):
    """Device bytes of the per-lane columns K6 keeps in CSR order beside
    the static sides cached on a segment (None where the CSRs keep no such
    copies)."""
    total, seen = None, False
    for st in getattr(seg, "_agg_statics", {}).values():
        for node in st.nodes:
            csr = getattr(node.get("bins"), "_csr", None)
            if csr is not None and hasattr(csr, "ordered_bytes"):
                seen = True
                total = (total or 0) + csr.ordered_bytes()
    return total if seen else None


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
    out = {"image_bytes": reader.device_bytes(),
           "csr_order_bytes": csr_order_bytes(seg)}
    log(f"agg scale: K6's CSR-order copies beside the image: "
        f"{out['csr_order_bytes']} bytes")
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


def _exact_recall(np, vecs, queries, pages, k: int = 10):
    """recall@k of l2 pages against an f64 numpy brute force. A page doc
    outside the f64 top-k counts as a tie (listed, not hidden) when its
    f64 distance lies within the f32 bound of the k-th's: each side of
    |v|^2 - 2 v.q + |q|^2 within dims * 2^-24 * (|v|^2 + 2 |v|.|q| + |q|^2)
    of the exact one."""
    v64 = vecs.astype(np.float64)
    vn = (v64 * v64).sum(axis=1)
    dims = vecs.shape[1]
    hits, ties = 0, []
    for lo in range(0, len(queries), 32):
        q = queries[lo:lo + 32].astype(np.float64)
        d2 = vn[None, :] - 2.0 * (q @ v64.T) + (q * q).sum(axis=1)[:, None]
        for r in range(len(q)):
            top = np.argpartition(d2[r], k)[:k]
            want = set(top.tolist())
            got = pages[lo + r]
            hits += len(want & set(got))
            kth = top[np.argmax(d2[r][top])]

            def bound(i):
                adot = float(np.abs(v64[i]) @ np.abs(q[r]))
                return dims * F32_SUM_EPS * (vn[i] + 2 * adot
                                             + float(q[r] @ q[r]))
            for i in set(got) - want:
                if d2[r][i] - d2[r][kth] <= bound(i) + bound(kth):
                    ties.append((lo + r, int(i), int(kth),
                                 float(d2[r][i] - d2[r][kth])))
                else:
                    raise AssertionError(
                        f"query {lo + r}: doc {i} is not among the f64 "
                        f"top-{k} and no f32 tie")
    return hits / (k * len(queries)), ties


def phase_knn_cell(torch, np, cell: str, corpora, dev, card: str,
                   out_dir=None, bsz: int = 32, singles: int = 300):
    """One k-NN cell served through SearchExecutor: `exact`, the
    SIFT-shaped 1M x 128 l2 scan, or `ivf`, the GloVe-shaped 1,183,514 x
    100 cosine IVF (nlist 256, nprobes 32) sealed on the card. B=1
    `_search` and B=32 `_msearch` walls, queries/s, image bytes, the
    profiler's busy share, recall@10, two pages against the plain
    versions."""
    from opensearch_tpu_torch.ops import _build, knn
    from opensearch_tpu_torch.search.executor import (SearchExecutor,
                                                      ShardReader)
    from opensearch_tpu_torch.utils.demo import vector_segment
    parity = _parity()
    vecs, queries = corpora["sift" if cell == "exact" else "glove"]
    n, dims = vecs.shape
    out = {}
    _build.reset_launches()
    if cell == "ivf":
        space = "cosinesimil"
        t0 = time.perf_counter()
        ivf = knn.build_ivf(vecs, np.ones(n, bool), nlist=256, nprobe=32,
                            device=dev)
        torch.cuda.synchronize()
        out["seal_s"] = time.perf_counter() - t0
        log(f"knn {cell}: IVF sealed on the card in {out['seal_s']:.3f} s "
            f"({ivf.lists.shape[0]} blocks of 256, nlist {ivf.nlist}, "
            f"{_build.LAUNCHES['kmeans_step']} K9 steps); card: {card}")
        checked = corpora.get("glove_ivf")
        if checked is not None and not (
                np.array_equal(ivf.centroids, checked.centroids)
                and np.array_equal(ivf.lists, checked.lists)):
            raise AssertionError("the cell's seal differs from the index "
                                 "whose K8/K9 launches phase 2 checked")
        mapper, seg = vector_segment(vecs, space, ivf=ivf, seg_id="glove0")
    else:
        space = "l2"
        mapper, seg = vector_segment(vecs, space, seg_id="sift0")
    reader = ShardReader(mapper, dev, index_name=f"knn_{cell}")
    t0 = time.perf_counter()
    reader.add_segment(seg)
    torch.cuda.synchronize()
    out["image_bytes"] = reader.device_bytes()
    log(f"knn {cell}: image of {n} x {dims} uploaded in "
        f"{time.perf_counter() - t0:.3f} s: {out['image_bytes']} bytes "
        f"(Dp={reader.device[0][1].d_pad})")
    ex = SearchExecutor(reader)
    bodies = [{"query": {"knn": {"vec": {"vector": q.tolist(), "k": 10}}},
               "size": 10} for q in queries]
    ex.search(bodies[0])
    ex.multi_search(bodies[:bsz])
    torch.cuda.synchronize()
    single = []
    for b in bodies[:singles]:
        t = time.perf_counter()
        ex.search(b)
        single.append((time.perf_counter() - t) * 1e3)
    batches, pages = [], []
    for lo in range(0, len(bodies), bsz):
        t = time.perf_counter()
        resp = ex.multi_search(bodies[lo:lo + bsz])
        batches.append((time.perf_counter() - t) * 1e3)
        pages += [[int(h["_id"][1:]) for h in r["hits"]["hits"]]
                  for r in resp["responses"]]
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    log(f"knn {cell}: launches {json.dumps(launches)}")
    _require_launched(launches, ("masked_topk", "knn_topk_mark")
                      + (("ivf_probe", "ivf_block_keys", "kmeans_step")
                         if cell == "ivf"
                         else ("knn_exact",)), f"k-NN {cell}")

    def pct(xs, p):
        return float(np.percentile(np.asarray(xs), p))
    out.update({"search_p50_ms": pct(single, 50),
                "search_p99_ms": pct(single, 99),
                "msearch32_p50_ms": pct(batches, 50),
                "msearch32_p99_ms": pct(batches, 99),
                "msearch32_qps": bsz * 1e3 / pct(batches, 50)})
    log(f"knn {cell}: B=1 _search wall ms p50 {out['search_p50_ms']:.3f} "
        f"p99 {out['search_p99_ms']:.3f} over {len(single)}; B={bsz} "
        f"_msearch wall ms p50 {out['msearch32_p50_ms']:.3f} p99 "
        f"{out['msearch32_p99_ms']:.3f} over {len(batches)} batches "
        f"({out['msearch32_qps']:.1f} queries/s at p50); card: {card}")
    out.update(profile_waves(torch, ex, bodies[:6 * bsz], out_dir,
                             f"knn_{cell}"))
    if cell == "exact":
        t0 = time.perf_counter()
        recall, ties = _exact_recall(np, vecs, queries, pages)
        out["recall_at_10"] = recall
        out["f32_ties"] = ties
        log(f"knn exact: recall@10 {recall} against an f64 brute force "
            f"over {len(pages)} queries ({time.perf_counter() - t0:.3f} s); "
            f"f32 ties {ties}")
        if recall + len(ties) / (10 * len(pages)) < 1.0:
            raise AssertionError("exact recall@10 below 1.0")
    else:
        exact_pages = []
        for lo in range(0, len(bodies), bsz):
            resp = ex.multi_search([
                {"query": {"knn": {"vec": {
                    **b["query"]["knn"]["vec"],
                    "filter": {"match_all": {}}}}}, "size": 10}
                for b in bodies[lo:lo + bsz]])
            exact_pages += [{int(h["_id"][1:]) for h in r["hits"]["hits"]}
                            for r in resp["responses"]]
        recall = float(np.mean([len(set(p) & e) / 10
                                for p, e in zip(pages, exact_pages)]))
        out["recall_at_10"] = recall
        log(f"knn ivf: recall@10 {recall} against the exact kernel's pages "
            f"over {len(pages)} queries (nprobes 32 of 256 lists)")
        if recall < 0.9:
            raise AssertionError(f"IVF recall@10 {recall} < 0.9")
    # two pages against the plain versions (the same segment on the CPU)
    cpu_reader = ShardReader(mapper, "cpu", index_name=f"knn_{cell}")
    cpu_reader.add_segment(seg)
    cpu_ex = SearchExecutor(cpu_reader)
    for b in bodies[:2]:
        parity.assert_same_response(ex.search(b), cpu_ex.search(b),
                                    f"knn {cell}")
    log(f"knn {cell}: 2 sampled pages equal the plain versions'")
    del cpu_reader, cpu_ex, reader, ex
    torch.cuda.empty_cache()
    return out


def maxsim_corpus(torch, np, dev):
    """The MaxSim cell's corpus (set-up): 100,000 ColBERTv2-shaped
    passages of 32-128 unit 128-d tokens around 1,024 clustered centers
    and 640 queries of 32 tokens, drawn on the card."""
    from opensearch_tpu_torch.utils.demo import clustered_tokens
    n, max_tokens, dims = MAXSIM_SHAPE
    t0 = time.perf_counter()
    tokens, count, queries = clustered_tokens(
        n, dims, MAXSIM_MIN_TOKENS, max_tokens, n_queries=MAXSIM_QUERIES,
        query_tokens=MAXSIM_QUERY_TOKENS, device=dev)
    torch.cuda.synchronize()
    log(f"maxsim corpus: {n} passages x {tokens.shape[1]} token lanes x "
        f"{dims} dims ({int(count.sum())} real tokens) and {len(queries)} "
        f"queries of {queries.shape[1]} tokens in "
        f"{time.perf_counter() - t0:.3f} s")
    return {"tokens": tokens, "count": count, "queries": queries}


def pq_sample(np, mc):
    """PQ_SAMPLE real tokens of the MaxSim corpus (RandomState(29))."""
    rng = np.random.RandomState(29)
    docs = rng.randint(0, len(mc["count"]), PQ_SAMPLE)
    lane = (rng.random_sample(PQ_SAMPLE) * mc["count"][docs]).astype(
        np.int64)
    return np.ascontiguousarray(mc["tokens"][docs, lane])


def phase_maxsim_kernels(torch, np, mc, codebook_np, dev, bsz: int = 32,
                         k11_only: bool = False):
    """K10 and K11 at the MaxSim cell's shapes, K12 and K3's threshold
    entry at the serving shapes, each against its plain version. K11's
    scorer records carry its lookup floor (`lookup_floor_ms`: one 4-byte
    shared-memory read per (doc token, query token, sub-space), 32 a
    cycle on each SM at the card's top SM clock). With `k11_only`, the
    scorer's records alone, each with its kernels' device ms a call
    (`passes`)."""
    from opensearch_tpu_torch.index.segment import pad_bucket
    from opensearch_tpu_torch.ops import hybrid, maxsim, topk
    results = {}
    sm_mhz = max_sm_clock_mhz()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def record(name, shape, kern, plain, library, nbytes, ops, reps=15):
        """Time kern (and plain, library where given) after holding two
        runs of kern against each other and against plain, bit for bit
        (so max_abs_err is 0)."""
        got, again = kern(), kern()
        torch.cuda.synchronize()
        if not all(_same_bits(torch, g, a) for g, a in zip(got, again)):
            raise AssertionError(f"{name} {shape}: two runs differ")
        if plain is not None:
            want = plain()
            for g, w in zip(got, want):
                if not _same_bits(torch, g, w):
                    raise AssertionError(f"{name} {shape}: kernel and "
                                         f"plain version differ")
        bound, by = _bound(nbytes, ops)
        rec = {"shape": shape, "max_abs_err": 0.0,
               "ms": graph_ms(torch, kern, reps=reps),
               "call_ms": cuda_ms(torch, kern, reps=reps),
               "plain_ms": None if plain is None
               else plain_ms(torch, plain),
               "library_ms": None if library is None
               else graph_ms(torch, library, reps=reps),
               "bound_ms": bound, "bound_by": by}
        results.setdefault(name, []).append(rec)
        log(name, json.dumps(rec))
        return got

    n, t_bucket, dims = mc["tokens"].shape
    d_pad = pad_bucket(n)
    tokens = torch.zeros(d_pad, t_bucket, dims, device=dev)
    tokens[:n] = torch.from_numpy(mc["tokens"]).to(dev)
    count = torch.zeros(d_pad, dtype=torch.int32, device=dev)
    count[:n] = torch.from_numpy(mc["count"]).to(dev)
    real = int(mc["count"].sum())
    tq = MAXSIM_QUERY_TOKENS
    queries = torch.from_numpy(mc["queries"][:bsz]).to(dev)
    qmask = torch.ones(bsz, tq, device=dev)
    lanes = torch.arange(t_bucket, device=dev)
    live_tok = lanes[None, :] < count[:, None]          # [Dp, T]
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False

    def library(q, qm, chunk):
        """torch.matmul of the [Dp*T, dims] tokens by the [dims, B*Tq]
        queries, masked amax over the doc tokens, the qmask-weighted
        sum: the yardstick, in doc chunks that fit the card."""
        b = q.shape[0]
        qt = q.reshape(b * tq, dims).t()
        out = []
        for lo in range(0, d_pad, chunk):
            c = min(chunk, d_pad - lo)
            dots = torch.matmul(tokens[lo:lo + c].view(c * t_bucket, dims),
                                qt).view(c, t_bucket, b, tq)
            best = dots.masked_fill(~live_tok[lo:lo + c, :, None, None],
                                    float("-inf")).amax(1)
            best = torch.where(torch.isfinite(best), best, 0.0)
            out.append((best * qm[None]).sum(-1))
        return torch.cat(out).t()

    # K10: bit for bit on the first MAXSIM_SLICE docs at B=4, then the
    # whole corpus at B=1 (with its plain version) and B=32
    sl = slice(0, MAXSIM_SLICE)
    if not k11_only:
        record("maxsim_exact", f"B=4 Dp={MAXSIM_SLICE} T={t_bucket} "
               f"Tq={tq} dims={dims} (slice)",
               lambda: (maxsim.exact_maxsim_scores(
                   tokens[sl], count[sl], queries[:4].contiguous(),
                   qmask[:4].contiguous()),),
               lambda: (maxsim.exact_maxsim_scores_plain(
                   tokens[sl], count[sl], queries[:4].contiguous(),
                   qmask[:4].contiguous()),), None, 0, 0, reps=5)
    for b in () if k11_only else (1, bsz):
        q, qm = queries[:b].contiguous(), qmask[:b].contiguous()
        record("maxsim_exact", f"B={b} Dp={d_pad} T={t_bucket} Tq={tq} "
               f"dims={dims} ({real} real tokens)",
               lambda q=q, qm=qm: (maxsim.exact_maxsim_scores(
                   tokens, count, q, qm),),
               (lambda q=q, qm=qm: (maxsim.exact_maxsim_scores_plain(
                   tokens, count, q, qm),)) if b == 1 else None,
               lambda q=q, qm=qm, b=b: library(q, qm, d_pad if b == 1
                                               else 4096),
               4 * real * dims + 8 * d_pad + 4 * b * tq * (dims + 1)
               + 4 * b * d_pad, 2 * b * tq * real * dims, reps=5)

    # K11: uniform random codes [Dp, T, PQ_M] against the trained codebook
    gen = torch.Generator(device=dev).manual_seed(31)
    codes = torch.randint(0, 256, (d_pad, t_bucket, PQ_M), generator=gen,
                          device=dev, dtype=torch.uint8)
    codebook = torch.from_numpy(codebook_np).to(dev)
    dsub = dims // PQ_M
    if k11_only:
        lut32 = maxsim.pq_lut(codebook, queries)
    else:
        lut32 = record(
            "pq_lut", f"B={bsz} Tq={tq} M={PQ_M} dsub={dsub}",
            lambda: (maxsim.pq_lut(codebook, queries),),
            lambda: (maxsim.pq_lut_plain(codebook, queries),),
            lambda: (torch.einsum("mcj,btmj->btmc", codebook,
                                  queries.view(bsz, tq, PQ_M, dsub)),),
            4 * codebook.numel() + 4 * queries.numel()
            + 4 * bsz * tq * PQ_M * 256,
            2 * bsz * tq * PQ_M * 256 * dsub)[0]
    group = f" G={maxsim.pq_group(PQ_M, tq)}"

    def k11(b, n_docs, n_real, kern, plain, label):
        record("maxsim_pq", f"B={b} Dp={n_docs} T={t_bucket} Tq={tq} "
               f"M={PQ_M}{group} {label}", kern, plain, None,
               n_real * PQ_M + 4 * b * tq * PQ_M * 256 + 4 * n_docs
               + 4 * b * n_docs, b * tq * n_real * PQ_M, reps=5)
        rec = results["maxsim_pq"][-1]
        rec["lookup_floor_ms"] = None if sm_mhz is None else \
            b * tq * n_real * PQ_M / (n_sm * 32 * sm_mhz * 1e6) * 1e3
        if k11_only:
            rec["passes"] = launch_ms(torch, kern, by_name=True)
        log(f"maxsim_pq B={b} {label}: lookup floor "
            f"{rec['lookup_floor_ms']} ms ({b * tq * n_real * PQ_M} "
            f"4-byte shared reads, 32 a cycle on {n_sm} SMs at {sm_mhz} "
            f"MHz), bound {rec['bound_ms']:.4f} ms, kernel "
            f"{rec['ms']:.4f} ms")

    lut4, qm4 = lut32[:4].contiguous(), qmask[:4].contiguous()
    k11(4, MAXSIM_SLICE, int(count[sl].sum().item()),
        lambda: (maxsim.pq_maxsim_from_lut(codes[sl], lut4, count[sl],
                                           qm4),),
        lambda: (maxsim.pq_maxsim_from_lut_plain(codes[sl], lut4, count[sl],
                                                 qm4),), "(slice)")
    for b in (1, bsz):
        lut, qm = lut32[:b].contiguous(), qmask[:b].contiguous()
        k11(b, d_pad, real,
            lambda lut=lut, qm=qm: (maxsim.pq_maxsim_from_lut(
                codes, lut, count, qm),),
            (lambda lut=lut, qm=qm: (maxsim.pq_maxsim_from_lut_plain(
                codes, lut, count, qm),)) if b == 1 else None,
            f"({real} real tokens)")
    if k11_only:
        lut1, qm1 = lut32[:1].contiguous(), qmask[:1].contiguous()
        # the lookups' bank conflicts: with every code byte 0 the lanes of
        # a warp read one table row (a broadcast); B=1, the same work
        zeros = torch.zeros_like(codes)
        k11(1, d_pad, real, lambda: (maxsim.pq_maxsim_from_lut(
            zeros, lut1, count, qm1),), None,
            "(codes all 0: every lookup a broadcast)")
        del zeros
    torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    del tokens, codes, live_tok
    torch.cuda.empty_cache()
    if k11_only:
        return results

    # K12 and K3's threshold at Dp 2^20, B=32
    d = 1 << 20
    live = torch.ones(d, dtype=torch.bool, device=dev)
    ms = torch.full((bsz,), float("-inf"), device=dev)
    scores = torch.rand(bsz, d, generator=gen, device=dev)
    elig = torch.stack([torch.rand(bsz, d, generator=gen, device=dev)
                        < 0.05 * (i + 1) for i in range(2)])
    k = 10
    rows = torch.stack([topk.masked_topk(scores, elig[i], live, live, d, ms,
                                         k) for i in range(2)])
    record("hybrid_window", f"B={bsz} n_sub=2 Dp={d} k={k}",
           lambda: (hybrid.hybrid_window(rows, elig, k),),
           lambda: (hybrid.hybrid_window_plain(rows, elig, k),), None,
           2 * bsz * d + 4 * rows.numel() + 4 * bsz * (2 * (2 * k + 4) + 1),
           2 * bsz * (3 * k + d))
    del scores, elig, rows
    threshold_record(torch, results, bsz, dev, gen)
    torch.cuda.empty_cache()
    return results


def _maxsim_oracle(torch, np, image, queries, dims: int, k: int = 10):
    """f64 MaxSim scores of `queries` over the image's real tokens (f64
    matmuls over doc chunks on the card) and each query's top k."""
    tokens, count = image["tokens"], image["token_count"]
    d_pad, t_bucket, _ = tokens.shape
    q = torch.from_numpy(queries).to(tokens.device).double()
    nq, tq, _ = q.shape
    qt = q.reshape(nq * tq, dims).t()
    lanes = torch.arange(t_bucket, device=tokens.device)
    out = []
    for lo in range(0, d_pad, 2048):
        c = min(2048, d_pad - lo)
        dots = torch.matmul(tokens[lo:lo + c].double().view(c * t_bucket,
                                                            dims),
                            qt).view(c, t_bucket, nq, tq)
        real = lanes[None, :] < count[lo:lo + c, None]
        best = dots.masked_fill(~real[:, :, None, None],
                                float("-inf")).amax(1)
        best = torch.where(torch.isfinite(best), best, 0.0)
        out.append(best.sum(-1))
    scores = torch.cat(out).t()                   # [nq, Dp] f64
    has = (count > 0)[None, :]
    scores = torch.where(has, scores, float("-inf"))
    top = torch.topk(scores, k, dim=1)
    return scores.cpu().numpy(), top.indices.cpu().numpy()


def phase_maxsim_cell(torch, np, mc, dev, card: str, out_dir=None,
                      bsz: int = 32, singles: int = 200):
    """The MaxSim cell served through SearchExecutor: 100,000 passages in
    one segment, 640 queries at k=10, B=1 `_search` and B=32 `_msearch`
    walls, queries/s, image bytes, busy share, recall@10 against the f64
    oracle, two pages against the plain versions on the card."""
    from opensearch_tpu_torch.ops import _build, maxsim, topk
    from opensearch_tpu_torch.search.executor import (SearchExecutor,
                                                      ShardReader)
    from opensearch_tpu_torch.utils.demo import rank_vectors_segment
    n, t_bucket, dims = mc["tokens"].shape
    mapper, seg = rank_vectors_segment(mc["tokens"], mc["count"],
                                       max_tokens=MAXSIM_SHAPE[1],
                                       seg_id="colbert0")
    reader = ShardReader(mapper, dev, index_name="colbert_synth")
    t0 = time.perf_counter()
    reader.add_segment(seg)
    torch.cuda.synchronize()
    out = {"image_bytes": reader.device_bytes()}
    log(f"maxsim: image of {n} x {t_bucket} x {dims} uploaded in "
        f"{time.perf_counter() - t0:.3f} s: {out['image_bytes']} bytes "
        f"(Dp={reader.device[0][1].d_pad})")
    ex = SearchExecutor(reader)
    queries = mc["queries"]
    bodies = [{"query": {"maxsim": {"tok": {"query_vectors": q.tolist(),
                                            "k": 10}}}, "size": 10}
              for q in queries]
    ex.search(bodies[0])
    ex.multi_search(bodies[:bsz])
    torch.cuda.synchronize()
    _build.reset_launches()
    single = []
    for b in bodies[:singles]:
        t = time.perf_counter()
        ex.search(b)
        single.append((time.perf_counter() - t) * 1e3)
    batches, pages = [], []
    for lo in range(0, len(bodies), bsz):
        t = time.perf_counter()
        resp = ex.multi_search(bodies[lo:lo + bsz])
        batches.append((time.perf_counter() - t) * 1e3)
        pages += [[int(h["_id"][1:]) for h in r["hits"]["hits"]]
                  for r in resp["responses"]]
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    log(f"maxsim: launches {json.dumps(launches)}")
    _require_launched(launches, ("maxsim_exact", "masked_topk",
                                 "knn_topk_mark"), "MaxSim")

    def pct(xs, p):
        return float(np.percentile(np.asarray(xs), p))
    out.update({"search_p50_ms": pct(single, 50),
                "search_p99_ms": pct(single, 99),
                "msearch32_p50_ms": pct(batches, 50),
                "msearch32_p99_ms": pct(batches, 99),
                "msearch32_qps": bsz * 1e3 / pct(batches, 50)})
    log(f"maxsim: B=1 _search wall ms p50 {out['search_p50_ms']:.3f} p99 "
        f"{out['search_p99_ms']:.3f} over {len(single)}; B={bsz} _msearch "
        f"wall ms p50 {out['msearch32_p50_ms']:.3f} p99 "
        f"{out['msearch32_p99_ms']:.3f} over {len(batches)} batches "
        f"({out['msearch32_qps']:.1f} queries/s at p50); card: {card}")
    out.update(profile_waves(torch, ex, bodies[:6 * bsz], out_dir,
                             "maxsim"))
    # recall@10 against the f64 oracle; a page doc outside the oracle's
    # top 10 is an f32 tie (listed) when its f64 score lies within the
    # f32 bound of the 10th's: unit tokens and queries put each dot within
    # dims * 2^-24 of its f64 value, each score within Tq * (dims + 1) *
    # 2^-24
    image = reader.device[0][0]["rank_vectors"]["tok"]
    t0 = time.perf_counter()
    oq = MAXSIM_ORACLE_QUERIES
    f64, top = _maxsim_oracle(torch, np, image, queries[:oq], dims)
    bound = MAXSIM_QUERY_TOKENS * (dims + 1) * F32_SUM_EPS
    hits, ties = 0, []
    for r in range(oq):
        want = set(top[r].tolist())
        hits += len(want & set(pages[r]))
        kth = float(f64[r][top[r][-1]])
        for i in set(pages[r]) - want:
            if kth - f64[r][i] <= 2 * bound:
                ties.append((r, i, float(kth - f64[r][i])))
            else:
                raise AssertionError(f"maxsim query {r}: doc {i} is not "
                                     f"among the f64 top 10 and no f32 tie")
    out["recall_at_10"] = hits / (10 * oq)
    out["f32_ties"] = ties
    log(f"maxsim: recall@10 {out['recall_at_10']} against the f64 oracle "
        f"over {oq} queries ({time.perf_counter() - t0:.3f} s); f32 ties "
        f"{ties}")
    if out["recall_at_10"] + len(ties) / (10 * oq) < 1.0:
        raise AssertionError("maxsim recall@10 below 1.0")
    # two pages against the plain versions on the same image
    live = reader.device[0][0]["live"]
    d_pad = live.shape[0]
    for r in range(2):
        q = torch.from_numpy(queries[r:r + 1]).to(dev)
        s = maxsim.exact_maxsim_scores_plain(
            image["tokens"], image["token_count"], q,
            torch.ones(1, q.shape[1], device=dev))
        elig = (image["exists"] & live)[None, :].contiguous()
        packed = topk.masked_topk_plain(
            s, elig, live, live, d_pad,
            torch.full((1,), float("-inf"), device=dev), 10)
        want_s, want_i, _t = topk.unpack_rows(packed.cpu().numpy(), 10)
        got = ex.search(bodies[r])["hits"]["hits"]
        if [h["_id"] for h in got] != [f"d{i}" for i in want_i[0]] or \
                [h["_score"] for h in got] != want_s[0].tolist():
            raise AssertionError(f"maxsim page {r} differs from the plain "
                                 f"versions'")
    log("maxsim: 2 sampled pages equal the plain versions'")
    del reader, ex, image
    torch.cuda.empty_cache()
    return out


def hybrid_vectors(torch, n: int, dims: int, n_queries: int, dev,
                   seed: int = 13):
    """The hybrid cell's embeddings: clustered vectors (256 centers, scale
    4, unit noise, as clustered_vectors draws them) made on the card from
    a seeded generator; f32 numpy [n, dims] and [n_queries, dims]."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    centers = torch.randn(256, dims, generator=gen, device=dev) * 4
    vecs = torch.empty(n, dims, device=dev)
    for lo in range(0, n, 1 << 17):
        c = min(1 << 17, n - lo)
        vecs[lo:lo + c] = centers[torch.randint(
            0, 256, (c,), generator=gen, device=dev)] + torch.randn(
            c, dims, generator=gen, device=dev)
    queries = centers[torch.randint(0, 256, (n_queries,), generator=gen,
                                    device=dev)] + torch.randn(
        n_queries, dims, generator=gen, device=dev)
    return vecs.cpu().numpy(), queries.cpu().numpy()


def phase_hybrid_cell(torch, np, mapper, seg, terms, dev, card: str,
                      out_dir=None, bsz: int = 32, singles: int = 200):
    """The hybrid cell through Node().request: phase 4's passages plus a
    768-d l2 embedding, `hybrid` bodies of a match and a knn (k 100). B=1
    REST `_search` under the documented normalization pipeline and B=32
    `_msearch` (the batched hybrid wave); walls, queries/s, busy share,
    image bytes, two pages against the plain versions."""
    from opensearch_tpu_torch.node import Node
    from opensearch_tpu_torch.ops import _build
    from opensearch_tpu_torch.search.executor import (SearchExecutor,
                                                      ShardReader)
    from opensearch_tpu_torch.searchpipeline.hybrid import \
        execute_hybrid_search
    from opensearch_tpu_torch.utils.demo import (add_vector_field,
                                                 fast_query_terms)
    parity = _parity()
    t0 = time.perf_counter()
    vecs, qvecs = hybrid_vectors(torch, seg.num_docs, HYBRID_DIMS,
                                 HYBRID_QUERIES, dev)
    add_vector_field(mapper, seg, vecs, "emb", "l2")
    log(f"hybrid: {seg.num_docs} x {HYBRID_DIMS} embeddings made in "
        f"{time.perf_counter() - t0:.3f} s")
    node = Node()
    assert node.request("PUT", "/_search/pipeline/norm",
                        parity.HYB_PIPELINE)["_status"] == 200
    assert node.request("PUT", "/msmarco", {"mappings": {"properties": {
        "body": {"type": "text"},
        "emb": {"type": "knn_vector", "dimension": HYBRID_DIMS,
                "method": {"space_type": "l2"}}}}})["_status"] == 200
    shard = node.indices.get("msmarco").shards[0]
    t0 = time.perf_counter()
    shard.reader.add_segment(seg)
    torch.cuda.synchronize()
    out = {"image_bytes": shard.reader.device_bytes()}
    log(f"hybrid: image uploaded in {time.perf_counter() - t0:.3f} s: "
        f"{out['image_bytes']} bytes")
    texts = []
    for n in (2, 3, 4):
        texts += fast_query_terms(HYBRID_QUERIES // 3 + 1, terms,
                                  seed=700 + n, terms_per_query=n)
    bodies = [{"query": {"hybrid": {"queries": [
        {"match": {"body": t}},
        {"knn": {"emb": {"vector": v.tolist(), "k": 100}}}]}}, "size": 10}
        for t, v in zip(texts, qvecs)]

    def msearch(chunk):
        lines = []
        for b in chunk:
            lines += [{"index": "msmarco"}, b]
        return node.request("POST", "/_msearch", lines)
    node.request("POST", "/msmarco/_search", bodies[0],
                 search_pipeline="norm")
    msearch(bodies[:bsz])
    torch.cuda.synchronize()
    _build.reset_launches()
    single = []
    for b in bodies[:singles]:
        t = time.perf_counter()
        r = node.request("POST", "/msmarco/_search", b,
                         search_pipeline="norm")
        single.append((time.perf_counter() - t) * 1e3)
        if r["_status"] != 200:
            raise AssertionError(f"hybrid _search: {r}")
    batches = []
    for lo in range(0, len(bodies) - bsz + 1, bsz):
        t = time.perf_counter()
        r = msearch(bodies[lo:lo + bsz])
        batches.append((time.perf_counter() - t) * 1e3)
        if any(x["status"] != 200 for x in r["responses"]):
            raise AssertionError(f"hybrid _msearch: {r['responses'][0]}")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    log(f"hybrid: launches {json.dumps(launches)}")
    _require_launched(launches, ("knn_exact", "knn_topk_mark", "masked_topk",
                                 "hybrid_window"), "hybrid")
    if not launches["bm25_candidate"] + launches["score_text_clause"]:
        raise AssertionError("hybrid: no BM25 kernel launched")

    def pct(xs, p):
        return float(np.percentile(np.asarray(xs), p))
    out.update({"search_p50_ms": pct(single, 50),
                "search_p99_ms": pct(single, 99),
                "msearch32_p50_ms": pct(batches, 50),
                "msearch32_p99_ms": pct(batches, 99),
                "msearch32_qps": bsz * 1e3 / pct(batches, 50)})
    log(f"hybrid: B=1 _search wall ms p50 {out['search_p50_ms']:.3f} p99 "
        f"{out['search_p99_ms']:.3f} over {len(single)}; B={bsz} _msearch "
        f"wall ms p50 {out['msearch32_p50_ms']:.3f} p99 "
        f"{out['msearch32_p99_ms']:.3f} over {len(batches)} batches "
        f"({out['msearch32_qps']:.1f} queries/s at p50); card: {card}")
    out.update(profile_waves(torch, shard.executor, bodies[:6 * bsz],
                             out_dir, "hybrid"))
    # two pages, under the pipeline's spec, against the plain versions
    cpu_reader = ShardReader(shard.reader.mapper, "cpu",
                             index_name="msmarco")
    cpu_reader.add_segment(seg)
    cpu_ex = SearchExecutor(cpu_reader)
    spec = node.search_pipelines.get("norm").phase_spec()
    for b in bodies[:2]:
        got = node.request("POST", "/msmarco/_search", b,
                           search_pipeline="norm")
        got.pop("_status")
        parity.assert_same_response(got, execute_hybrid_search(
            [cpu_ex], b, spec), "hybrid")
    log("hybrid: 2 sampled pages equal the plain versions'")
    del cpu_reader, cpu_ex, node, shard
    seg.vector_dv.pop("emb")
    torch.cuda.empty_cache()
    return out


def _pct(np, xs, p) -> float:
    return float(np.percentile(np.asarray(xs), p))


def sorted_bodies(np, seg):
    """The sorted cell's bodies, after the rally tracks: http_logs'
    desc_sort_timestamp, asc_sort_timestamp and
    desc_sort_with_after_timestamp (the cursor at the 20,000th hit), a
    nyc_taxis-shaped range filter on views sorted on views desc, and a
    keyword multi-key sort with docvalue_fields and track_total_hits."""
    ts = seg.numeric_dv["ts"].values
    cursor = int(np.sort(ts)[::-1][SORTED_CURSOR_HIT - 1])
    return {
        "desc_sort_timestamp": {"query": {"match_all": {}},
                                "sort": [{"ts": "desc"}], "size": 10},
        "asc_sort_timestamp": {"query": {"match_all": {}},
                               "sort": [{"ts": "asc"}], "size": 10},
        "desc_sort_with_after_timestamp": {
            "query": {"match_all": {}}, "sort": [{"ts": "desc"}],
            "size": 10, "search_after": [cursor]},
        "desc_sort_views_filtered": {
            "query": {"bool": {"filter": [{"range": {"views": {
                "gte": 2000, "lte": 8000}}}]}},
            "sort": [{"views": "desc"}], "size": 10},
        "keyword_multi_sort": {
            "sort": [{"tag": "asc"}, {"ts": "desc"}], "size": 10,
            "docvalue_fields": ["tag", "ts", "views"],
            "track_total_hits": 10000},
    }


def _sorted_oracle(np, seg, name, body, resp):
    """The f64 numpy answer of the ts and views bodies over the whole
    segment: ids, sort values and totals."""
    ts = seg.numeric_dv["ts"].values
    views = seg.numeric_dv["views"].values
    idx = np.arange(seg.num_docs)
    if name == "desc_sort_views_filtered":
        keep = (views >= 2000) & (views <= 8000)
        order = np.lexsort((idx[keep], -views[keep]))[:10]
        ids, vals = idx[keep][order], views[keep][order]
        total = int(keep.sum())
    elif name.startswith(("desc_sort", "asc_sort")):
        sign = -1 if name.startswith("desc") else 1
        order = np.lexsort((idx, sign * ts))
        if "search_after" in body:
            after = body["search_after"][0]
            order = order[ts[order] < after][:10]
        ids, vals = idx[order[:10]], ts[order[:10]]
        total = seg.num_docs
    else:
        return False
    hits = resp["hits"]["hits"]
    if [h["_id"] for h in hits] != [f"d{i}" for i in ids] \
            or [h["sort"][0] for h in hits] != [int(v) for v in vals] \
            or resp["hits"]["total"]["value"] != total:
        raise AssertionError(f"sorted cell {name}: the page differs from "
                             f"the f64 oracle")
    return True


def phase_sorted_cell(torch, np, mapper, seg, four, card: str,
                      out_dir=None, singles: int = SORTED_SINGLES,
                      deep_singles: int = SORTED_DEEP_SINGLES,
                      bsz: int = 32):
    """The sorted cell through Node().request: the 10M-doc structured
    segment as one index and the same docs in four segments as another
    (and on a result-page node). B=1 `_search` of each body on both
    indices (p50 / p99), the views body on the result-page node, then
    B=32 `_msearch` of sorted bodies; busy share, the host split (query
    phase, reduce, fetch), per body and index the multi-shard program's
    requests and K21's launches and (rows, k) shapes, pages against the
    f64 oracle and the single-segment pages against the four-segment
    ones."""
    from opensearch_tpu_torch.node import Node
    from opensearch_tpu_torch.ops import _build
    from opensearch_tpu_torch.parallel import distributed
    from opensearch_tpu_torch.search import controller, spmd
    from opensearch_tpu_torch.utils.demo import STRUCTURED_MAPPING
    parity = _parity()
    node = Node()
    page_node = Node(settings={"search.result_page.enabled": True})
    t0 = time.perf_counter()
    out = {}
    for n, name, segs in ((node, "logs_one", [seg]),
                          (node, "logs_four", four),
                          (page_node, "logs_four", four)):
        assert n.request("PUT", f"/{name}", {
            "mappings": STRUCTURED_MAPPING})["_status"] == 200
        reader = n.indices.get(name).shards[0].reader
        for sg in segs:
            reader.add_segment(sg)
        out[f"{name}_image_bytes"] = reader.device_bytes()
    torch.cuda.synchronize()
    log(f"sorted: three images uploaded in {time.perf_counter() - t0:.3f} "
        f"s: {json.dumps(out)}")
    bodies = sorted_bodies(np, seg)

    # the host split: the query phase (the shard's, or the four-segment
    # index's multi-shard program: device work, the one copy, the host
    # decode), the fetch phase, and the rest (merge, cursor, render) as
    # reduce
    split = {"query": 0.0, "fetch": 0.0}
    real_build_hit = controller._build_hit
    real_spmd = spmd.spmd_query_phase

    def timed_spmd(*a, **kw):
        t = time.perf_counter()
        try:
            return real_spmd(*a, **kw)
        finally:
            split["query"] += (time.perf_counter() - t) * 1e3
    spmd.spmd_query_phase = timed_spmd

    def timed_build_hit(*a, **kw):
        t = time.perf_counter()
        try:
            return real_build_hit(*a, **kw)
        finally:
            split["fetch"] += (time.perf_counter() - t) * 1e3
    controller._build_hit = timed_build_hit
    for n in (node, page_node):
        for name in ("logs_one", "logs_four"):
            if name not in n.indices.indices:
                continue
            ex = n.indices.get(name).shards[0].executor
            real_qp = ex.execute_query_phase

            def timed_qp(body, k, real_qp=real_qp, **kw):
                t = time.perf_counter()
                try:
                    return real_qp(body, k, **kw)
                finally:
                    split["query"] += (time.perf_counter() - t) * 1e3
            ex.execute_query_phase = timed_qp

    def search(n, index, body):
        return n.request("POST", f"/{index}/_search", body)

    # K21's shapes: (rows, k) of every row_merge call of the multi-shard
    # program (a request's k-growth steps each call it)
    merges = []
    real_row_merge = distributed.row_merge

    def counted_row_merge(buf, ks, pruned, k):
        merges.append((len(ks), k))
        return real_row_merge(buf, ks, pruned, k)
    distributed.row_merge = counted_row_merge

    try:
        for name, body in bodies.items():      # warm; the filter cache fills
            for index in ("logs_one", "logs_four"):
                for _ in range(1 if "search_after" in body else 2):
                    search(node, index, body)
        torch.cuda.synchronize()
        _build.reset_launches()
        answers, cell = {}, {}
        for name, body in bodies.items():
            reps = deep_singles if "search_after" in body else singles
            for index in ("logs_one", "logs_four"):
                walls = []
                split["query"] = split["fetch"] = 0.0
                n_spmd, n_k21 = spmd.SPMD_QUERIES[0], _build.LAUNCHES[
                    "row_merge"]
                del merges[:]
                for _ in range(reps):
                    t = time.perf_counter()
                    resp = search(node, index, body)
                    walls.append((time.perf_counter() - t) * 1e3)
                if resp["_status"] != 200:
                    raise AssertionError(f"sorted {name} {index}: {resp}")
                answers[(name, index)] = resp
                total_ms = sum(walls)
                rec = {"search_p50_ms": _pct(np, walls, 50),
                       "search_p99_ms": _pct(np, walls, 99),
                       "requests": reps,
                       "query_phase_ms": split["query"] / reps,
                       "fetch_ms": split["fetch"] / reps,
                       "reduce_ms": (total_ms - split["query"]
                                     - split["fetch"]) / reps,
                       "spmd_queries": spmd.SPMD_QUERIES[0] - n_spmd,
                       "row_merge_launches":
                           _build.LAUNCHES["row_merge"] - n_k21,
                       "row_merge_shapes": [f"R={r} k={k}" for r, k in
                                            sorted(set(merges))]}
                cell[f"{name}/{index}"] = rec
                log(f"sorted {name} on {index}: " + json.dumps(rec))
        # the views body on the four segments takes the multi-shard
        # program (one layout, an f32-sortable column); on the result-page
        # node its host loop (pinned) merges on the device (K14): pages
        # equal the gate-off node's
        vb = bodies["desc_sort_views_filtered"]
        n0 = spmd.SPMD_QUERIES[0]
        search(node, "logs_four", vb)
        if spmd.SPMD_QUERIES[0] != n0 + 1:
            raise AssertionError("sorted: the four-segment views body did "
                                 "not take the multi-shard program")
        with spmd.force_host_loop():
            for _ in range(2):
                search(page_node, "logs_four", vb)
            walls = []
            for _ in range(singles):
                t = time.perf_counter()
                resp = search(page_node, "logs_four", vb)
                walls.append((time.perf_counter() - t) * 1e3)
        parity.assert_same_response(resp, answers[(
            "desc_sort_views_filtered", "logs_four")], "result page")
        cell["desc_sort_views_filtered/logs_four/result_page"] = {
            "search_p50_ms": _pct(np, walls, 50),
            "search_p99_ms": _pct(np, walls, 99), "requests": singles}
        log("sorted views body on the result-page node: " + json.dumps(
            cell["desc_sort_views_filtered/logs_four/result_page"]))
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    finally:
        controller._build_hit = real_build_hit
        spmd.spmd_query_phase = real_spmd
        distributed.row_merge = real_row_merge
    from opensearch_tpu_torch.indices.query_cache import QUERY_CACHE
    log(f"sorted: launches {json.dumps(launches)}; filter cache "
        f"{json.dumps(QUERY_CACHE.stats())}")
    # the views filter is served from the filter cache after the warm-up,
    # so K4 need not run in this window
    _require_launched(launches, ("sort_key", "masked_topk_keyed",
                                 "page_merge"), "sorted cell")
    out["cell"] = cell
    out["launches"] = launches

    # pages: the f64 oracle, and the single-segment index against the
    # four-segment one (the keyword body's pages agree on the primary key
    # only: the host orders each segment's k + 128 winners by tag, and the
    # secondary ts order sees a different window in each layout)
    checked = 0
    for name, body in bodies.items():
        one, four_resp = answers[(name, "logs_one")], \
            answers[(name, "logs_four")]
        for resp in (one, four_resp):
            checked += _sorted_oracle(np, seg, name, body, resp)
        h1, h4 = one["hits"]["hits"], four_resp["hits"]["hits"]
        if name == "keyword_multi_sort":
            same = [h["sort"][0] for h in h1] == [h["sort"][0] for h in h4]
        else:
            same = [(h["_id"], h["sort"]) for h in h1] == \
                [(h["_id"], h["sort"]) for h in h4]
        if not same or one["hits"]["total"] != four_resp["hits"]["total"]:
            raise AssertionError(f"sorted {name}: the one- and four-segment "
                                 f"pages differ")
    log(f"sorted: {checked} pages equal the f64 oracle; the one- and "
        f"four-segment pages agree")

    # B=32 _msearch of sorted bodies, served item by item
    rng = np.random.RandomState(23)
    msearch_bodies = []
    for i in range(6 * bsz):
        lo = int(rng.randint(0, 9000))
        msearch_bodies.append({
            "query": {"bool": {"filter": [{"range": {"views": {
                "gte": lo, "lt": lo + 1000}}}]}},
            "sort": [{"ts": "desc"} if i % 2 else {"views": "asc"}],
            "size": 10})
    ex = node.indices.get("logs_one").shards[0].executor
    ex.multi_search(msearch_bodies[:bsz])
    batches = []
    for i in range(6):
        payload = parity.msearch_ndjson(
            "logs_one", msearch_bodies[i * bsz:(i + 1) * bsz])
        t = time.perf_counter()
        resp = node.request("POST", "/_msearch", payload)
        batches.append((time.perf_counter() - t) * 1e3)
        if any(r.get("status") != 200 for r in resp["responses"]):
            raise AssertionError(f"sorted msearch: {resp}")
    out["msearch32_p50_ms"] = _pct(np, batches, 50)
    out["msearch32_p99_ms"] = _pct(np, batches, 99)
    out["msearch32_qps"] = bsz * 1e3 / out["msearch32_p50_ms"]
    out.update(profile_waves(torch, ex, msearch_bodies, out_dir, "sorted"))
    log(f"sorted: B={bsz} _msearch wall ms p50 "
        f"{out['msearch32_p50_ms']:.3f} p99 {out['msearch32_p99_ms']:.3f} "
        f"({out['msearch32_qps']:.1f} queries/s at p50); card: {card}")
    del node, page_node
    torch.cuda.empty_cache()
    return out


def aggkind_families(np, n: int):
    """The agg-kinds cell's body families, n bodies each over distinct ts
    spans (aggkind_queries), after the big5 / nyc_taxis operations named
    beside each."""
    from opensearch_tpu_torch.utils.demo import BASE_TS as base
    queries = aggkind_queries(np, n)
    day0 = (base // DAY_MS) * DAY_MS
    fams = {
        # big5 range-agg-1: five ranges of one numeric field
        "range": {"r": {"range": {"field": "fare", "ranges": [
            {"to": 500}, {"from": 500, "to": 1000}, {"from": 1000,
                                                     "to": 2000},
            {"from": 2000, "to": 5000}, {"from": 5000}]}}},
        # big5 composite-terms / composite-date_histogram-daily: tag x day,
        # 100 buckets a page; the odd bodies page on from a fixed key
        "composite": {"c": {"composite": {"size": 100, "sources": [
            {"tag": {"terms": {"field": "tag"}}},
            {"day": {"date_histogram": {"field": "ts",
                                        "calendar_interval": "1d"}}}]}}},
        # big5 multi_terms-keyword
        "multi_terms": {"m": {"multi_terms": {"terms": [
            {"field": "tag"}, {"field": "passengers"}]}}},
        # nyc_taxis autohisto_agg
        "autohisto": {"a": {"auto_date_histogram": {"field": "ts",
                                                    "buckets": 20}}},
        # big5 range-auto-date-histo-with-metrics
        "autohisto_avg": {"a": {"auto_date_histogram": {
            "field": "ts", "buckets": 20},
            "aggs": {"f": {"avg": {"field": "fare"}}}}},
        "percentiles": {"p": {"percentiles": {"field": "fare"}}},
        "weighted_avg": {"w": {"weighted_avg": {
            "value": {"field": "fare"}, "weight": {"field": "passengers"}}}},
        "matrix_stats": {"ms": {"matrix_stats": {"fields": ["fare",
                                                            "views"]}}},
        "adjacency": {"adj": {"adjacency_matrix": {"filters": {
            "a": {"term": {"passengers": 1}},
            "b": {"range": {"fare": {"gte": 2000}}},
            "c": {"terms": {"passengers": [5, 6]}},
            "d": {"range": {"views": {"lt": 2500}}}}}}},
        "filters_missing_global": {
            "f": {"filters": {"filters": {
                "short": {"range": {"fare": {"lt": 800}}},
                "group": {"range": {"passengers": {"gte": 4}}}}}},
            "nf": {"missing": {"field": "fare"}}, "g": {"global": {}}},
        "date_hist_pipelines": {
            "h": {"date_histogram": {"field": "ts", "fixed_interval": "1d"},
                  "aggs": {"p": {"sum": {"field": "passengers"}},
                           "d": {"derivative": {"buckets_path": "p"}}}},
            "mb": {"max_bucket": {"buckets_path": "h>p"}}},
    }
    out = {}
    for fam, aggs in fams.items():
        bodies = []
        for i, q in enumerate(queries):
            a = json.loads(json.dumps(aggs))
            if fam == "composite" and i % 2:
                a["c"]["composite"]["after"] = {"tag": "cat3",
                                                "day": day0 + 10 * DAY_MS}
            bodies.append({"size": 0, "query": q, "aggs": a})
        out[fam] = bodies
    return out


def k6_sum_rel(lanes: int) -> float:
    """The bound, as a share of sum|term|, of a K6 sum over a bin of at
    most `lanes` lanes where both passes fold by warp (a bin of many full
    chunks): the additions on a term's path are a thread's every 32nd lane
    of its CSR_CHUNK-lane chunk, 5 shuffle levels, a thread's every 32nd
    chunk of the bin and 5 levels."""
    from opensearch_tpu_torch.ops.binned import CSR_CHUNK
    chunks = -(-lanes // CSR_CHUNK)
    return (CSR_CHUNK // 32 + 5 + -(-chunks // 32) + 5) * F32_SUM_EPS


def aggkind_oracle(np, n_docs: int, d_pad: int):
    """The f64 numpy oracle of the agg-kinds cell, from the columns the
    segment was built from: counts, keys and orders exactly, percentiles
    exactly (the same interpolation over the exact value counts), each
    sum behind a float within the additions on a term's path in its
    kernel (K6: k6_sum_rel; K16: agg_kernels.moments_sum_depth, plus 3
    for the f32 powers) times 2^-24 * sum|term| of the f64 sum, and
    every value derived from such sums (avg, weighted_avg, matrix_stats'
    mean, variance, skewness, kurtosis, covariance, correlation) within
    that error carried through its formula (test_torch_common's
    matrix_stats_tol). Dp = d_pad bounds a bin's lanes and chunks."""
    import datetime as dt
    from opensearch_tpu_torch.ops import agg_kernels
    from opensearch_tpu_torch.utils.demo import N_TAGS, taxi_columns
    parity = _parity()
    tag, views, ts, fare, pas = taxi_columns(n_docs, seed=42)
    names = np.array([f"cat{i}" for i in range(N_TAGS)])
    has = ~np.isnan(fare)
    # every bin of these families holds at most Dp lanes: K6's sums of
    # fare pairs, and K16's root bin of Dp docs (pass 2 by block)
    k6_rel = k6_sum_rel(d_pad)
    chunks = -(-d_pad // agg_kernels.MOMENTS_CHUNK)
    k16_rel = (agg_kernels.moments_sum_depth(
        agg_kernels.MOMENTS_CHUNK, chunks,
        chunks > agg_kernels.MOMENTS_BLOCK_CHUNKS) + 3) * F32_SUM_EPS

    def fmt(ms):
        return dt.datetime.fromtimestamp(ms / 1000, tz=dt.timezone.utc) \
            .strftime("%Y-%m-%dT%H:%M:%S.") + f"{ms % 1000:03d}Z"

    def near(got, want, bound, what):
        if got is None or abs(got - want) > bound:
            raise AssertionError(f"{what}: {got} vs f64 {want} (bound "
                                 f"{bound})")

    def pctl(sorted_v, q):
        n = len(sorted_v)
        pos = (q / 100.0) * (n - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, n - 1)
        lo_v, hi_v = float(sorted_v[lo]), float(sorted_v[hi])
        return lo_v + (hi_v - lo_v) * (pos - lo)

    def hist(keys_of, sel, step):
        """(key, count) of a histogram over the selected docs, from the
        first to the last non-empty bucket."""
        k, c = np.unique(keys_of[sel], return_counts=True)
        if not len(k):
            return []
        got = dict(zip(k.tolist(), c.tolist()))
        return [(int(x), got.get(int(x), 0))
                for x in range(int(k[0]), int(k[-1]) + 1, step)]

    def check(fam, body, resp, what):
        lt = body["query"]["range"]["ts"]["lt"]
        m = ts < lt
        if resp["hits"]["total"]["value"] != int(m.sum()):
            raise AssertionError(f"{what}: hits.total differs")
        aggs = resp["aggregations"]
        mf = m & has
        if fam == "range":
            for b, r in zip(aggs["r"]["buckets"],
                            body["aggs"]["r"]["range"]["ranges"]):
                sel = mf.copy()
                if "from" in r:
                    sel &= fare >= r["from"]
                if "to" in r:
                    sel &= fare < r["to"]
                if b["doc_count"] != int(sel.sum()):
                    raise AssertionError(f"{what}: range {r} count differs")
        elif fam == "composite":
            code = tag[m].astype(np.int64) * (1 << 20) + ts[m] // DAY_MS
            u, c = np.unique(code, return_counts=True)
            rows = sorted(((str(names[x >> 20]),
                            int(x & ((1 << 20) - 1)) * DAY_MS, int(n))
                           for x, n in zip(u, c)),
                          key=lambda r: (r[0], r[1]))
            after = body["aggs"]["c"]["composite"].get("after")
            if after is not None:
                rows = [r for r in rows
                        if (r[0], r[1]) > (after["tag"], after["day"])]
            want = [{"key": {"tag": t, "day": d}, "doc_count": n}
                    for t, d, n in rows[:100]]
            if aggs["c"]["buckets"] != want or (
                    want and aggs["c"]["after_key"] != want[-1]["key"]):
                raise AssertionError(f"{what}: composite page differs")
        elif fam == "multi_terms":
            code = tag[m].astype(np.int64) * 8 + pas[m]
            u, c = np.unique(code, return_counts=True)
            rows = sorted(((int(n), str(names[x // 8]), int(x % 8))
                           for x, n in zip(u, c)),
                          key=lambda r: (-r[0], r[1], r[2]))
            want = [{"key": [t, p], "key_as_string": f"{t}|{p}",
                     "doc_count": n} for n, t, p in rows[:10]]
            got = aggs["m"]
            if got["buckets"] != want or got["sum_other_doc_count"] != \
                    sum(r[0] for r in rows[10:]):
                raise AssertionError(f"{what}: multi_terms differs")
        elif fam in ("autohisto", "autohisto_avg"):
            step = 7 * DAY_MS
            wk = (ts // step) * step
            exp = hist(wk, m, step)
            got = aggs["a"]
            if got["interval"] != "7d" or [(b["key"], b["doc_count"])
                                           for b in got["buckets"]] != exp:
                raise AssertionError(f"{what}: auto_date_histogram differs")
            if fam == "autohisto_avg":
                for b in got["buckets"]:
                    sel = mf & (wk == b["key"])
                    n = int(sel.sum())
                    s = float(fare[sel].sum())
                    if n == 0:
                        if b["f"]["value"] is not None:
                            raise AssertionError(f"{what}: empty avg")
                        continue
                    near(b["f"]["value"], s / n, k6_rel * s / n,
                         f"{what}: avg fare of {b['key']}")
        elif fam == "percentiles":
            v = np.sort(fare[mf])
            for q, got in aggs["p"]["values"].items():
                if got != pctl(v, float(q)):
                    raise AssertionError(f"{what}: percentile {q} differs")
        elif fam == "weighted_avg":
            wv = float((fare[mf] * pas[mf]).sum())
            w = float(pas[mf].sum())
            # both sums (terms >= 0) within k6_rel: the ratio within
            # about twice that
            near(aggs["w"]["value"], wv / w, 2.0001 * k6_rel * wv / w,
                 f"{what}: weighted_avg")
        elif fam == "matrix_stats":
            want = matrix_stats_f64(np, {"fare": fare, "views": views},
                                    {"fare": mf, "views": m})
            parity.assert_same_response(
                aggs["ms"], want, what,
                agg_sum_tol=parity.matrix_stats_tol(want, what,
                                                    sum_rel=k16_rel))
        elif fam == "adjacency":
            fl = {"a": pas == 1, "b": has & (fare >= 2000),
                  "c": (pas == 5) | (pas == 6), "d": views < 2500}
            want = []
            keys = sorted(fl)
            for i, a in enumerate(keys):
                for b in keys[i:]:
                    n = int((m & fl[a] & fl[b]).sum())
                    if n:
                        want.append((a if a == b else f"{a}&{b}", n))
            want.sort()
            if [(b["key"], b["doc_count"]) for b in aggs["adj"]["buckets"]] \
                    != want:
                raise AssertionError(f"{what}: adjacency_matrix differs")
        elif fam == "filters_missing_global":
            fb = aggs["f"]["buckets"]
            if fb["short"]["doc_count"] != int((mf & (fare < 800)).sum()) \
                    or fb["group"]["doc_count"] != int((m & (pas >= 4))
                                                        .sum()) \
                    or aggs["nf"]["doc_count"] != int((m & ~has).sum()) \
                    or aggs["g"]["doc_count"] != n_docs:
                raise AssertionError(f"{what}: filters / missing / global")
        elif fam == "date_hist_pipelines":
            day = (ts // DAY_MS) * DAY_MS
            exp = hist(day, m, DAY_MS)
            got = aggs["h"]["buckets"]
            if [(b["key"], b["doc_count"], b["key_as_string"])
                    for b in got] != [(k, c, fmt(k)) for k, c in exp]:
                raise AssertionError(f"{what}: date_histogram differs")
            sums = np.bincount(((ts[m] - exp[0][0]) // DAY_MS).astype(
                np.int64), weights=pas[m].astype(np.float64),
                minlength=len(exp)) if exp else []
            for i, b in enumerate(got):
                if b["p"]["value"] != float(sums[i]):
                    raise AssertionError(f"{what}: daily sum differs")
                if i and b["d"]["value"] != float(sums[i] - sums[i - 1]):
                    raise AssertionError(f"{what}: derivative differs")
            best = float(max(sums)) if len(sums) else None
            if aggs["mb"]["value"] != best or aggs["mb"]["keys"] != [
                    fmt(k) for (k, _), s in zip(exp, sums) if s == best]:
                raise AssertionError(f"{what}: max_bucket differs")
        else:
            raise AssertionError(f"no oracle for family {fam}")
    return check


def matrix_stats_f64(np, cols, sel):
    """A matrix_stats result of the columns `cols` (name -> f64 [n], in
    the body's field order) over the docs `sel` (name -> bool [n], the
    docs with a value), by the reference's formulas from f64 raw sums."""
    fields, moments = [], {}
    for f, v in cols.items():
        x = v[sel[f]].astype(np.float64)
        n = len(x)
        if n == 0:
            continue
        s1, s2, s3, s4 = (float(np.sum(x ** p)) for p in (1, 2, 3, 4))
        mean = s1 / n
        var = max(s2 / n - mean ** 2, 0.0)
        std = var ** 0.5
        m3 = s3 / n - 3 * mean * s2 / n + 2 * mean ** 3
        m4 = (s4 / n - 4 * mean * s3 / n + 6 * mean ** 2 * s2 / n
              - 3 * mean ** 4)
        moments[f] = var
        fields.append({"name": f, "count": n, "mean": mean,
                       "variance": var * n / max(n - 1, 1),
                       "skewness": (m3 / std ** 3) if std > 0 else 0.0,
                       "kurtosis": (m4 / var ** 2) if var > 0 else 0.0,
                       "covariance": {}, "correlation": {}})
    by_name = {e["name"]: e for e in fields}
    names = list(cols)
    for i, fa in enumerate(names):
        for fb in names[i + 1:]:
            if fa not in by_name or fb not in by_name:
                continue
            both = sel[fa] & sel[fb]
            n = int(both.sum())
            if n == 0:
                continue
            x = cols[fa][both].astype(np.float64)
            y = cols[fb][both].astype(np.float64)
            cov = float(np.sum(x * y)) / n - (float(np.sum(x)) / n) * (
                float(np.sum(y)) / n)
            va, vb = moments[fa], moments[fb]
            corr = cov / (va ** 0.5 * vb ** 0.5) if va > 0 and vb > 0 \
                else 0.0
            for a, b in ((fa, fb), (fb, fa)):
                by_name[a]["covariance"][b] = cov * n / max(n - 1, 1)
                by_name[a]["correlation"][b] = corr
    for e in fields:
        e["covariance"][e["name"]] = e["variance"]
        e["correlation"][e["name"]] = 1.0
    return {"doc_count": max((e["count"] for e in fields), default=0),
            "fields": fields}


def phase_aggkind_cell(torch, np, mapper, seg, card: str, out_dir=None,
                       per_family: int = AGGKIND_BODIES_PER_FAMILY,
                       bsz: int = AGG_BATCH, twin_docs: int = 1_000_000):
    """The agg-kinds cell through Node().request: the 10M taxi docs as one
    index's one segment, each family's bodies at B=1 `_search` (p50 /
    p99) and as B=32 `_msearch` (p50 / p99, queries/s), the busy share of
    6 profiled waves per family, the first query's wall (the plans' and
    static sides' host build) and the image bytes; sampled responses
    against the f64 oracle at the full 10M and, on a 1M-doc shard,
    against Node(device="cpu")."""
    from opensearch_tpu_torch.node import Node
    from opensearch_tpu_torch.ops import _build
    from opensearch_tpu_torch.ops.binned import CSR_CHUNK
    from opensearch_tpu_torch.utils.demo import TAXI_MAPPING
    from opensearch_tpu_torch.utils.demo import taxi_segment as make
    parity = _parity()
    node = Node()
    t0 = time.perf_counter()
    assert node.request("PUT", "/taxi", {
        "mappings": TAXI_MAPPING})["_status"] == 200
    reader = node.indices.get("taxi").shards[0].reader
    reader.add_segment(seg)
    torch.cuda.synchronize()
    out = {"image_bytes": reader.device_bytes()}
    log(f"agg kinds: image of {seg.num_docs} docs uploaded in "
        f"{time.perf_counter() - t0:.3f} s: {out['image_bytes']} bytes")
    ex = node.indices.get("taxi").shards[0].executor
    fams = aggkind_families(np, per_family)

    def search(body):
        return node.request("POST", "/taxi/_search", body)

    first = {}
    for fam, bodies in fams.items():       # warm: plans, static sides
        t = time.perf_counter()
        resp = search(bodies[0])
        first[fam] = (time.perf_counter() - t) * 1e3
        if resp["_status"] != 200:
            raise AssertionError(f"agg kinds {fam}: {resp}")
        search(bodies[1])
        ex.multi_search(bodies[:bsz])
    log("agg kinds: first-query wall ms (plans and static sides built) "
        + json.dumps(first))
    torch.cuda.synchronize()
    _build.reset_launches()
    answers = {}
    cell = {}
    for fam, bodies in fams.items():
        walls = []
        for j, b in enumerate(bodies):
            t = time.perf_counter()
            answers[(fam, j)] = search(b)
            walls.append((time.perf_counter() - t) * 1e3)
        for j in range(len(bodies)):
            resp = answers[(fam, j)]
            if resp["_status"] != 200 or "aggregations" not in resp:
                raise AssertionError(f"agg kinds {fam}[{j}]: {resp}")
        batches = []
        for i in range(6):
            lo = (i * bsz) % len(bodies)
            payload = parity.msearch_ndjson("taxi", bodies[lo:lo + bsz])
            t = time.perf_counter()
            resp = node.request("POST", "/_msearch", payload)
            batches.append((time.perf_counter() - t) * 1e3)
            if any(r.get("status") != 200 for r in resp["responses"]):
                raise AssertionError(f"agg kinds {fam} msearch: {resp}")
            if i == 0:
                answers[(fam, "msearch")] = resp
        rec = {"first_query_ms": first[fam],
               "search_p50_ms": _pct(np, walls, 50),
               "search_p99_ms": _pct(np, walls, 99),
               "msearch32_p50_ms": _pct(np, batches, 50),
               "msearch32_p99_ms": _pct(np, batches, 99),
               "msearch32_qps": bsz * 1e3 / _pct(np, batches, 50)}
        cell[fam] = rec
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    log(f"agg kinds: launches {json.dumps(launches)}")
    _require_launched(launches, ("binned_popcount", "binned_reduce",
                                 "pairs_match", "dense_numeric",
                                 "matrix_moments", "adjacency_counts"),
                      "agg-kinds cell")
    for fam, bodies in fams.items():
        waves = [bodies[(i * bsz) % len(bodies):][:bsz] for i in range(6)]
        cell[fam].update(profile_waves(torch, ex,
                                       [b for w in waves for b in w],
                                       out_dir, f"aggkind_{fam}"))
        log(f"agg kinds {fam}: " + json.dumps(cell[fam]) + f"; card: {card}")
    out["cell"] = cell
    out["launches"] = launches
    # the f64 oracle at the full 10M: two _search answers and the first
    # eight items of the first B=32 _msearch of each family
    check = aggkind_oracle(np, seg.num_docs,
                           reader.device[0][1].d_pad)
    n_checked = 0
    for fam, bodies in fams.items():
        for j in (0, 1):
            check(fam, bodies[j], answers[(fam, j)], f"{fam}[{j}]")
            n_checked += 1
        for j, resp in enumerate(
                answers[(fam, "msearch")]["responses"][:8]):
            check(fam, bodies[j], resp, f"{fam} msearch[{j}]")
            n_checked += 1
    log(f"agg kinds: {n_checked} responses match the f64 oracle")
    del node, reader, ex
    torch.cuda.empty_cache()

    # a 1M-doc shard on the card and on the CPU: two bodies per family
    # equal. The f32 sums of fares on both sides lie within (CSR_CHUNK +
    # chunks) * 2^-24 of sum|v| of the exact ones (K6's two levels), so
    # avg and weighted_avg values agree to twice that relatively
    _small_mapper, small = make(twin_docs, seed=42, seg_id="t1")
    pair = []
    for n in (Node(), Node(device="cpu")):
        assert n.request("PUT", "/taxi", {
            "mappings": TAXI_MAPPING})["_status"] == 200
        n.indices.get("taxi").shards[0].reader.add_segment(small)
        pair.append(n)
    d_pad = pair[0].indices.get("taxi").shards[0].reader.device[0][1].d_pad
    rel = 2 * (CSR_CHUNK + -(-d_pad // CSR_CHUNK)) * F32_SUM_EPS
    compared = 0
    for fam, bodies in fams.items():
        for b in bodies[:2]:
            got = pair[0].request("POST", "/taxi/_search", b)
            want = pair[1].request("POST", "/taxi/_search", b)
            tol = parity.matrix_stats_tol(want, fam, sum_rel=rel)
            aggs = want["aggregations"]
            if fam == "weighted_avg" and aggs["w"]["value"] is not None:
                tol[f"{fam}.aggregations.w.value"] = \
                    2 * rel * abs(aggs["w"]["value"])
            if fam == "autohisto_avg":
                for j, bk in enumerate(aggs["a"]["buckets"]):
                    if bk["f"]["value"] is not None:
                        tol[f"{fam}.aggregations.a.buckets[{j}].f.value"] = \
                            rel * abs(bk["f"]["value"])
            parity.assert_same_response(got, want, fam, agg_sum_tol=tol)
            compared += 1
    log(f"agg kinds: {compared} responses on the {twin_docs}-doc shard "
        f"equal Node(device='cpu')'s")
    del pair
    torch.cuda.empty_cache()
    return out




def _ulps(torch, np, got, want) -> int:
    """The most f32 units in the last place between two float tensors
    (NaN at the same places, and the same infinities, or it raises)."""
    g = got.float().cpu().numpy()
    w = want.float().cpu().numpy()
    if not np.array_equal(np.isnan(g), np.isnan(w)):
        raise AssertionError("kernel and plain version disagree on NaN")
    fin = np.isfinite(g) & np.isfinite(w)
    if not np.array_equal(g[~fin & ~np.isnan(g)], w[~fin & ~np.isnan(w)]):
        raise AssertionError("kernel and plain version disagree on inf")
    gi = g[fin].view(np.int32).astype(np.int64)
    wi = w[fin].view(np.int32).astype(np.int64)
    gi = np.where(gi < 0, -(gi & 0x7FFFFFFF), gi)
    wi = np.where(wi < 0, -(wi & 0x7FFFFFFF), wi)
    return int(np.max(np.abs(gi - wi), initial=0))


def with_relevance_columns(np, mapper, seg):
    """Phase 4's passages with the relevance cell's `likes` and `published`
    doc-value columns (drawn from the seed; dropped again with
    drop_relevance_columns)."""
    from opensearch_tpu_torch.utils.demo import (add_numeric_field,
                                                 relevance_columns)
    likes, published = relevance_columns(seg.num_docs)
    add_numeric_field(mapper, seg, "likes", "long", likes)
    add_numeric_field(mapper, seg, "published", "date", published)
    return likes, published


def drop_relevance_columns(seg):
    for field in ("likes", "published"):
        seg.numeric_dv.pop(field, None)


def phase_scoring_kernels(torch, np, mapper, seg, terms, dev,
                          bsz: int = 32):
    """K18 function_score and K19's four entries against their plain
    versions at the relevance cell's shapes: phase 4's 1M passages (Dp =
    2^20) with its likes / published columns, B=32 queries of 3 terms.
    K18 over three functions (field_value_factor log1p on likes, gauss on
    published, a weight filtered on likes >= 1000); K19's terms_set (the
    three terms), distance_feature (published, pivot 7d), boosting and
    script_score's wrap (_score * Math.log(2 + likes)). Each held to its
    plain version bit for bit (the float outputs' ulps are measured and
    must be 0, NaN at the same places); timed as a graph replay, a call
    and the plain version; bound = bytes / 3.35 TB/s (each input plane
    and column once, the outputs once); no single PyTorch call computes
    either function, so library_ms is null."""
    from opensearch_tpu_torch.ops import scoring
    from opensearch_tpu_torch.ops.device_segment import upload_segment
    from opensearch_tpu_torch.search import dsl
    from opensearch_tpu_torch.search.compile import Compiler, ShardStats
    from opensearch_tpu_torch.search.plan_eval import (
        _eval_plan, _plane, _run_script, dense_numeric,
        function_score_inputs)
    from opensearch_tpu_torch.utils.demo import (RELEVANCE_ORIGIN,
                                                 fast_query_terms)
    with_relevance_columns(np, mapper, seg)
    arrays, meta = upload_segment(seg, dev)
    d_pad = meta.d_pad
    comp = Compiler(mapper, ShardStats([seg]))
    texts = fast_query_terms(bsz, terms, seed=91, terms_per_query=3)
    others = fast_query_terms(bsz, terms, seed=92, terms_per_query=1)
    elems = bsz * d_pad
    results = {}

    def stage(queries):
        plans = [comp.compile(dsl.parse_query(q), seg, meta)
                 for q in queries]
        nodes, _ms = stacked_inputs(torch, plans, [-np.inf] * bsz, dev)
        return plans[0], nodes

    def children(plan, nodes):
        cursor = [1]
        return [_eval_plan(c, arrays, nodes, cursor, bsz)
                for c in plan.children]

    def record(name, shape, kern, plain, nbytes):
        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        for g, a in zip(got, again):
            if not _same_bits(torch, torch.nan_to_num(g.float()),
                              torch.nan_to_num(a.float())):
                raise AssertionError(f"{name}: two runs differ")
        if not torch.equal(got[1], want[1]):
            raise AssertionError(f"{name}: matches differ")
        ulps = _ulps(torch, np, got[0], want[0])
        err = max_abs_err(np, got[0].cpu().numpy(), want[0].cpu().numpy())
        log(f"{name}: scores within {ulps} ulps of the plain version's "
            f"(max abs err {err})")
        if ulps:
            raise AssertionError(f"{name}: {ulps} ulps from the plain "
                                 f"version")
        bound = _bound(nbytes, 0)
        rec = {"shape": shape, "max_abs_err": err, "ulps": ulps,
               "ms": graph_ms(torch, kern), "call_ms": cuda_ms(torch, kern),
               "plain_ms": plain_ms(torch, plain),
               "library_ms": None, "bound_ms": bound[0],
               "bound_by": bound[1]}
        results.setdefault(name, []).append(rec)
        log(name, json.dumps(rec))

    # K18: the three functions the issue's cell names, multiply / multiply
    fs_plan, nodes = stage([{"function_score": {
        "query": {"match": {"body": t}},
        "functions": [
            {"field_value_factor": {"field": "likes", "factor": 1.2,
                                    "modifier": "log1p", "missing": 1}},
            {"gauss": {"published": {"origin": RELEVANCE_ORIGIN,
                                     "scale": "30d", "offset": "7d",
                                     "decay": 0.5}}},
            {"filter": {"range": {"likes": {"gte": 1000}}}, "weight": 2}]}}
        for t in texts])
    args = function_score_inputs(fs_plan, arrays, nodes, [1], bsz, nodes[0])
    record("function_score", f"B={bsz} Dp={d_pad} fvf log1p + gauss date "
           f"+ filtered weight",
           lambda: scoring.function_score(*args),
           lambda: scoring.function_score_plain(*args),
           (5 + 1 + 5) * elems + 2 * 5 * d_pad)
    # K19 terms_set over the three terms
    ts_plan, nodes = stage([{"terms_set": {"body": {"terms": t.split()}}}
                            for t in texts])
    kids = children(ts_plan, nodes)
    my = nodes[0]
    record("terms_set_scores", f"B={bsz} Dp={d_pad} 3 terms",
           lambda: scoring.terms_set(kids, None, None, my["msm"],
                                     my["boost"]),
           lambda: scoring.terms_set_plain(kids, None, None, my["msm"],
                                           my["boost"]),
           (3 * 5 + 5) * elems)
    # K19 distance_feature on the date column
    df_plan, nodes = stage([{"distance_feature": {
        "field": "published", "origin": RELEVANCE_ORIGIN, "pivot": "7d"}}]
        * bsz)
    value, exists, _ = dense_numeric(arrays, "published", d_pad)
    my = nodes[0]
    record("distance_feature_scores", f"B={bsz} Dp={d_pad} published",
           lambda: scoring.distance_feature(value, exists, my["origin"],
                                            my["pivot"], my["boost"]),
           lambda: scoring.distance_feature_plain(
               value, exists, my["origin"], my["pivot"], my["boost"]),
           5 * d_pad + 5 * elems)
    # K19 boosting, negative_boost 0.5 on a second term
    bo_plan, nodes = stage([{"boosting": {
        "positive": {"match": {"body": t}},
        "negative": {"match": {"body": o}}, "negative_boost": 0.5}}
        for t, o in zip(texts, others)])
    (pos_s, pos_m), (_ns, neg_m) = children(bo_plan, nodes)
    my = nodes[0]
    record("boosting_scores", f"B={bsz} Dp={d_pad}",
           lambda: scoring.boosting(pos_s, pos_m, neg_m, my["nb"],
                                    my["boost"]),
           lambda: scoring.boosting_plain(pos_s, pos_m, neg_m, my["nb"],
                                          my["boost"]),
           (4 + 1 + 1 + 5) * elems)
    # K19 script_score's wrap of the cell's script plane
    source = "_score * Math.log(2 + doc['likes'].value)"
    ss_plan, nodes = stage([{"script_score": {
        "query": {"bool": {"must": [{"match": {"body": t}}],
                           "filter": [{"exists": {"field": "likes"}}]}},
        "script": {"source": source}}} for t in texts])
    ((child_s, child_m),) = children(ss_plan, nodes)
    my = nodes[0]
    plane = _plane(_run_script(arrays, d_pad, source, child_s, (), (), my,
                               "p_"), bsz, d_pad, dev).contiguous()
    record("script_score_wrap", f"B={bsz} Dp={d_pad}",
           lambda: scoring.script_score_wrap(child_m, plane, my["boost"]),
           lambda: scoring.script_score_wrap_plain(child_m, plane,
                                                   my["boost"]),
           (1 + 4 + 5) * elems)
    del arrays
    drop_relevance_columns(seg)
    torch.cuda.empty_cache()
    return results


def phase_relevance_cell(torch, np, mapper, seg, terms, card: str,
                         out_dir=None, bsz: int = 32,
                         per_family: int = RELEVANCE_BODIES_PER_FAMILY,
                         sample: int = RELEVANCE_SAMPLE,
                         cut_docs: int = RELEVANCE_CUT_DOCS):
    """The relevance cell through Node().request: phase 4's 1M passages
    with `likes` (a long: lognormal, median 40, capped at 10^6, 5% of docs
    without one) and `published` (a date, uniform over 2019-2024), six
    families of 64 bodies after the OpenSearch documentation's
    function_score and script_score examples (utils/demo.relevance_bodies)
    over 2-4 term texts. Per family: B=1 `_search` p50 / p99 over 64
    requests, B=32 `_msearch` p50 / p99 and q/s over 6 batches, the busy
    share of 6 profiled waves; every timed answer a 200; then 16 sampled
    bodies a family on a 100,000-passage cut with the same columns
    against Node(device="cpu")'s pages."""
    from opensearch_tpu_torch.node import Node
    from opensearch_tpu_torch.ops import _build
    from opensearch_tpu_torch.utils.demo import (RELEVANCE_FAMILIES,
                                                 add_numeric_field,
                                                 build_shards_fast,
                                                 relevance_bodies)
    parity = _parity()
    t0 = time.perf_counter()
    likes, published = with_relevance_columns(np, mapper, seg)
    rel_mapping = {"mappings": {"properties": {
        "body": {"type": "text"}, "likes": {"type": "long"},
        "published": {"type": "date"}}}}

    def index_of(node, segment):
        assert node.request("PUT", "/news", rel_mapping)["_status"] == 200
        shard = node.indices.get("news").shards[0]
        shard.reader.add_segment(segment)
        return shard

    node = Node()
    shard = index_of(node, seg)
    torch.cuda.synchronize()
    out = {"image_bytes": shard.reader.device_bytes()}
    log(f"relevance: columns made and the image uploaded in "
        f"{time.perf_counter() - t0:.3f} s: {out['image_bytes']} bytes")
    bodies = {fam: relevance_bodies(fam, per_family, terms, seed=i + 1)
              for i, fam in enumerate(RELEVANCE_FAMILIES)}

    def msearch(n, chunk):
        lines = []
        for b in chunk:
            lines += [{"index": "news"}, b]
        return n.request("POST", "/_msearch", lines)

    def batch(fam, k):
        lo = (k * bsz) % per_family
        return (bodies[fam] * 2)[lo:lo + bsz]
    for fam in RELEVANCE_FAMILIES:       # first queries: plans, columns
        t = time.perf_counter()
        r = node.request("POST", "/news/_search", bodies[fam][0])
        msearch(node, batch(fam, 0))
        torch.cuda.synchronize()
        out[f"{fam}_first_ms"] = (time.perf_counter() - t) * 1e3
        if r["_status"] != 200:
            raise AssertionError(f"relevance {fam}: {r}")
    _build.reset_launches()
    for fam in RELEVANCE_FAMILIES:
        single = []
        for b in bodies[fam]:
            t = time.perf_counter()
            r = node.request("POST", "/news/_search", b)
            single.append((time.perf_counter() - t) * 1e3)
            if r["_status"] != 200:
                raise AssertionError(f"relevance {fam} _search: {r}")
        batches = []
        for k in range(6):
            t = time.perf_counter()
            r = msearch(node, batch(fam, k))
            batches.append((time.perf_counter() - t) * 1e3)
            if any(x.get("status") != 200 for x in r["responses"]):
                raise AssertionError(f"relevance {fam} _msearch: "
                                     f"{r['responses'][0]}")
        torch.cuda.synchronize()
        out[fam] = {"search_p50_ms": _pct(np, single, 50),
                    "search_p99_ms": _pct(np, single, 99),
                    "msearch32_p50_ms": _pct(np, batches, 50),
                    "msearch32_p99_ms": _pct(np, batches, 99),
                    "msearch32_qps": bsz * 1e3 / _pct(np, batches, 50)}
        log(f"relevance {fam}: B=1 _search p50 "
            f"{out[fam]['search_p50_ms']:.3f} p99 "
            f"{out[fam]['search_p99_ms']:.3f} ms over {len(single)}; B={bsz}"
            f" _msearch p50 {out[fam]['msearch32_p50_ms']:.3f} p99 "
            f"{out[fam]['msearch32_p99_ms']:.3f} ms over {len(batches)} "
            f"({out[fam]['msearch32_qps']:.1f} queries/s); card: {card}")
    launches = dict(_build.LAUNCHES)
    log(f"relevance: launches {json.dumps(launches)}")
    _require_launched(launches, (
        "function_score", "script_score_wrap", "distance_feature_scores",
        "boosting_scores", "dense_numeric", "score_text_clause",
        "masked_topk"), "relevance")
    for fam in RELEVANCE_FAMILIES:
        waves = [b for k in range(6) for b in batch(fam, k)]
        out[fam].update(profile_waves(torch, shard.executor, waves, out_dir,
                                      f"relevance_{fam}"))
    del node, shard
    drop_relevance_columns(seg)
    torch.cuda.empty_cache()

    # correctness: a 100,000-passage cut with the same columns, the card's
    # Node against Node(device="cpu")
    t0 = time.perf_counter()
    cut_mapper, (cut,), cut_terms = build_shards_fast(
        cut_docs, 1, vocab_size=20000, avg_len=60, seed=42,
        materialize_terms=SCALE_MATERIALIZE_TERMS)
    add_numeric_field(cut_mapper, cut, "likes", "long", likes[:cut_docs])
    add_numeric_field(cut_mapper, cut, "published", "date",
                      published[:cut_docs])
    gpu, cpu = Node(), Node(device="cpu")
    index_of(gpu, cut)
    index_of(cpu, cut)
    checked = 0
    for i, fam in enumerate(RELEVANCE_FAMILIES):
        fam_bodies = relevance_bodies(fam, sample, cut_terms, seed=50 + i)
        for b in fam_bodies:
            got = gpu.request("POST", "/news/_search", b)
            if got["_status"] != 200:
                raise AssertionError(f"relevance cut {fam}: {got}")
            parity.assert_same_response(
                got, cpu.request("POST", "/news/_search", b),
                f"relevance {fam}", score_rtol=SCORING_RTOL,
                score_atol=SCORING_ATOL)
            checked += 1
    log(f"relevance: {checked} sampled pages on a {cut_docs}-passage cut "
        f"equal Node(device='cpu')'s (scores to rtol {SCORING_RTOL}, atol "
        f"{SCORING_ATOL}) in {time.perf_counter() - t0:.3f} s")
    out["checked_pages"] = checked
    return out


SHARDED_SHARDS = 5           # Elasticsearch's default before 7.0
SHARDED_QUERIES = 600
SHARDED_HOST_LOOP_CHECKS = 64
SHARDED_CUT_DOCS = 100_000
SHARDED_CUT_PAGES = 32
SHARDED_CUT_DFS_PAGES = 8
SHARDED_DFS_BODIES = 64
LOGS_SINGLES = 20                   # cut from 50 to fit phases 14-15


def _page_of(resp):
    return ([(h["_id"], h["_score"], h.get("sort"))
             for h in resp["hits"]["hits"]],
            resp["hits"].get("total"), resp["hits"]["max_score"])


def phase_sharded_cell(torch, np, mapper, seg, terms, agg_seg, four, dev,
                       card: str, out_dir=None, n_docs: int = SCALE_DOCS,
                       n_queries: int = SHARDED_QUERIES,
                       cut_docs: int = SHARDED_CUT_DOCS,
                       logs_singles: int = LOGS_SINGLES, bsz: int = 32):
    """The sharded cell through Node().request:
    - phase 4's msmarco-shaped passages built as 5 shards
      (build_shards_fast(n_shards=5)) in one index: 2-4-term `match`
      bodies at B=1 (the multi-shard program, 5 rows) and B=32 `_msearch`
      (each body through search()), block-max off and on (a second Node
      with `search.blockmax.enabled`): p50 / p99, q/s, busy share, image
      bytes, the share of pruned lanes; block-max pages equal the gate-off
      pages, and the program's pages equal the card's own host loop's on
      64 bodies; `dfs_query_then_fetch` on 64 of the bodies (sharded_dfs);
    - block-max in the envelope: phase 4's one-shard index, gate on and
      off, B=1 and B=32, pages equal;
    - `logs-*` over phase 10's four 2.5M-doc segments as four one-shard
      indices, against the same docs as one index (and the f64 oracle):
      pages, totals and aggregations equal, B=1 p50 / p99 per body;
    - a 100,000-passage cut in 5 shards against Node(device="cpu"), 32
      pages and 8 dfs pages."""
    from opensearch_tpu_torch.node import Node
    from opensearch_tpu_torch.ops import _build
    from opensearch_tpu_torch.search import dsl, spmd
    from opensearch_tpu_torch.search.compile import Compiler
    from opensearch_tpu_torch.search.executor import (SearchExecutor,
                                                      ShardReader)
    from opensearch_tpu_torch.utils.demo import (DEMO_MAPPING,
                                                 STRUCTURED_MAPPING,
                                                 build_shards_fast,
                                                 fast_query_terms)
    parity = _parity()
    t_cell = time.perf_counter()
    out = {}
    texts = []
    for n in (2, 3, 4):
        texts += fast_query_terms(n_queries // 3, terms, seed=700 + n,
                                  terms_per_query=n)
    np.random.default_rng(1).shuffle(texts)
    bodies = [{"query": {"match": {"body": t}}} for t in texts]

    def sharded_index(node, name, segs):
        assert node.request("PUT", f"/{name}", {
            "settings": {"number_of_shards": len(segs)},
            "mappings": DEMO_MAPPING})["_status"] == 200
        svc = node.indices.get(name)
        for shard, sg in zip(svc.shards, segs):
            shard.reader.add_segment(sg)
        return svc

    # (a) BM25 over 5 shards, block-max off and on
    t0 = time.perf_counter()
    _m5, segs5, _t5 = build_shards_fast(
        n_docs, SHARDED_SHARDS, vocab_size=20000, avg_len=60, seed=42,
        materialize_terms=SCALE_MATERIALIZE_TERMS)
    log(f"sharded: {n_docs} passages in {len(segs5)} shards "
        f"({[s.num_docs for s in segs5]}) built in "
        f"{time.perf_counter() - t0:.3f} s")
    nodes = {"off": Node(),
             "on": Node(settings={"search.blockmax.enabled": True})}
    svcs = {}
    for gate, node in nodes.items():
        svcs[gate] = sharded_index(node, "msm5", segs5)
    out["image_bytes"] = sum(sh.reader.device_bytes()
                             for sh in svcs["off"].shards)
    for node in nodes.values():
        for b in bodies[:10]:
            node.request("POST", "/msm5/_search", b)
    torch.cuda.synchronize()
    _build.reset_launches()
    pages = {}
    for gate, node in nodes.items():
        n0 = spmd.SPMD_QUERIES[0]
        walls, got = [], []
        for b in bodies:
            t = time.perf_counter()
            resp = node.request("POST", "/msm5/_search", b)
            walls.append((time.perf_counter() - t) * 1e3)
            got.append(resp)
        if spmd.SPMD_QUERIES[0] - n0 != len(bodies):
            raise AssertionError(f"sharded {gate}: only "
                                 f"{spmd.SPMD_QUERIES[0] - n0} of "
                                 f"{len(bodies)} bodies took the program")
        batches = []
        for i in range(0, len(bodies) - bsz + 1, bsz):
            payload = parity.msearch_ndjson("msm5", bodies[i:i + bsz])
            t = time.perf_counter()
            resp = node.request("POST", "/_msearch", payload)
            batches.append((time.perf_counter() - t) * 1e3)
            if any(r.get("status") != 200 for r in resp["responses"]):
                raise AssertionError(f"sharded msearch {gate}: {resp}")
        pages[gate] = got
        rec = {"search_p50_ms": _pct(np, walls, 50),
               "search_p99_ms": _pct(np, walls, 99),
               "msearch32_p50_ms": _pct(np, batches, 50),
               "msearch32_p99_ms": _pct(np, batches, 99),
               "msearch32_qps": bsz * 1e3 / _pct(np, batches, 50),
               "gte_responses": sum(r["hits"]["total"]["relation"] == "gte"
                                    for r in got)}
        rec.update(profile_waves(torch, svcs[gate], bodies, out_dir,
                                 f"sharded_{gate}"))
        out[f"bm25_5_shards_blockmax_{gate}"] = rec
        log(f"sharded 5-shard BM25, block-max {gate}: " + json.dumps(rec))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    _require_launched(launches, ("score_text_clause", "masked_topk_keyed",
                                 "row_merge", "blockmax_keep",
                                 "score_text_clause_keep"), "sharded cell")
    for i, (a, b) in enumerate(zip(pages["off"], pages["on"])):
        pa, pb = _page_of(a), _page_of(b)
        if pa[0] != pb[0] or pa[2] != pb[2]:
            raise AssertionError(f"sharded: block-max page {i} differs "
                                 f"from the gate-off page")
        if pb[1]["relation"] == "eq" and pb[1] != pa[1]:
            raise AssertionError(f"sharded: block-max total {i} differs")
    # the share of pruned lanes on the program, from the rows' plans
    ex_on = [sh.executor for sh in svcs["on"].shards]
    rows = spmd.spmd_rows(ex_on)
    pruned = lanes = 0
    for b in bodies[:SHARDED_HOST_LOOP_CHECKS]:
        pruned += spmd.spmd_query_phase(ex_on, b, 10, rows)[3]
        for ex in ex_on:
            stats, segs_, dev_ = ex.reader.stats_snapshot()
            comp = Compiler(ex.reader.mapper, stats, blockmax=True)
            for sg, (_a, m) in zip(segs_, dev_):
                p = comp.compile(dsl.parse_query(b["query"]), sg, m)
                if p.kind == "text":
                    lanes += int((p.inputs["ids"] >= 0).sum())
    out["pruned_lane_share"] = pruned / max(lanes, 1)
    # the program's pages against the card's own host loop
    for b in bodies[:SHARDED_HOST_LOOP_CHECKS]:
        want = nodes["off"].request("POST", "/msm5/_search", b)
        with spmd.force_host_loop():
            got_h = nodes["off"].request("POST", "/msm5/_search", b)
        if _page_of(want) != _page_of(got_h):
            raise AssertionError(f"sharded: the program's page differs "
                                 f"from the host loop's for {b}")
    log(f"sharded: {len(bodies)} block-max pages equal the gate-off pages; "
        f"pruned lanes {pruned} of {lanes} ({out['pruned_lane_share']:.4f}) "
        f"over {SHARDED_HOST_LOOP_CHECKS} bodies; "
        f"{SHARDED_HOST_LOOP_CHECKS} program pages equal the host loop's")
    out["bm25_5_shards_dfs"] = sharded_dfs(np, nodes["off"], segs5, bodies,
                                           pages["off"])
    del nodes, svcs, ex_on, segs5
    torch.cuda.empty_cache()

    # (b) block-max in the envelope: phase 4's one-shard index
    reader = ShardReader(mapper, dev, index_name="msm1")
    reader.add_segment(seg)
    exs = {"off": SearchExecutor(reader),
           "on": SearchExecutor(reader, blockmax=True)}
    for ex in exs.values():
        for b in bodies[:10]:
            ex.search(b)
    _build.reset_launches()
    env = {}
    for gate, ex in exs.items():
        walls, got = [], []
        for b in bodies:
            t = time.perf_counter()
            got.append(ex.search(b))
            walls.append((time.perf_counter() - t) * 1e3)
        batches, got_m = [], []
        for i in range(0, len(bodies) - bsz + 1, bsz):
            t = time.perf_counter()
            got_m.append(ex.multi_search(bodies[i:i + bsz]))
            batches.append((time.perf_counter() - t) * 1e3)
        env[gate] = (got, got_m)
        rec = {"search_p50_ms": _pct(np, walls, 50),
               "search_p99_ms": _pct(np, walls, 99),
               "msearch32_p50_ms": _pct(np, batches, 50),
               "msearch32_qps": bsz * 1e3 / _pct(np, batches, 50),
               "gte_responses": sum(r["hits"]["total"]["relation"] == "gte"
                                    for r in got)}
        rec.update(profile_waves(torch, ex, bodies, out_dir,
                                 f"envelope_{gate}"))
        rec["msearch32_device_ms"] = device_split_ms(
            torch, lambda ex=ex: ex.multi_search(bodies[:bsz]))
        out[f"bm25_envelope_blockmax_{gate}"] = rec
        log(f"sharded envelope (1 shard), block-max {gate}: "
            + json.dumps(rec))
    torch.cuda.synchronize()
    _require_launched(dict(_build.LAUNCHES), (
        "blockmax_keep", "bm25_candidate_keep"), "envelope block-max")
    for a, b in zip(env["off"][0], env["on"][0]):
        if _page_of(a)[0] != _page_of(b)[0]:
            raise AssertionError("envelope: a block-max page differs")
    for ma, mb in zip(env["off"][1], env["on"][1]):
        for a, b in zip(ma["responses"], mb["responses"]):
            if _page_of(a)[0] != _page_of(b)[0]:
                raise AssertionError("envelope: a block-max B=32 page "
                                     "differs")
    del exs, reader, env
    torch.cuda.empty_cache()

    # (c) logs-* over four daily indices against the same docs as one
    node = Node()
    t0 = time.perf_counter()
    for name, segs_ in (("logs_one", [agg_seg]),
                        *((f"logs-{j}", [sg]) for j, sg in enumerate(four))):
        assert node.request("PUT", f"/{name}", {
            "mappings": STRUCTURED_MAPPING})["_status"] == 200
        node.indices.get(name).shards[0].reader.add_segment(segs_[0])
    log(f"sharded: logs_one and logs-0..3 uploaded in "
        f"{time.perf_counter() - t0:.3f} s")
    logs_bodies = dict(sorted_bodies(np, agg_seg))
    logs_bodies = {
        "desc_sort_timestamp": logs_bodies["desc_sort_timestamp"],
        "desc_sort_views_filtered": logs_bodies["desc_sort_views_filtered"],
        "terms_tag_date_histogram": {"size": 0, "aggs": {
            "t": {"terms": {"field": "tag", "size": 10}},
            "d": {"date_histogram": {"field": "ts",
                                     "fixed_interval": "1d"}}}},
        "cardinality": {"size": 0, "aggs": {"c": {"cardinality": {
            "field": "tag"}}}},
        "dfs_match": {"query": {"match": {"views": 4242}},
                      "search_type": "dfs_query_then_fetch", "size": 10},
    }
    logs = {}
    for name, body in logs_bodies.items():
        one = node.request("POST", "/logs_one/_search", body)
        node.request("POST", "/logs-*/_search", body)
        n0 = spmd.SPMD_QUERIES[0]
        walls = []
        for _ in range(logs_singles):
            t = time.perf_counter()
            resp = node.request("POST", "/logs-*/_search", body)
            walls.append((time.perf_counter() - t) * 1e3)
        if resp["_status"] != 200 or one["_status"] != 200:
            raise AssertionError(f"logs-* {name}: {resp}")
        if resp["_shards"]["total"] != 4:
            raise AssertionError(f"logs-* {name}: {resp['_shards']}")
        _sorted_oracle(np, agg_seg, name, body, resp)
        same = ([(h["_id"], h.get("sort"), h["_score"])
                 for h in resp["hits"]["hits"]]
                == [(h["_id"], h.get("sort"), h["_score"])
                    for h in one["hits"]["hits"]]
                and resp["hits"]["total"] == one["hits"]["total"]
                and resp.get("aggregations") == one.get("aggregations"))
        if not same:
            raise AssertionError(f"logs-* {name}: differs from the "
                                 f"one-index answer")
        route = "program" if spmd.SPMD_QUERIES[0] > n0 else "host loop"
        # the same body on the pinned host loop, for the route's cost
        host = []
        with spmd.force_host_loop():
            for _ in range(logs_singles):
                t = time.perf_counter()
                pinned = node.request("POST", "/logs-*/_search", body)
                host.append((time.perf_counter() - t) * 1e3)
        if pinned.get("aggregations") != resp.get("aggregations") \
                or pinned["hits"]["total"] != resp["hits"]["total"]:
            raise AssertionError(f"logs-* {name}: the host loop's answer "
                                 f"differs")
        logs[name] = {"search_p50_ms": _pct(np, walls, 50),
                      "search_p99_ms": _pct(np, walls, 99),
                      "route": route,
                      "host_loop_p50_ms": _pct(np, host, 50)}
        log(f"sharded logs-* {name}: " + json.dumps(logs[name]))
    out["logs"] = logs
    del node
    torch.cuda.empty_cache()

    # (d) a 100,000-passage cut in 5 shards against Node(device="cpu")
    t0 = time.perf_counter()
    _mc, cut, _tc = build_shards_fast(
        cut_docs, SHARDED_SHARDS, vocab_size=20000, avg_len=60, seed=42,
        materialize_terms=SCALE_MATERIALIZE_TERMS)
    gpu, cpu = Node(), Node(device="cpu")
    for node in (gpu, cpu):
        sharded_index(node, "cut5", cut)
    cut_bodies = [dict(b, size=20) for b in bodies[:SHARDED_CUT_PAGES]] + [
        dict(b, size=20, search_type="dfs_query_then_fetch")
        for b in bodies[:SHARDED_CUT_DFS_PAGES]]
    for body in cut_bodies:
        parity.assert_same_response(
            gpu.request("POST", "/cut5/_search", body),
            cpu.request("POST", "/cut5/_search", body), "cut5")
    log(f"sharded: {SHARDED_CUT_PAGES} pages and {SHARDED_CUT_DFS_PAGES} "
        f"dfs pages of the {cut_docs}-passage 5-shard cut equal "
        f"Node(device='cpu')'s ({time.perf_counter() - t0:.3f} s)")
    del gpu, cpu
    torch.cuda.empty_cache()
    out["cell_s"] = time.perf_counter() - t_cell
    log(f"sharded cell: {out['cell_s']:.3f} s; card: {card}")
    return out


def sharded_dfs(np, node, segs5, bodies, plain_pages) -> dict:
    """`dfs_query_then_fetch` text `match` bodies on the 5-shard index:
    each shard scores with the merged term statistics, so every page
    equals that of one shard holding the same five segments (its own
    statistics are the merged ones), and some pages differ from plain
    query_then_fetch's, where each shard scores with its own. B=1 p50 /
    p99 of the dfs requests (the host loop: DFS pins per-shard
    statistics)."""
    from opensearch_tpu_torch.search import spmd
    from opensearch_tpu_torch.search.controller import execute_search
    from opensearch_tpu_torch.utils.demo import DEMO_MAPPING
    t0 = time.perf_counter()
    assert node.request("PUT", "/msm_one", {
        "mappings": DEMO_MAPPING})["_status"] == 200
    one = node.indices.get("msm_one").shards[0]
    for sg in segs5:
        one.reader.add_segment(sg)
    upload_s = time.perf_counter() - t0
    dfs = [dict(b, search_type="dfs_query_then_fetch")
           for b in bodies[:SHARDED_DFS_BODIES]]
    for b in dfs[:10]:
        node.request("POST", "/msm5/_search", b)
    walls, moved, n0 = [], 0, spmd.SPMD_QUERIES[0]
    for b, plain in zip(dfs, plain_pages):
        t = time.perf_counter()
        resp = node.request("POST", "/msm5/_search", b)
        walls.append((time.perf_counter() - t) * 1e3)
        if resp["_status"] != 200 or not resp["hits"]["hits"] \
                or resp["_shards"]["total"] != SHARDED_SHARDS:
            raise AssertionError(f"sharded dfs: {resp}")
        want = execute_search([one.executor], {"query": b["query"]})
        if _page_of(resp) != _page_of(want):
            raise AssertionError(f"sharded dfs: the page of {b} differs "
                                 f"from the one-shard index's")
        moved += _page_of(resp) != _page_of(plain)
    if spmd.SPMD_QUERIES[0] - n0 != len(dfs):
        raise AssertionError("sharded dfs: the one-shard index's answers "
                             "did not take the program")
    if not moved:
        raise AssertionError("sharded dfs: no page differs from the "
                             "per-shard statistics' page")
    rec = {"search_p50_ms": _pct(np, walls, 50),
           "search_p99_ms": _pct(np, walls, 99), "route": "host loop",
           "bodies": len(dfs), "pages_moved_by_dfs": moved,
           "upload_s": upload_s, "section_s": time.perf_counter() - t0}
    log(f"sharded 5-shard BM25, dfs_query_then_fetch: {json.dumps(rec)}; "
        f"every page equals the one-shard index's")
    return rec


# ------------------------------- nested documents, geo_point, rank_feature

NESTED_QUESTIONS = 2_000_000     # rally nested track: ~11M questions, cut
GEO_PLACES = 10_000_000          # rally geonames track: ~11.4M places
NESTED_BODIES_PER_FAMILY = 64
NESTED_CUT_QUESTIONS = 20_000    # the cut held against Node(device="cpu")
GEO_CUT_PLACES = 200_000
CUT_PAGES = 8                    # bodies a family on the cuts
GRID_SAMPLE = 100_000            # places whose grid keys meet the scalar form
NESTED_FAMILIES = ("avg", "sum", "max", "min", "none", "inner_hits",
                   "terms_user", "tree")
GEO_FAMILIES = ("bbox", "distance", "radius_rank", "distance_feature",
                "country_geo", "geohash5", "geotile8")


def nested_cell_bodies(np, family: str, n: int, seed: int) -> list:
    """The nested cell's bodies: answers by a zipf-drawn user after a date
    in a score mode (avg again with inner_hits of 3); `size: 0` with
    nested -> terms answers.user size 10, and nested -> date_histogram
    answers.date (month) -> reverse_nested -> terms tag, each over a
    creationDate window."""
    from opensearch_tpu_torch.utils.demo import (QA_BASE_MS, QA_USERS,
                                                 _zipf_draw)
    rng = np.random.default_rng(seed)
    users = _zipf_draw(rng, QA_USERS, n)
    days = rng.integers(0, 5 * 365, n)
    out = []
    for i in range(n):
        since = QA_BASE_MS + int(days[i]) * DAY_MS
        if family in NESTED_MODES_CELL or family == "inner_hits":
            nested = {"path": "answers",
                      "score_mode": "avg" if family == "inner_hits"
                      else family,
                      "query": {"bool": {"must": [
                          {"term": {"answers.user": int(users[i])}},
                          {"range": {"answers.date": {"gte": since}}}]}}}
            if family == "inner_hits":
                nested["inner_hits"] = {"size": 3}
            out.append({"query": {"nested": nested}, "size": 10})
            continue
        window = {"range": {"creationDate": {
            "gte": since, "lt": since + 180 * DAY_MS}}}
        if family == "terms_user":
            aggs = {"a": {"nested": {"path": "answers"}, "aggs": {
                "u": {"terms": {"field": "answers.user", "size": 10}}}}}
        else:
            aggs = {"a": {"nested": {"path": "answers"}, "aggs": {
                "m": {"date_histogram": {"field": "answers.date",
                                         "calendar_interval": "month"},
                      "aggs": {"back": {"reverse_nested": {}, "aggs": {
                          "t": {"terms": {"field": "tag"}}}}}}}}}
        out.append({"size": 0, "query": window, "aggs": aggs})
    return out


NESTED_MODES_CELL = ("avg", "sum", "max", "min", "none")


def geo_cell_bodies(np, family: str, n: int, seed: int, centres) -> list:
    """The geo cell's bodies around seeded city centres: a bounding box (as
    rally geonames' geo queries), geo_distance 50 km, bool{filter
    geo_distance 200 km, should rank_feature population saturation},
    distance_feature (pivot 10 km) filtered by a country_code term, `size:
    0` terms country_code size 20 -> geo_bounds + geo_centroid over a
    population range, and geohash_grid precision 5 / geotile_grid zoom 8
    over a map viewport (a 10-degree box)."""
    rng = np.random.default_rng(seed)
    pick = centres[rng.integers(0, len(centres), n)]
    out = []
    for i in range(n):
        lat, lon = float(pick[i][0]), float(pick[i][1])
        point = {"lat": lat, "lon": lon}
        half = float(rng.uniform(0.5, 3.0))
        box = {"top": min(lat + half, 90.0), "bottom": max(lat - half, -90.0),
               "left": ((lon - half + 180.0) % 360.0) - 180.0,
               "right": ((lon + half + 180.0) % 360.0) - 180.0}
        if family == "bbox":
            out.append({"query": {"geo_bounding_box": {"location": box}},
                        "size": 10})
        elif family == "distance":
            out.append({"query": {"bool": {"filter": [{"geo_distance": {
                "distance": "50km", "location": point}}]}}, "size": 10})
        elif family == "radius_rank":
            out.append({"query": {"bool": {
                "filter": [{"geo_distance": {"distance": "200km",
                                             "location": point}}],
                "should": [{"rank_feature": {"field": "population",
                                             "saturation": {}}}]}},
                "size": 10})
        elif family == "distance_feature":
            out.append({"query": {"bool": {
                "must": [{"distance_feature": {
                    "field": "location", "origin": point,
                    "pivot": "10km"}}],
                "filter": [{"term": {"country_code":
                                     f"c{int(rng.integers(0, 20)):03d}"}}]}},
                "size": 10})
        elif family == "country_geo":
            lo = float(rng.uniform(0, 2000))
            out.append({"size": 0, "query": {"range": {"population": {
                "gte": lo}}}, "aggs": {"cc": {
                    "terms": {"field": "country_code", "size": 20},
                    "aggs": {"gb": {"geo_bounds": {"field": "location"}},
                             "gc": {"geo_centroid": {
                                 "field": "location"}}}}}})
        else:
            view = {"top": min(lat + 5, 90.0), "bottom": max(lat - 5, -90.0),
                    "left": max(lon - 5, -180.0),
                    "right": min(lon + 5, 180.0)}
            grid = {"geohash_grid": {"field": "location", "precision": 5}} \
                if family == "geohash5" else \
                {"geotile_grid": {"field": "location", "precision": 8}}
            out.append({"size": 0, "query": {"geo_bounding_box": {
                "location": view}}, "aggs": {"g": grid}})
    return out


def phase_nested_geo_kernels(torch, np, qa_seg, geo_seg, dev,
                             bsz: int = 32,
                             parts=("k22", "k23", "k24", "k25"),
                             passes: bool = False):
    """K22-K25 (those in `parts`) against their plain versions at the
    cells' shapes: K22
    nested_join and K23 nested_aggs on the nested cell's image (2M
    questions, Dp 2^23, B=32: the child plan of bool{term answers.user,
    range answers.date}; nested under the root and reverse_nested under a
    monthly date_histogram of the answers), K24 binned_scatter and K25's
    four entries on the geo cell's image (10M places, Dp 2^24, B=32:
    geo_centroid's sums and geo_bounds' extrema under terms
    country_code, and past SCATTER_MAX_BINS bins under country_code x 64
    latitude bands; the one-bin-per-doc max of the dynamic child bins at
    the nested cell's shape; geo_distance, geo_bbox, distance_feature and
    rank_feature saturation). K22, K24's sums and K25 bit for bit (the
    float outputs' ulps measured: 0), K23 and K24's counts and extrema
    exactly, K24's sums also within n * 2^-24 * sum|v| of the f64 sums.
    Each timed as a graph replay, a call, the plain version and, where one
    PyTorch call computes the same function, that call: K22 sum the
    index_add_ of the selected child scores into the roots, K23 nested
    the bincount of the own rows' buckets, K24 scatter_reduce_ of the
    reduction; bound = max(bytes / 3.35 TB/s, f32 ops / 67 TFLOP/s)."""
    from opensearch_tpu_torch.ops import binned, geo, nested
    from opensearch_tpu_torch.ops.device_segment import upload_segment
    from opensearch_tpu_torch.search import dsl
    from opensearch_tpu_torch.search.compile import Compiler, ShardStats
    from opensearch_tpu_torch.search.plan_eval import (_eval_plan,
                                                       dense_numeric)
    from opensearch_tpu_torch.index.mapper import MapperService
    from opensearch_tpu_torch.utils.demo import (GEONAMES_COUNTRIES,
                                                 QA_BASE_MS, QA_MAPPING)
    results = {}

    def record(name, shape, kern, plain, library, nbytes, check,
               ops: float = 0.0):
        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        for g, a in zip(got, again):
            if not _same_bits(torch, g, a):
                raise AssertionError(f"{name}: two runs differ")
        err = check(got, want)
        bound = _bound(nbytes, ops)
        rec = {"shape": shape, "max_abs_err": err,
               "ms": graph_ms(torch, kern), "call_ms": cuda_ms(torch, kern),
               "plain_ms": plain_ms(torch, plain),
               "library_ms": None if library is None
               else cuda_ms(torch, library, reps=5, warmup=1),
               "bound_ms": bound[0],
               "bound_by": bound[1]}
        if name in ("binned_scatter", "reverse_nested_agg"):
            # the device memory one call takes beyond what it returns
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            outs = kern()
            torch.cuda.synchronize()
            rec["peak_scratch_bytes"] = torch.cuda.max_memory_allocated() \
                - before - sum(o.numel() * o.element_size() for o in outs)
            del outs
            if passes:
                rec["passes"] = launch_ms(torch, kern, by_name=True)
        results.setdefault(name, []).append(rec)
        log(name, json.dumps(rec))

    def exact(got, want):
        for g, w in zip(got, want):
            if not _same_bits(torch, g, w):
                raise AssertionError("kernel and plain version differ")
        return 0.0

    def scores_bits(got, want):
        if not torch.equal(got[1], want[1]):
            raise AssertionError("matches differ")
        if not _same_bits(torch, got[0], want[0]):
            raise AssertionError(f"{_ulps(torch, np, got[0], want[0])} "
                                 f"ulps from the plain version")
        return 0.0

    # ---- K22 / K23 on the nested cell
    t0 = time.perf_counter()
    arrays, meta = upload_segment(qa_seg, dev)
    d_pad = meta.d_pad
    qa_mapper = MapperService(QA_MAPPING)
    comp = Compiler(qa_mapper, ShardStats([qa_seg]))
    rng = np.random.default_rng(71)
    plans = [comp.compile(dsl.parse_query({"bool": {"must": [
        {"term": {"answers.user": int(u)}},
        {"range": {"answers.date": {"gte": QA_BASE_MS + int(d) * DAY_MS}}}
    ]}}), qa_seg, meta) for u, d in zip(rng.integers(0, 50, bsz),
                                        rng.integers(0, 1500, bsz))]
    nodes, _ms = stacked_inputs(torch, plans, [-np.inf] * bsz, dev)
    child_s, child_m = _eval_plan(plans[0], arrays, nodes, [0], bsz)
    child_s, child_m = child_s.contiguous(), child_m.contiguous()
    path_ord = torch.zeros(bsz, dtype=torch.int32, device=dev)
    boost = torch.ones(bsz, dtype=torch.float32, device=dev)
    elems = bsz * d_pad
    log(f"nested kernels: image uploaded and the child plans run in "
        f"{time.perf_counter() - t0:.3f} s (Dp {d_pad})")
    pptr = arrays["parent_ptr"]
    pidx = torch.where(pptr >= 0, pptr, d_pad).long()
    sel = child_m & arrays["live"][None, :] & (arrays["nested_path"] == 0)
    csel = torch.where(sel, child_s, 0.0)
    for mode in (("sum", "avg", "max") if "k22" in parts else ()):
        record("nested_join", f"B={bsz} Dp={d_pad} {mode}",
               lambda mode=mode: nested.nested_join(
                   child_s, child_m, arrays, path_ord, boost, mode),
               lambda mode=mode: nested.nested_join_plain(
                   child_s, child_m, arrays["live"], arrays["nested_path"],
                   pptr, arrays["child_start"], arrays["child_rows"],
                   path_ord, boost, mode),
               (lambda: torch.zeros(bsz, d_pad + 1, device=dev).index_add_(
                   1, pidx, csel)) if mode == "sum" else None,
               (5 + 5) * elems + 13 * d_pad, scores_bits,
               ops=2.0 * elems)
    roots = arrays["root"] & arrays["live"]
    mask = roots[None, :].expand(bsz, d_pad).contiguous()
    peff = torch.where(mask, 0, -1).to(torch.int32)
    own, child_eff, _c = nested.nested_agg(mask, peff, arrays, path_ord, 1)
    date, _e, _n = dense_numeric(arrays, "answers.date", d_pad)
    month = ((date.double() - QA_BASE_MS) // (30 * DAY_MS)).to(torch.int32)
    months = int(month.max()) + 1
    if "k24" in parts:
        # the dynamic child-bin max (_dyn_child_bins): one bin per doc
        # (total = Dp), each query's kept answers.user pairs, each lane's
        # value its bin: the doc's month x the users' card + the user
        users = arrays["numeric"]["answers.user"]
        udoc = users["doc_ids"]
        u_card = int(users["unique_f32"].shape[0])
        safe = torch.where(udoc >= 0, udoc, 0).long()
        keep = (torch.rand(bsz, udoc.shape[0], device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(74)) < 0.5) \
            & (udoc >= 0)[None, :] & own[:, safe]
        ulanes = torch.where(keep, udoc[None, :], d_pad).to(torch.int32) \
            .contiguous()
        uvals = (month[safe] * u_card + users["val_ords"])[None, :] \
            .expand(bsz, -1).to(torch.float32).contiguous()
        uidx = ulanes.long()
        n_pairs = udoc.shape[0]
        record("binned_scatter", f"B={bsz} n={n_pairs} bins={d_pad} max "
               f"(dynamic child bins: one bin per doc)",
               lambda: tuple(binned.binned_scatter(ulanes, d_pad, uvals,
                                                   ("max",)).values()),
               lambda: tuple(binned.binned_scatter_plain(
                   ulanes, d_pad, uvals, ("max",)).values()),
               lambda: torch.full((bsz, d_pad + 1), float("-inf"),
                                  device=dev).scatter_reduce_(
                   1, uidx, uvals, "amax"),
               8 * bsz * n_pairs + 4 * bsz * d_pad, exact)
        del ulanes, uvals, uidx, keep
    if "k23" in parts:
        record("nested_agg", f"B={bsz} Dp={d_pad} root context",
               lambda: nested.nested_agg(mask, peff, arrays, path_ord, 1),
               lambda: nested.nested_agg_plain(
                   mask, peff, arrays["live"], arrays["nested_path"], pptr,
                   path_ord, 1),
               lambda: torch.bincount(torch.where(
                   own, child_eff + torch.arange(bsz, device=dev)[:, None],
                   bsz).reshape(-1), minlength=bsz + 1),
               (1 + 4 + 1 + 4) * elems + 9 * d_pad, exact)
    # reverse_nested under a monthly date_histogram of the answers
    rev_eff = torch.where(own, month[None, :], -1).to(torch.int32)
    if "k23" in parts or "k23r" in parts:
        record("reverse_nested_agg", f"B={bsz} Dp={d_pad} {months} monthly "
               f"buckets",
               lambda: nested.reverse_nested_agg(own, rev_eff, arrays,
                                                 months),
               lambda: nested.reverse_nested_agg_plain(own, rev_eff, pptr,
                                                       months),
               None, (1 + 4 + 1 + 4) * elems + 4 * d_pad, exact)
        # the same rows with a 10,000-row root: the first 10,000 nested
        # rows moved under the last root (the CTA's walk of a big root)
        from opensearch_tpu_torch.ops.device_segment import root_child_csr
        big_root = int(torch.nonzero(roots)[-1, 0])
        moved = torch.nonzero(pptr >= 0)[:10000, 0]
        pptr_h = pptr.clone()
        pptr_h[moved] = big_root
        start_h, rows_h = root_child_csr(pptr_h.cpu().numpy(), d_pad)
        seg_h = dict(arrays, parent_ptr=pptr_h,
                     child_start=torch.from_numpy(start_h).to(dev),
                     child_rows=torch.from_numpy(rows_h).to(dev))
        record("reverse_nested_agg", f"B={bsz} Dp={d_pad} {months} monthly "
               f"buckets, a 10,000-row root",
               lambda: nested.reverse_nested_agg(own, rev_eff, seg_h,
                                                 months),
               lambda: nested.reverse_nested_agg_plain(own, rev_eff, pptr_h,
                                                       months),
               None, (1 + 4 + 1 + 4) * elems + 4 * d_pad, exact)
        del seg_h, pptr_h, moved
    del arrays, nodes, child_s, child_m, sel, csel, mask, peff, own
    del child_eff, rev_eff, pidx
    torch.cuda.empty_cache()

    # ---- K24 / K25 on the geo cell
    t0 = time.perf_counter()
    arrays, meta = upload_segment(geo_seg, dev)
    d_pad = meta.d_pad
    elems = bsz * d_pad
    lat, exists, _ = dense_numeric(arrays, "location.lat", d_pad)
    lon, _, _ = dense_numeric(arrays, "location.lon", d_pad)
    pop, pexists, _ = dense_numeric(arrays, "population", d_pad)
    log(f"geo kernels: image uploaded and the columns made in "
        f"{time.perf_counter() - t0:.3f} s (Dp {d_pad})")
    country = arrays["ordinal"]["country_code"]["ords"]
    card = 20
    gen = torch.Generator(device=dev).manual_seed(72)
    floor = torch.rand(bsz, device=dev, generator=gen) * 2000
    elig = exists[None, :] & arrays["live"][None, :] \
        & (pop[None, :] >= floor[:, None])
    lanes = torch.where(elig & (country[None, :d_pad] < card),
                        country[None, :d_pad], card).to(torch.int32) \
        .contiguous()
    idx = lanes.long()

    def sums_check(idx, total):
        def check(got, want):
            exact(got, want)
            ok = idx < total
            v64 = torch.where(ok, lat[None, :], 0.0).double()
            truth = torch.zeros(bsz, total + 1, dtype=torch.float64,
                                device=dev).scatter_add_(1, idx, v64)
            mag = torch.zeros(bsz, total + 1, dtype=torch.float64,
                              device=dev).scatter_add_(1, idx, v64.abs())
            cnt = got[0].double()
            for side in (got, want):
                e = (side[1].double() - truth[:, :total]).abs()
                if not bool((e <= cnt * F32_SUM_EPS
                             * mag[:, :total]).all()):
                    raise AssertionError("K24 sums outside n * 2^-24 * "
                                         "sum|v|")
            return float((got[1] - want[1]).abs().max())
        return check
    if "k24" in parts:
        record("binned_scatter", f"B={bsz} n={d_pad} bins={card} cnt + sum "
               f"(geo_centroid lat under terms country_code)",
               lambda: tuple(binned.binned_scatter(lanes, card, lat,
                                                   ("cnt", "sum")).values()),
               lambda: tuple(binned.binned_scatter_plain(
                   lanes, card, lat, ("cnt", "sum")).values()),
               lambda: torch.zeros(bsz, card + 1, device=dev)
               .scatter_reduce_(1, idx, lat[None, :].expand(bsz, -1),
                                "sum"),
               4 * elems + 4 * d_pad + 8 * bsz * card, sums_check(idx, card),
               ops=float(elems))
        record("binned_scatter", f"B={bsz} n={d_pad} bins={card} cnt + min "
               f"+ max (geo_bounds lat)",
               lambda: tuple(binned.binned_scatter(
                   lanes, card, lat, ("cnt", "min", "max")).values()),
               lambda: tuple(binned.binned_scatter_plain(
                   lanes, card, lat, ("cnt", "min", "max")).values()),
               lambda: torch.full((bsz, card + 1), float("inf"),
                                  device=dev).scatter_reduce_(
                   1, idx, lat[None, :].expand(bsz, -1), "amin"),
               4 * elems + 4 * d_pad + 12 * bsz * card, exact)
        # past SCATTER_MAX_BINS bins: geo_centroid under terms country_code
        # -> 64 latitude bands, each lane's bin its parent bin x the card
        # + its band (as _dyn_pairs builds a bucket's lanes)
        bands = 64
        wide = GEONAMES_COUNTRIES * bands
        band = ((lat.double() + 90.0) * (bands / 180.0)).floor().clamp(
            0, bands - 1).to(torch.int32)
        cc = country[None, :d_pad]
        wlanes = torch.where(elig & (cc >= 0) & (cc < GEONAMES_COUNTRIES),
                             cc * bands + band[None, :], wide) \
            .to(torch.int32).contiguous()
        widx = wlanes.long()
        record("binned_scatter", f"B={bsz} n={d_pad} bins={wide} cnt + sum "
               f"(geo_centroid lat under terms country_code -> {bands} "
               f"latitude bands)",
               lambda: tuple(binned.binned_scatter(wlanes, wide, lat,
                                                   ("cnt", "sum")).values()),
               lambda: tuple(binned.binned_scatter_plain(
                   wlanes, wide, lat, ("cnt", "sum")).values()),
               lambda: torch.zeros(bsz, wide + 1, device=dev)
               .scatter_reduce_(1, widx, lat[None, :].expand(bsz, -1),
                                "sum"),
               4 * elems + 4 * d_pad + 8 * bsz * wide,
               sums_check(widx, wide), ops=float(elems))
        del wlanes, widx, band, cc
    if "k25" not in parts:
        del arrays, lanes, idx, elig
        torch.cuda.empty_cache()
        return results
    q = torch.rand(bsz, 2, device=dev, generator=gen)
    qlat = (q[:, 0] * 120 - 60).contiguous()
    qlon = (q[:, 1] * 360 - 180).contiguous()
    dist = torch.full((bsz,), 50000.0, device=dev)
    pivot = torch.full((bsz,), 10000.0, device=dev)
    ones = torch.ones(bsz, device=dev)
    top, bottom = (qlat + 2).contiguous(), (qlat - 2).contiguous()
    left, right = (qlon - 2).contiguous(), (qlon + 2).contiguous()
    cols = 9 * d_pad
    hav_ops = 30.0 * elems
    record("geo_distance_scores", f"B={bsz} Dp={d_pad} 50 km",
           lambda: geo.geo_distance(lat, lon, exists, qlat, qlon, dist,
                                    ones),
           lambda: geo.geo_distance_plain(lat, lon, exists, qlat, qlon,
                                          dist, ones),
           None, cols + 5 * elems, scores_bits, ops=hav_ops)
    record("geo_bbox_scores", f"B={bsz} Dp={d_pad} 4-degree boxes",
           lambda: geo.geo_bbox(lat, lon, exists, top, left, bottom, right,
                                ones),
           lambda: geo.geo_bbox_plain(lat, lon, exists, top, left, bottom,
                                      right, ones),
           None, cols + 5 * elems, scores_bits, ops=6.0 * elems)
    record("distance_feature_geo_scores", f"B={bsz} Dp={d_pad} pivot 10 km",
           lambda: geo.distance_feature_geo(lat, lon, exists, qlat, qlon,
                                            pivot, ones),
           lambda: geo.distance_feature_geo_plain(lat, lon, exists, qlat,
                                                  qlon, pivot, ones),
           None, cols + 5 * elems, scores_bits, ops=hav_ops + 3.0 * elems)
    ppiv = torch.full((bsz,), float(pop[pexists].mean()), device=dev)
    record("rank_feature_scores", f"B={bsz} Dp={d_pad} saturation",
           lambda: geo.rank_feature(pop, pexists, "saturation", ppiv, ones,
                                    ones, ones),
           lambda: geo.rank_feature_plain(pop, pexists, "saturation", ppiv,
                                          ones, ones, ones),
           None, 5 * d_pad + 5 * elems, scores_bits, ops=4.0 * elems)
    del arrays, lanes, idx, elig
    torch.cuda.empty_cache()
    return results


def _cell_walls(torch, np, node, index, bodies, bsz, name, card, out):
    """One family's B=1 `_search` p50 / p99 and B=32 `_msearch` p50 and
    q/s; every answer a 200. Returns the responses of the singles."""
    single, resps = [], []
    for b in bodies:
        t = time.perf_counter()
        r = node.request("POST", f"/{index}/_search", b)
        single.append((time.perf_counter() - t) * 1e3)
        if r["_status"] != 200:
            raise AssertionError(f"{name} _search: {r}")
        resps.append(r)
    batches = []
    for k in range(0, len(bodies), bsz):
        lines = []
        for b in bodies[k:k + bsz]:
            lines += [{"index": index}, b]
        t = time.perf_counter()
        r = node.request("POST", "/_msearch", lines)
        batches.append((time.perf_counter() - t) * 1e3)
        if any(x.get("status") != 200 for x in r["responses"]):
            raise AssertionError(f"{name} _msearch: {r['responses'][0]}")
    torch.cuda.synchronize()
    out[name] = {"search_p50_ms": _pct(np, single, 50),
                 "search_p99_ms": _pct(np, single, 99),
                 "msearch32_p50_ms": _pct(np, batches, 50),
                 "msearch32_qps": bsz * 1e3 / _pct(np, batches, 50)}
    log(f"{name}: B=1 _search p50 {out[name]['search_p50_ms']:.3f} p99 "
        f"{out[name]['search_p99_ms']:.3f} ms over {len(single)}; B={bsz} "
        f"_msearch p50 {out[name]['msearch32_p50_ms']:.3f} ms over "
        f"{len(batches)} ({out[name]['msearch32_qps']:.1f} queries/s); "
        f"card: {card}")
    return resps


def _cut_parity(np, gpu, cpu, index, bodies, what, tol_of):
    """Each body on the cut: the card's Node against Node(device='cpu')."""
    parity = _parity()
    for b in bodies:
        got = gpu.request("POST", f"/{index}/_search", b)
        want = cpu.request("POST", f"/{index}/_search", b)
        if got["_status"] != 200:
            raise AssertionError(f"{what} cut: {got}")
        parity.assert_same_response(got, want, what,
                                    agg_sum_tol=tol_of(want),
                                    score_rtol=SCORING_RTOL,
                                    score_atol=SCORING_ATOL)
    return len(bodies)


def phase_nested_cell(torch, np, qa_seg, card: str, out_dir=None,
                      bsz: int = 32,
                      per_family: int = NESTED_BODIES_PER_FAMILY,
                      cut_questions: int = NESTED_CUT_QUESTIONS):
    """The nested cell through Node().request, after rally-tracks' nested
    track: 2,000,000 StackOverflow-shaped questions (the track's ~11M cut
    to fit one segment's Dp 2^23 with their ~4.8M answers; answers.user a
    long id, not the track's keyword), eight families of 64 bodies
    (nested_cell_bodies): B=1 p50 / p99, B=32 p50 and q/s, the busy share
    of 6 profiled B=32 waves; every answer a 200; the terms family's
    answer counts against a numpy oracle (exact); then 8 bodies a family
    on a 20,000-question cut against Node(device='cpu')."""
    from opensearch_tpu_torch.node import Node
    from opensearch_tpu_torch.ops import _build
    from opensearch_tpu_torch.search import fetch as fetch_phase
    from opensearch_tpu_torch.utils.demo import (QA_MAPPING, qa_columns,
                                                 qa_segment)
    parity = _parity()
    log(f"nested cell: {NESTED_QUESTIONS} questions (rally nested: ~11M, "
        f"cut to one Dp 2^23 segment), answers.user a long id (the track's "
        f"is a keyword)")
    t0 = time.perf_counter()

    def index_of(node, segment):
        assert node.request("PUT", "/qa", {"mappings": QA_MAPPING})[
            "_status"] == 200
        shard = node.indices.get("qa").shards[0]
        shard.reader.add_segment(segment)
        return shard

    node = Node()
    shard = index_of(node, qa_seg)
    torch.cuda.synchronize()
    out = {"image_bytes": shard.reader.device_bytes(),
           "rows": qa_seg.num_docs}
    log(f"nested cell: image uploaded in {time.perf_counter() - t0:.3f} s: "
        f"{out['image_bytes']} bytes, {qa_seg.num_docs} rows")
    bodies = {f: nested_cell_bodies(np, f, per_family, 100 + i)
              for i, f in enumerate(NESTED_FAMILIES)}
    for f in NESTED_FAMILIES:      # first queries: plans, columns
        r = node.request("POST", "/qa/_search", bodies[f][0])
        if r["_status"] != 200:
            raise AssertionError(f"nested {f}: {r}")
    _build.reset_launches()
    copies0 = dict(fetch_phase.INNER_HITS_COPIES)
    resps = {}
    for f in NESTED_FAMILIES:
        resps[f] = _cell_walls(torch, np, node, "qa", bodies[f], bsz,
                               f"nested {f}", card, out)
    launches = dict(_build.LAUNCHES)
    tree = out["nested tree"]
    log(f"nested cell: the reverse_nested family (nested -> monthly "
        f"date_histogram -> reverse_nested -> terms tag): B=1 _search p50 "
        f"{tree['search_p50_ms']:.3f} ms, B={bsz} _msearch p50 "
        f"{tree['msearch32_p50_ms']:.3f} ms; card: {card}")
    log(f"nested cell: launches {json.dumps(launches)}")
    _require_launched(launches, ("nested_join", "nested_agg",
                                 "reverse_nested_agg", "binned_scatter",
                                 "pairs_match", "masked_topk"),
                      "nested cell")
    copies = {k: fetch_phase.INNER_HITS_COPIES[k] - copies0[k]
              for k in copies0}
    out["inner_hits_copies"] = copies
    log(f"nested cell: inner_hits copies {json.dumps(copies)} (one dense "
        f"(scores, matches) copy per (segment, nested query))")
    if not any(r["hits"]["hits"] for r in resps["avg"]):
        raise AssertionError("nested cell: the avg family matched nothing")
    # the terms family's counts against numpy at the full size
    n_ans, _tag, created, user, _date, _score = qa_columns(NESTED_QUESTIONS)
    ans_created = np.repeat(created, n_ans)
    for b, r in zip(bodies["terms_user"][:16], resps["terms_user"][:16]):
        w = b["query"]["range"]["creationDate"]
        sel = (ans_created >= w["gte"]) & (ans_created < w["lt"])
        counts = np.bincount(user[sel])
        order = sorted(np.nonzero(counts)[0], key=lambda u: (-counts[u], u))
        want = [{"key": int(u), "doc_count": int(counts[u])}
                for u in order[:10]]
        agg = r["aggregations"]["a"]
        got = [{"key": x["key"], "doc_count": x["doc_count"]}
               for x in agg["u"]["buckets"]]
        if agg["doc_count"] != int(sel.sum()) or got != want:
            raise AssertionError(f"nested terms: {got[:3]} != {want[:3]}")
    log("nested cell: 16 terms bodies' answer counts equal numpy's")
    for f in NESTED_FAMILIES:
        waves = (bodies[f] * 3)[:6 * bsz]
        out[f"nested {f}"].update(profile_waves(torch, shard.executor, waves,
                                                out_dir, f"nested_{f}"))
    del node, shard
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _m, cut = qa_segment(cut_questions, seed=7)
    gpu, cpu = Node(), Node(device="cpu")
    index_of(gpu, cut)
    index_of(cpu, cut)
    checked = 0
    for i, f in enumerate(NESTED_FAMILIES):
        checked += _cut_parity(np, gpu, cpu, "qa",
                               nested_cell_bodies(np, f, CUT_PAGES, 300 + i),
                               f"nested {f}", lambda w: {})
    log(f"nested cell: {checked} pages on a {cut_questions}-question cut "
        f"equal Node(device='cpu')'s in {time.perf_counter() - t0:.3f} s")
    out["checked_pages"] = checked
    return out


def phase_geo_cell(torch, np, geo_seg, card: str, out_dir=None,
                   bsz: int = 32, per_family: int = NESTED_BODIES_PER_FAMILY,
                   cut_places: int = GEO_CUT_PLACES):
    """The geo cell through Node().request, after rally-tracks' geonames
    track: 10,000,000 places around 5,000 seeded city centres (population
    a rank_feature here, the track's a long), seven families of 64 bodies
    (geo_cell_bodies): walls as the nested cell, the grid bodies' first
    query wall (the host cell keys); the bbox family's totals against
    numpy on the f32 columns (exact); the grid keys' vector form against
    the scalar functions on a seeded 100,000-place sample; then 8 bodies a
    family on a 200,000-place cut against Node(device='cpu')."""
    from opensearch_tpu_torch.node import Node
    from opensearch_tpu_torch.ops import _build
    from opensearch_tpu_torch.search.aggs.engine import (geohash_key,
                                                         geotile_key,
                                                         grid_buckets)
    from opensearch_tpu_torch.utils.demo import (GEONAMES_MAPPING,
                                                 geonames_columns,
                                                 geonames_segment)
    parity = _parity()
    log(f"geo cell: {GEO_PLACES} places (rally geonames: ~11.4M), "
        f"population mapped as rank_feature (the track's is a long)")
    centres, lat, lon, _country, _pop = geonames_columns(GEO_PLACES)
    # the grid keys' numpy form against the scalar (reference) form
    rng = np.random.default_rng(73)
    sample = rng.choice(GEO_PLACES, GRID_SAMPLE, replace=False)
    t0 = time.perf_counter()
    for kind, fn, prec in (("geohash_grid", geohash_key, 5),
                           ("geotile_grid", geotile_key, 8)):
        keys, bucket = grid_buckets(kind, lat[sample], lon[sample],
                                    np.ones(GRID_SAMPLE, bool), prec)
        want = [fn(a, o, prec) for a, o in zip(lat[sample], lon[sample])]
        if [keys[b] for b in bucket] != want:
            raise AssertionError(f"{kind}: numpy keys differ from the "
                                 f"scalar form")
    log(f"geo cell: geohash 5 and geotile 8 keys of {GRID_SAMPLE} sampled "
        f"places equal the scalar functions' ({time.perf_counter() - t0:.3f}"
        f" s)")
    t0 = time.perf_counter()

    def index_of(node, segment):
        assert node.request("PUT", "/geo", {"mappings": GEONAMES_MAPPING})[
            "_status"] == 200
        shard = node.indices.get("geo").shards[0]
        shard.reader.add_segment(segment)
        return shard

    node = Node()
    shard = index_of(node, geo_seg)
    torch.cuda.synchronize()
    out = {"image_bytes": shard.reader.device_bytes()}
    log(f"geo cell: image uploaded in {time.perf_counter() - t0:.3f} s: "
        f"{out['image_bytes']} bytes")
    bodies = {f: geo_cell_bodies(np, f, per_family, 200 + i, centres)
              for i, f in enumerate(GEO_FAMILIES)}
    for f in GEO_FAMILIES:
        t = time.perf_counter()
        r = node.request("POST", "/geo/_search", bodies[f][0])
        torch.cuda.synchronize()
        out[f"{f}_first_ms"] = (time.perf_counter() - t) * 1e3
        if r["_status"] != 200:
            raise AssertionError(f"geo {f}: {r}")
    log("geo cell: first queries " + json.dumps(
        {f: round(out[f"{f}_first_ms"], 3) for f in GEO_FAMILIES}))
    _build.reset_launches()
    resps = {}
    for f in GEO_FAMILIES:
        resps[f] = _cell_walls(torch, np, node, "geo", bodies[f], bsz,
                               f"geo {f}", card, out)
    launches = dict(_build.LAUNCHES)
    log(f"geo cell: launches {json.dumps(launches)}")
    _require_launched(launches, (
        "geo_distance_scores", "geo_bbox_scores",
        "distance_feature_geo_scores", "rank_feature_scores",
        "binned_scatter", "dense_numeric", "masked_topk"), "geo cell")
    lat32, lon32 = lat.astype(np.float32), lon.astype(np.float32)
    for b, r in zip(bodies["bbox"][:16], resps["bbox"][:16]):
        box = {k: np.float32(v) for k, v in
               b["query"]["geo_bounding_box"]["location"].items()}
        in_lat = (lat32 <= box["top"]) & (lat32 >= box["bottom"])
        in_lon = ((lon32 >= box["left"]) & (lon32 <= box["right"])) \
            if box["left"] <= box["right"] else \
            ((lon32 >= box["left"]) | (lon32 <= box["right"]))
        if r["hits"]["total"]["value"] != int((in_lat & in_lon).sum()):
            raise AssertionError(f"geo bbox total {r['hits']['total']}")
    log("geo cell: 16 bbox totals equal numpy's")
    for f in GEO_FAMILIES:
        waves = (bodies[f] * 3)[:6 * bsz]
        out[f"geo {f}"].update(profile_waves(torch, shard.executor, waves,
                                             out_dir, f"geo_{f}"))
    del node, shard
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _m, cut = geonames_segment(cut_places, seed=7)
    gpu, cpu = Node(), Node(device="cpu")
    index_of(gpu, cut)
    index_of(cpu, cut)
    checked = 0
    for i, f in enumerate(GEO_FAMILIES):
        # pages compare whole: a place within 4 ulps of a radius (where
        # the card's and the CPU's sines may disagree) would show here
        checked += _cut_parity(np, gpu, cpu, "geo",
                               geo_cell_bodies(np, f, CUT_PAGES, 400 + i,
                                               centres),
                               f"geo {f}", parity.centroid_tol)
    log(f"geo cell: {checked} pages on a {cut_places}-place cut equal "
        f"Node(device='cpu')'s in {time.perf_counter() - t0:.3f} s")
    out["checked_pages"] = checked
    return out


INGEST_DOCS = 200_000       # rally http_logs: ~247M log lines, cut
INGEST_BULK = 5_000         # docs a _bulk request
INGEST_REFRESH_EVERY = 4    # _bulk requests a refresh: 20,000-doc segments
INGEST_UPDATES = 2_000
INGEST_STALE = 200          # of them with a stale if_seq_no: each a 409
INGEST_DELETES = 2_000
INGEST_GETS = 200
INGEST_TAIL = 32            # single-doc writes with ?refresh=true
INGEST_BODIES = 64
INGEST_SMALL_DOCS = 40      # phase 2's small segment of the cell


def _expand_leaves(seg, raw: bool):
    """(path, host leaf, compact extents, fill) of every leaf of a
    segment's image that the delta publish compacts: the publish's
    power-of-two bucketed extents, or with `raw` the populated extents
    themselves (a ragged prefix, to hold the kernel on any shape)."""
    from opensearch_tpu_torch.index.segment import pad_bucket
    from opensearch_tpu_torch.ops.device_segment import (compact_spec,
                                                         segment_image)
    host, _meta = segment_image(seg)
    out = []
    for path, (ext, fill) in compact_spec(seg).items():
        leaf = host
        for key in path:
            leaf = leaf[key]
        c = tuple(f if e is None else min(
            max(int(e), 1) if raw else pad_bucket(max(int(e), 1), 8), f)
            for e, f in zip(ext, leaf.shape))
        out.append((path, leaf, c, fill))
    return out


def phase_expand_kernels(torch, np, agg_seg, sift_vectors, dev):
    """Row 16 expand_pad against its plain version (torch.full and a slice
    assignment) on the card, bit for bit, on every leaf kind: every leaf
    of a 40-doc segment of the ingest cell that the delta publish compacts
    (post_docs cut on both axes to its populated [NB, docs] prefix, the
    [F, Dp] norms, bool live, the `status` column's seven leaves, ...),
    phase 5's 10M-doc image (Dp 2^24: live, views' values / min_rank /
    exists, tag's doc ids), phase 6's vectors (1M x 128 into [2^20, 128])
    and phase 8's PQ codes (uniform random u8 [100,000, 128, 32] into
    [131,072, 128, 32]). Each big leaf timed as a graph replay, a call,
    the plain version and F.pad (the library call computing the same
    function); bound = (compact bytes + padded bytes) / 3.35 TB/s."""
    import torch.nn.functional as F
    from opensearch_tpu_torch.index.mapper import MapperService
    from opensearch_tpu_torch.index.segment import SegmentBuilder, pad_bucket
    from opensearch_tpu_torch.ops.device_segment import (expand_pad,
                                                         expand_pad_plain,
                                                         upload_segment)
    from opensearch_tpu_torch.utils.demo import (HTTP_LOGS_MAPPING,
                                                 http_logs_docs)
    results = {}

    def hold(name, x, full, fill, timed):
        got, again = expand_pad(x, full, fill), expand_pad(x, full, fill)
        want = expand_pad_plain(x, full, fill)
        torch.cuda.synchronize()
        if not (_same_bits(torch, got, want) and _same_bits(torch, got,
                                                            again)):
            raise AssertionError(f"expand_pad {name}: kernel and plain "
                                 f"version differ")
        if got.dtype != x.dtype or tuple(got.shape) != tuple(full):
            raise AssertionError(f"expand_pad {name}: {got.dtype} "
                                 f"{tuple(got.shape)}")
        if not timed:
            return
        pads = []
        for c, f in zip(reversed(x.shape), reversed(full)):
            pads += [0, f - c]
        width = x.element_size()
        bound = _bound((x.numel() + got.numel()) * width, 0.0)
        rec = {"shape": f"{name} {tuple(x.shape)} -> {tuple(full)} "
                        f"{str(x.dtype).replace('torch.', '')}",
               "max_abs_err": 0.0,
               "ms": graph_ms(torch, lambda: expand_pad(x, full, fill)),
               "call_ms": cuda_ms(torch, lambda: expand_pad(x, full, fill)),
               "plain_ms": cuda_ms(torch, lambda: expand_pad_plain(
                   x, full, fill), reps=5, warmup=1),
               "library_ms": cuda_ms(torch, lambda: F.pad(
                   x, pads, value=fill), reps=5, warmup=1),
               "bound_ms": bound[0], "bound_by": bound[1]}
        results.setdefault("expand_pad", []).append(rec)
        log("expand_pad", json.dumps(rec))

    # a small segment of the ingest cell: every compacted leaf, ragged
    mapper = MapperService(HTTP_LOGS_MAPPING)
    builder = SegmentBuilder(mapper, "small")
    for i, doc in enumerate(http_logs_docs(INGEST_SMALL_DOCS)):
        builder.add(mapper.parse_document(str(i), doc))
    small = builder.seal(device=dev)
    small.live[::7] = False
    held = 0
    for raw in (True, False):
        for path, leaf, c, fill in _expand_leaves(small, raw):
            x = torch.from_numpy(np.ascontiguousarray(
                leaf[tuple(slice(0, e) for e in c)])).to(dev)
            hold("/".join(path), x, leaf.shape, fill, timed=False)
            held += 1
    log(f"expand_pad: {held} leaves of a {INGEST_SMALL_DOCS}-doc ingest "
        f"segment (populated and bucketed prefixes) bit for bit")
    # phase 5's 10M-doc image
    arrays, meta = upload_segment(agg_seg, dev)
    nd = agg_seg.num_docs
    nv_views = len(agg_seg.numeric_dv["views"].doc_ids)
    nv_tag = len(agg_seg.ordinal_dv["tag"].doc_ids)
    for name, leaf, n, fill in (
            ("live", arrays["live"], nd, False),
            ("views/min_rank", arrays["numeric"]["views"]["min_rank"], nd,
             int(2 ** 31 - 1)),
            ("views/exists", arrays["numeric"]["views"]["exists"], nd,
             False),
            ("views/values_f32", arrays["numeric"]["views"]["values_f32"],
             nv_views, 0.0),
            ("tag/doc_ids", arrays["ordinal"]["tag"]["doc_ids"], nv_tag,
             -1)):
        hold(name, leaf[:n].contiguous(), tuple(leaf.shape), fill,
             timed=True)
    del arrays
    # phase 6's vectors and phase 8's PQ codes
    vecs = torch.from_numpy(sift_vectors).to(dev)
    hold("vectors", vecs, (pad_bucket(vecs.shape[0]), vecs.shape[1]), 0.0,
         timed=True)
    del vecs
    n_mx, t_mx, _dims = MAXSIM_SHAPE
    gen = torch.Generator(device=dev).manual_seed(16)
    codes = torch.randint(0, 256, (n_mx, t_mx, PQ_M), generator=gen,
                          device=dev, dtype=torch.uint8)
    hold("codes", codes, (pad_bucket(n_mx), t_mx, PQ_M), 0, timed=True)
    del codes
    torch.cuda.empty_cache()
    return results


def ingest_bodies(np, n: int, n_docs: int, seed: int = 91) -> list:
    """B=1 bodies of the ingest cell: a match on two request words, a
    one-hour range on @timestamp inside the loaded span, a terms agg on
    status."""
    from opensearch_tpu_torch.utils.demo import HTTP_LOGS_BASE_S
    rng = np.random.default_rng(seed)
    words = ("images", "english", "news", "gif", "html", "jpg", "scripts",
             "french", "js", "teams")
    span = n_docs // 3
    out = []
    for _ in range(n):
        a, b = rng.choice(len(words), 2, replace=False)
        lo = HTTP_LOGS_BASE_S + int(rng.integers(0, max(span - 3600, 1)))
        out.append({"query": {"bool": {
            "must": [{"match": {"request": f"{words[a]} {words[b]}"}}],
            "filter": [{"range": {"@timestamp": {"gte": lo,
                                                 "lt": lo + 3600}}}]}},
            "aggs": {"status": {"terms": {"field": "status"}}},
            "size": 10})
    return out


def _ingest_oracle(np, node, model, what: str) -> None:
    """_count, _count over a range of @timestamp and a terms agg on status
    against the host model of the live documents, exactly."""
    from collections import Counter
    from opensearch_tpu_torch.utils.demo import HTTP_LOGS_BASE_S
    r = node.request("POST", "/logs/_count")
    if r.get("count") != len(model):
        raise AssertionError(f"{what}: _count {r} != {len(model)}")
    lo, hi = HTTP_LOGS_BASE_S + 5000, HTTP_LOGS_BASE_S + 40000
    r = node.request("POST", "/logs/_count", {"query": {"range": {
        "@timestamp": {"gte": lo, "lt": hi}}}})
    want = sum(1 for d in model.values() if lo <= d["@timestamp"] < hi)
    if r.get("count") != want:
        raise AssertionError(f"{what}: range _count {r} != {want}")
    r = node.request("POST", "/logs/_search", {"size": 0, "aggs": {
        "s": {"terms": {"field": "status", "size": 20}}}})
    got = {b["key"]: b["doc_count"]
           for b in r["aggregations"]["s"]["buckets"]}
    want = Counter(d["status"] for d in model.values())
    if got != dict(want):
        raise AssertionError(f"{what}: status terms {got} != {dict(want)}")


def _check_images(torch, shard, checked: set, dev) -> int:
    """Every segment of the reader not yet checked: its published image
    against upload_segment of the same segment, leaf by leaf (shape,
    dtype, torch.equal)."""
    from opensearch_tpu_torch.ops.device_segment import upload_segment

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        else:
            yield path, tree
    n = 0
    for seg, (arrays, _meta) in zip(shard.reader.segments,
                                    shard.reader.device):
        key = (seg.seg_id, seg.live_doc_count)
        if key in checked:
            continue
        ref, _ = upload_segment(seg, dev)
        got, want = dict(leaves(arrays)), dict(leaves(ref))
        if got.keys() != want.keys():
            raise AssertionError(f"{seg.seg_id}: leaves differ")
        for path, t in got.items():
            w = want[path]
            if t.shape != w.shape or t.dtype != w.dtype \
                    or not torch.equal(t, w):
                raise AssertionError(f"{seg.seg_id}: the published "
                                     f"{'/'.join(path)} differs from "
                                     f"upload_segment's")
        checked.add(key)
        n += 1
    return n


def phase_ingest_cell(torch, np, card: str, out_dir=None,
                      n_docs: int = INGEST_DOCS, bulk: int = INGEST_BULK,
                      updates: int = INGEST_UPDATES,
                      stale: int = INGEST_STALE,
                      deletes: int = INGEST_DELETES,
                      gets: int = INGEST_GETS, tail: int = INGEST_TAIL,
                      n_bodies: int = INGEST_BODIES):
    """The ingest cell through Node().request, after rally-tracks'
    http_logs: log lines (`@timestamp`, `clientip` as a keyword, `request`,
    `status`, `size`) through `_bulk` in requests of 5,000 with a refresh
    after every fourth (ten segments of 20,000 docs, Dp 32,768) on a node
    with `indices.publish.delta: true`, and the same writes on a gate-off
    twin; then 2,000 `_update` partial docs on random earlier ids (200
    with a stale if_seq_no, each a 409), 2,000 deletes and a refresh, 32
    single-doc writes with ?refresh=true (the near-real-time tail:
    one-doc segments, whose leaves the delta publish compacts and
    expand_pad expands), and `_forcemerge` to one segment. Every
    published image equals upload_segment's leaf by leaf; `_count`, a
    range `_count` on @timestamp, a terms agg on status and GET of 200
    random ids (realtime before a refresh, and after one) equal a host
    model of the live documents. Returns the measurements and the
    launch counts of the path."""
    from opensearch_tpu_torch.node import Node
    from opensearch_tpu_torch.ops import _build
    from opensearch_tpu_torch.ops.device_segment import publish_segment
    from opensearch_tpu_torch.utils.demo import (HTTP_LOGS_MAPPING,
                                                 http_logs_docs)
    t_phase = time.perf_counter()
    docs = http_logs_docs(n_docs + tail)
    on = Node(settings={"indices.publish.delta": True})
    off = Node()
    for node in (on, off):
        if node.request("PUT", "/logs", {"mappings": HTTP_LOGS_MAPPING})[
                "_status"] != 200:
            raise AssertionError("ingest: index creation failed")
    s_on = on.indices.get("logs").shards[0]
    s_off = off.indices.get("logs").shards[0]
    dev = s_on.reader.torch_device
    # refresh walls split into the seal (engine) and the publish (reader,
    # to the card's completion)
    seal_ms, publish_ms = [], []
    real_seal, real_sync = s_on.engine.refresh, s_on._sync_reader

    def timed_seal():
        t = time.perf_counter()
        out = real_seal()
        seal_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def timed_sync():
        t = time.perf_counter()
        real_sync()
        torch.cuda.synchronize()
        publish_ms.append((time.perf_counter() - t) * 1e3)
    s_on.engine.refresh, s_on._sync_reader = timed_seal, timed_sync
    bodies = ingest_bodies(np, n_bodies, n_docs)
    checked = set()
    live_on, live_off = [], []

    def refresh_both(path="/logs/_refresh"):
        b_on, b_off = s_on.reader.live_mask_bytes, \
            s_off.reader.live_mask_bytes
        t = time.perf_counter()
        if on.request("POST", path)["_status"] != 200:
            raise AssertionError("ingest: refresh failed")
        wall = (time.perf_counter() - t) * 1e3
        off.request("POST", path)
        live_on.append(s_on.reader.live_mask_bytes - b_on)
        live_off.append(s_off.reader.live_mask_bytes - b_off)
        return wall

    _build.reset_launches()
    # ---- bulk load
    model = {}
    bulk_ms, refresh_ms, first_ms = [], [], []
    t_load = time.perf_counter()
    for r in range(n_docs // bulk):
        lines = []
        for i in range(r * bulk, (r + 1) * bulk):
            lines += [{"index": {"_index": "logs", "_id": str(i)}}, docs[i]]
            model[str(i)] = docs[i]
        t = time.perf_counter()
        res = on.request("POST", "/_bulk", lines)
        bulk_ms.append((time.perf_counter() - t) * 1e3)
        if res["_status"] != 200 or res["errors"]:
            raise AssertionError(f"ingest: _bulk failed: {res['items'][:1]}")
        off.request("POST", "/_bulk", lines)
        if (r + 1) % INGEST_REFRESH_EVERY == 0:
            refresh_ms.append(refresh_both())
            _check_images(torch, s_on, checked, dev)
            t = time.perf_counter()
            on.request("POST", "/logs/_search", bodies[r % len(bodies)])
            torch.cuda.synchronize()
            first_ms.append((time.perf_counter() - t) * 1e3)
    load_s = time.perf_counter() - t_load
    n_segs = len(s_on.reader.segments)
    d_pad = s_on.reader.device[0][1].d_pad
    log(f"ingest: {n_docs} docs in {n_docs // bulk} _bulk requests of "
        f"{bulk} in {load_s:.3f} s ({n_docs / sum(bulk_ms) * 1e3:.1f} "
        f"docs/s in _bulk, p50 {_pct(np, bulk_ms, 50):.3f} ms a request), "
        f"{n_segs} segments of Dp {d_pad}; refresh p50 "
        f"{_pct(np, refresh_ms, 50):.3f} ms (seal p50 "
        f"{_pct(np, seal_ms, 50):.3f}, publish p50 "
        f"{_pct(np, publish_ms, 50):.3f}); gate-on live-mask bytes a "
        f"refresh {live_on}, gate off {live_off}")
    _ingest_oracle(np, on, model, "ingest load")

    def walls(name):
        ms = []
        for b in bodies:
            t = time.perf_counter()
            r = on.request("POST", "/logs/_search", b)
            ms.append((time.perf_counter() - t) * 1e3)
            if r["_status"] != 200:
                raise AssertionError(f"ingest search: {r}")
        return {f"search_{name}_p50_ms": _pct(np, ms, 50),
                f"search_{name}_p99_ms": _pct(np, ms, 99)}
    out = {"docs": n_docs, "segments": n_segs, "d_pad": d_pad,
           "bulk_docs_per_s": n_docs / sum(bulk_ms) * 1e3,
           "bulk_p50_ms": _pct(np, bulk_ms, 50),
           "refresh_p50_ms": _pct(np, refresh_ms, 50),
           "refresh_p99_ms": _pct(np, refresh_ms, 99),
           "seal_p50_ms": _pct(np, seal_ms, 50),
           "seal_p99_ms": _pct(np, seal_ms, 99),
           "publish_p50_ms": _pct(np, publish_ms, 50),
           "publish_p99_ms": _pct(np, publish_ms, 99),
           "first_search_after_refresh_p50_ms": _pct(np, first_ms, 50),
           "live_mask_bytes_per_load_refresh_on": live_on[:],
           "live_mask_bytes_per_load_refresh_off": live_off[:]}
    out.update(walls(f"{n_segs}seg"))
    # a 20,000-doc segment for the gate-on/off publish cost, measured after
    # the launch counts are read
    seg20k = s_on.engine.segments[0]
    # ---- updates with CAS, realtime GETs
    rng = np.random.default_rng(23)
    ids = rng.integers(0, n_docs, updates)
    stale_at = set(rng.choice(updates, stale, replace=False).tolist())
    get_ms, update_ms, conflicts = [], [], 0
    for k, i in enumerate(ids):
        did = str(int(i))
        t = time.perf_counter()
        cur = on.request("GET", f"/logs/_doc/{did}")
        get_ms.append((time.perf_counter() - t) * 1e3)
        if cur.get("_source") != model[did]:
            raise AssertionError(f"ingest: GET {did} {cur} != {model[did]}")
        patch = {"status": int(rng.choice([200, 404, 500])),
                 "size": int(rng.integers(0, 50000))}
        seq = cur["_seq_no"]
        cas = {"if_seq_no": seq - 1 if seq > 0 else seq + 1} \
            if k in stale_at else {"if_seq_no": seq}
        cas["if_primary_term"] = cur["_primary_term"]
        t = time.perf_counter()
        res = on.request("POST", f"/logs/_update/{did}", {"doc": patch},
                         **cas)
        update_ms.append((time.perf_counter() - t) * 1e3)
        twin = off.request("POST", f"/logs/_update/{did}", {"doc": patch},
                           **cas)
        if k in stale_at:
            if res["_status"] != 409 or twin["_status"] != 409:
                raise AssertionError(f"ingest: stale update {res}")
            conflicts += 1
        elif res["_status"] != 200 or twin["_status"] != 200:
            raise AssertionError(f"ingest: update {res}")
        else:
            model[did] = {**model[did], **patch}
    probe = [str(int(i)) for i in rng.choice(ids, gets)]
    for when in ("before", "after"):
        for did in probe:
            r = on.request("GET", f"/logs/_doc/{did}")
            if not r.get("found") or r["_source"] != model[did]:
                raise AssertionError(f"ingest: realtime GET {did} {when} "
                                     f"the refresh: {r}")
        if when == "before":
            refresh_both()
            _check_images(torch, s_on, checked, dev)
    # ---- deletes and a refresh
    live_ids = sorted(model, key=int)
    gone = [live_ids[int(j)] for j in rng.choice(len(live_ids), deletes,
                                                 replace=False)]
    lines = [{"delete": {"_index": "logs", "_id": did}} for did in gone]
    for node in (on, off):
        res = node.request("POST", "/_bulk", lines)
        if res["errors"]:
            raise AssertionError(f"ingest: deletes {res['items'][:1]}")
    for did in gone:
        del model[did]
    out["delete_refresh_ms"] = refresh_both()
    out["live_mask_bytes_delete_refresh_on"] = live_on[-1]
    out["live_mask_bytes_delete_refresh_off"] = live_off[-1]
    _check_images(torch, s_on, checked, dev)
    _ingest_oracle(np, on, model, "ingest after updates and deletes")
    # ---- the near-real-time tail: one-doc segments
    tail_ms = []
    b_on, b_off = s_on.reader.live_mask_bytes, s_off.reader.live_mask_bytes
    pads_before_tail = _build.LAUNCHES["expand_pad"]
    for i in range(n_docs, n_docs + tail):
        for node in (on, off):
            t = time.perf_counter()
            r = node.request("PUT", f"/logs/_doc/{i}", docs[i],
                             refresh="true")
            if node is on:
                tail_ms.append((time.perf_counter() - t) * 1e3)
            if r["_status"] != 201:
                raise AssertionError(f"ingest: tail write {r}")
        model[str(i)] = docs[i]
    out["live_mask_bytes_tail_on"] = s_on.reader.live_mask_bytes - b_on
    out["live_mask_bytes_tail_off"] = s_off.reader.live_mask_bytes - b_off
    out["expand_pad_launches_tail"] = \
        _build.LAUNCHES["expand_pad"] - pads_before_tail
    if out["expand_pad_launches_tail"] == 0:
        raise AssertionError("ingest: the ?refresh=true writes launched no "
                             "expand_pad")
    _check_images(torch, s_on, checked, dev)
    one = next(s for s in s_on.engine.segments if s.num_docs == 1)
    out["tail_write_refresh_p50_ms"] = _pct(np, tail_ms, 50)
    # ---- force-merge to one segment (the twin does not merge)
    out["upload_bytes_on"] = s_on.reader.upload_bytes
    out["upload_bytes_off"] = s_off.reader.upload_bytes
    t = time.perf_counter()
    if on.request("POST", "/logs/_forcemerge")["_status"] != 200:
        raise AssertionError("ingest: _forcemerge failed")
    torch.cuda.synchronize()
    out["forcemerge_s"] = time.perf_counter() - t
    if len(s_on.reader.segments) != 1:
        raise AssertionError(f"ingest: {len(s_on.reader.segments)} "
                             f"segments after _forcemerge")
    _check_images(torch, s_on, checked, dev)
    _ingest_oracle(np, on, model, "ingest after the merge")
    for did in probe[:50]:
        r = on.request("GET", f"/logs/_doc/{did}", realtime="false")
        if r.get("found") != (did in model) or (
                did in model and r["_source"] != model[did]):
            raise AssertionError(f"ingest: GET {did} after the merge: {r}")
    out.update(walls("1seg"))
    launches = dict(_build.LAUNCHES)
    s_on.engine.refresh, s_on._sync_reader = real_seal, real_sync

    # ---- publish bytes and time, gate on and off, on the same segment:
    # direct publish_segment calls, outside the counted window
    def publish_cost(seg, delta):
        ms = []
        for _ in range(5):
            t = time.perf_counter()
            _a, _m, sent = publish_segment(seg, dev, delta)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        return sent, statistics.median(ms)
    for tag, seg in (("", seg20k), ("1doc_", one)):
        for delta in (True, False):
            sent, ms = publish_cost(seg, delta)
            out[f"publish_{tag}{'on' if delta else 'off'}_bytes"] = sent
            out[f"publish_{tag}{'on' if delta else 'off'}_ms"] = ms
    out.update({"get_p50_ms": _pct(np, get_ms, 50),
                "update_p50_ms": _pct(np, update_ms, 50),
                "update_conflicts": conflicts,
                "images_checked": len(checked),
                "upload_bytes_merge_on": s_on.reader.upload_bytes
                - out["upload_bytes_on"],
                "expand_pad_launches": launches["expand_pad"],
                "phase_s": time.perf_counter() - t_phase})
    if conflicts != stale:
        raise AssertionError(f"ingest: {conflicts} conflicts, not {stale}")
    if launches["expand_pad"] == 0:
        raise AssertionError("kernels not launched on the ingest path: "
                             "['expand_pad']")
    log(f"ingest: {json.dumps(out)}; card: {card}")
    del on, off
    torch.cuda.empty_cache()
    return out, launches


def require_clean_shards(what: str) -> None:
    """Every response so far was answered by every shard: no shard's query
    or fetch failed (search/controller.py SHARD_FAILURES, a `_shards.failed`
    entry) and the multi-shard program never raised and fell back to the
    per-shard host loop (search/spmd.py HOST_FALLBACKS)."""
    from opensearch_tpu_torch.search import controller, spmd
    failed, fell_back = controller.SHARD_FAILURES[0], spmd.HOST_FALLBACKS[0]
    if failed or fell_back:
        raise AssertionError(
            f"{what}: {failed} shard failures and {fell_back} fall-backs of "
            f"the multi-shard program to the host loop")


def phase_done(what: str, res) -> None:
    """A phase's end: require clean shards, then log its result."""
    require_clean_shards(what)
    log(f"{what}: " + json.dumps(res))


def _require_launched(launches, names, what: str) -> None:
    missing = [k for k in names if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {what} path: "
                             f"{missing}")


def launch_ms(torch, fn, calls: int = 3, by_name: bool = False):
    """[[kernel, median device ms], ...] of one call of fn, in launch
    order, from a torch.profiler (CUPTI) trace of `calls` calls after a
    warm one; with `by_name`, {kernel: device ms a call}, each kernel's
    launches in the trace summed and divided by `calls`. Memsets are left
    out (the trace may drop one, which would shift every later launch);
    the list is empty when the calls' kernels differ or the trace holds
    none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    # the trace lists device events by their host op: order them by start
    events = sorted((e for e in prof.events()
                     if e.device_type.name == "CUDA"
                     and not e.name.startswith(("Memset", "Memcpy"))),
                    key=lambda e: e.time_range.start)

    def short(name):
        name = name.replace("(anonymous namespace)::", "")
        return name.split("(")[0].split("<")[0].replace("void ", "").strip()
    if by_name:
        out = {}
        for e in events:
            name = short(e.name)
            out[name] = out.get(name, 0.0) + e.device_time_total / 1e3 / calls
        return out
    per = len(events) // calls
    names = [[short(e.name) for e in events[c * per:(c + 1) * per]]
             for c in range(calls)]
    if per == 0 or len(events) % calls or any(n != names[0] for n in names):
        return []
    return [[names[0][i], statistics.median(
        events[i + c * per].device_time_total / 1e3 for c in range(calls))]
        for i in range(per)]


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


CELLS = ("scale", "knn", "maxsim", "hybrid", "sorted", "aggkinds",
         "relevance", "sharded", "nested", "geo", "ingest", "topk",
         "binned", "textpq", "aggs")


def run_cells(torch, np, cells, card: str, out_dir=None) -> int:
    """The named cells alone, each on its own corpus as the full run makes
    it; prints `{"run": name, "card": ..., <the phase's results>}` per
    cell, then the result line."""
    from opensearch_tpu_torch.utils.demo import build_shards_fast
    unknown = sorted(set(cells) - set(CELLS))
    if unknown:
        print(f"chip_smoke: unknown cells {unknown}", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    for cell in cells:
        if cell in ("scale", "relevance", "hybrid", "sharded"):
            mapper, (seg,), terms = build_shards_fast(
                SCALE_DOCS, 1, vocab_size=20000, avg_len=60, seed=42,
                materialize_terms=SCALE_MATERIALIZE_TERMS)
            if cell == "scale":
                res = phase_scale(torch, np, mapper, seg, dev, out_dir)
            elif cell == "relevance":
                res = phase_relevance_cell(torch, np, mapper, seg, terms,
                                           card, out_dir)
            elif cell == "hybrid":
                res = phase_hybrid_cell(torch, np, mapper, seg, sorted(
                    t for _, t in seg.term_dict), dev, card, out_dir)
            else:
                _am, agg_seg = agg_segment(np, AGG_SCALE_DOCS)
                res = phase_sharded_cell(
                    torch, np, mapper, seg, sorted(
                        t for _, t in seg.term_dict), agg_seg,
                    sorted_segments(np, AGG_SCALE_DOCS), dev, card, out_dir)
                del agg_seg
        elif cell == "knn":
            mapper = seg = None
            res = phase_knn_cell(torch, np, "exact",
                                 knn_corpora(np, names=("sift",)), dev, card,
                                 out_dir)
        elif cell == "maxsim":
            mapper = seg = None
            res = phase_maxsim_cell(torch, np, maxsim_corpus(torch, np, dev),
                                    dev, card, out_dir)
        elif cell in ("nested", "geo"):
            from opensearch_tpu_torch.utils.demo import (geonames_segment,
                                                         qa_segment)
            mapper, seg = qa_segment(NESTED_QUESTIONS) if cell == "nested" \
                else geonames_segment(GEO_PLACES)
            res = (phase_nested_cell if cell == "nested" else
                   phase_geo_cell)(torch, np, seg, card, out_dir)
        elif cell == "ingest":
            mapper = seg = None
            res, _launches = phase_ingest_cell(torch, np, card, out_dir)
        elif cell == "topk":
            mapper = seg = None
            res = phase_topk_cell(torch, np, dev)
        elif cell == "binned":
            mapper = seg = None
            res = phase_binned_cell(torch, np, dev)
        elif cell == "textpq":
            mapper = seg = None
            res = phase_textpq_cell(torch, np, dev)
        elif cell == "aggs":
            mapper, seg = agg_segment(np, AGG_SCALE_DOCS)
            res = phase_agg_scale(torch, np, mapper, seg, dev, out_dir)
        elif cell == "sorted":
            mapper, seg = agg_segment(np, AGG_SCALE_DOCS)
            res = phase_sorted_cell(torch, np, mapper, seg,
                                    sorted_segments(np, AGG_SCALE_DOCS),
                                    card, out_dir)
        else:
            mapper, seg = taxi_segment(np, AGG_SCALE_DOCS)
            res = phase_aggkind_cell(torch, np, mapper, seg, card, out_dir)
        require_clean_shards(cell)
        print(json.dumps({"run": cell, "card": card, **res}), flush=True)
        del mapper, seg
        torch.cuda.empty_cache()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None,
                        help="directory for the long outputs (nvcc's ptxas "
                             "report, the profiler's kernel table)")
    parser.add_argument("--cells", default=None,
                        help="run only these cells after the build, comma "
                             "separated: " + ", ".join(CELLS) + " (phases "
                             "4, 6, 8, 9, 10, 11, 12, 13, 14, 15 and 16; knn "
                             "is phase 6's exact cell; topk, binned and "
                             "textpq phase 2's records of K3, of K5 / K6 / "
                             "K23 / K24 and of K2 (both entries) / K11's "
                             "scorer; aggs phase 5): one JSON line each, to "
                             "compare two checkouts on one card")
    args = parser.parse_args(argv)
    out_dir = args.out
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

    global _LOG_FILE
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        _LOG_FILE = open(os.path.join(out_dir, "log.txt"), "w")
    t_all = time.perf_counter()
    # phase 1: build and card
    took = _build.build_all()
    log("build: " + json.dumps({k: round(v, 3) for k, v in took.items()})
        + " s (parallel nvcc, one library per source)")
    if out_dir is not None:
        with open(os.path.join(out_dir, "nvcc_log.txt"), "w") as f:
            for name, text in _build.BUILD_LOG.items():
                f.write(f"--- {name}\n{text}\n")
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    dev = torch.device("cuda")
    if args.cells:
        return run_cells(torch, np, args.cells.split(","), card, out_dir)

    t0 = time.perf_counter()
    mapper, segs, terms = build_shards_fast(
        SCALE_DOCS, 1, vocab_size=20000, avg_len=60, seed=42,
        materialize_terms=SCALE_MATERIALIZE_TERMS)
    seg = segs[0]
    log(f"corpus: {seg.num_docs} passages, {len(seg.term_dict)} "
        f"materialized terms, {seg.post_docs.shape[0]} posting blocks, "
        f"built in {time.perf_counter() - t0:.3f} s")
    arrays, meta = upload_segment(seg, dev)
    agg_mapper, agg_seg = agg_segment(np, AGG_SCALE_DOCS)
    four = sorted_segments(np, AGG_SCALE_DOCS)
    taxi_mapper, taxi_seg = taxi_segment(np, AGG_SCALE_DOCS)
    corpora = knn_corpora(np)
    mc = maxsim_corpus(torch, np, dev)
    # K11's codebook: the port's host train_pq on a 20,000-token sample,
    # trained on a worker thread (numpy releases the GIL) while the card
    # runs the phases before K11's check
    from concurrent.futures import ThreadPoolExecutor
    from opensearch_tpu_torch.ops.maxsim import train_pq
    pool = ThreadPoolExecutor(max_workers=1)
    t_pq = time.perf_counter()
    codebook_job = pool.submit(train_pq, pq_sample(np, mc), PQ_M)

    # phase 2: kernels against their plain versions on the card
    log(f"timing: a median of up to 15 reps, fewer for a call slower than "
        f"{TIMING_BUDGET_MS / 15:.1f} ms (about {TIMING_BUDGET_MS:.0f} ms "
        f"of reps, at least one)")
    results = phase_kernels(torch, np, seg, mapper, arrays, meta, dev)
    del arrays
    results.update(phase_agg_kernels(torch, np, agg_mapper, agg_seg, dev))
    results.update(phase_knn_kernels(torch, np, corpora, dev))
    # the nested and geo cells' segments, built on the host while the
    # codebook still trains
    t0 = time.perf_counter()
    from opensearch_tpu_torch.utils.demo import geonames_segment, qa_segment
    _qm, qa_seg = qa_segment(NESTED_QUESTIONS)
    _gm, geo_seg = geonames_segment(GEO_PLACES)
    log(f"nested and geo cells: {NESTED_QUESTIONS} questions in "
        f"{qa_seg.num_docs} rows and {GEO_PLACES} places built in "
        f"{time.perf_counter() - t0:.3f} s")
    codebook = codebook_job.result()
    pool.shutdown()
    log(f"pq codebook: [{PQ_M}, 256, {MAXSIM_SHAPE[2] // PQ_M}] trained by "
        f"train_pq on {PQ_SAMPLE} sampled tokens "
        f"{time.perf_counter() - t_pq:.3f} s after set-up began")
    results.update(phase_maxsim_kernels(torch, np, mc, codebook, dev))
    results.update(phase_sort_kernels(torch, np, agg_seg, four, dev))
    results.update(phase_aggkind_kernels(torch, np, taxi_mapper, taxi_seg,
                                         dev))
    results.update(phase_scoring_kernels(torch, np, mapper, seg, terms,
                                         dev))
    results.update(phase_spmd_kernels(torch, np, mapper, seg, sorted(
        t for _, t in seg.term_dict), agg_seg, dev))
    results.update(phase_nested_geo_kernels(torch, np, qa_seg, geo_seg, dev))
    results.update(phase_expand_kernels(torch, np, agg_seg,
                                        corpora["sift"][0], dev))
    # phase 3: the main path, serving on the card
    launches = phase_serving(torch, np)
    require_clean_shards("serving")
    # phase 4: BM25 scale
    scale = phase_scale(torch, np, mapper, seg, dev, out_dir)
    phase_done("scale", scale)
    # phase 5: aggregation scale
    agg_scale = phase_agg_scale(torch, np, agg_mapper, agg_seg, dev,
                                out_dir)
    phase_done("agg scale", agg_scale)
    # phases 6 and 7: the k-NN cells
    for cell in ("exact", "ivf"):
        res = phase_knn_cell(torch, np, cell, corpora, dev, card, out_dir)
        phase_done(f"knn {cell}", res)
    del corpora
    # phase 8: the MaxSim cell
    res = phase_maxsim_cell(torch, np, mc, dev, card, out_dir)
    phase_done("maxsim", res)
    del mc
    # phase 9: the hybrid cell, over phase 4's passages
    res = phase_hybrid_cell(torch, np, mapper, seg, sorted(
        t for _, t in seg.term_dict), dev, card, out_dir)
    phase_done("hybrid", res)
    # phase 10: the sorted cell, over phase 5's docs
    log(f"sorted: the deep search_after body at {SORTED_DEEP_SINGLES} B=1 "
        f"requests an index (cut from 20 to keep the run in its time "
        f"limit)")
    res = phase_sorted_cell(torch, np, agg_mapper, agg_seg, four, card,
                            out_dir)
    phase_done("sorted", res)
    # phase 11: the agg-kinds cell
    res = phase_aggkind_cell(torch, np, taxi_mapper, taxi_seg, card,
                             out_dir)
    phase_done("agg kinds", res)
    del taxi_seg
    # phase 12: the relevance cell, over phase 4's passages
    res = phase_relevance_cell(torch, np, mapper, seg, terms, card, out_dir)
    phase_done("relevance", res)
    # phase 13: the sharded cell (5 shards, block-max, logs-*)
    log(f"sharded: the logs-* bodies at {LOGS_SINGLES} B=1 requests a route "
        f"(cut from 50 to keep the run in its time limit)")
    res = phase_sharded_cell(torch, np, mapper, seg, sorted(
        t for _, t in seg.term_dict), agg_seg, four, dev, card, out_dir)
    phase_done("sharded", res)
    del agg_seg, four
    # phase 14: the nested cell
    res = phase_nested_cell(torch, np, qa_seg, card, out_dir)
    phase_done("nested", res)
    del qa_seg
    # phase 15: the geo cell
    res = phase_geo_cell(torch, np, geo_seg, card, out_dir)
    phase_done("geo", res)
    del geo_seg
    # phase 16: the ingest cell (the write path and the delta publish)
    res, ingest_launches = phase_ingest_cell(torch, np, card, out_dir)
    require_clean_shards("ingest")
    launches["expand_pad"] = ingest_launches["expand_pad"]

    # one representative shape per kernel for the kernels line: the B=32
    # main-path batch (K1 at 4 terms / 16,384 lanes, K3 at k=100; K4 the
    # identity range, K5 the fused cardinality, K6 the avg sums, K24 the
    # geo_centroid cnt + sum)
    pick = {"bm25_candidate": 4, "score_text_clause": 1, "masked_topk": 4,
            "pairs_match": 0, "binned_popcount": 0, "binned_reduce": 0,
            "knn_exact": 0, "knn_topk_mark": 0, "ivf_probe": 0,
            "ivf_block_keys": 0, "kmeans_step": 0, "maxsim_exact": 1,
            "pq_lut": 0, "maxsim_pq": 1, "hybrid_window": 0,
            "masked_topk_threshold": 0, "sort_key": 0,
            "masked_topk_keyed": 0, "page_merge": 0, "dense_numeric": 0,
            "matrix_moments": 0, "adjacency_counts": 0, "function_score": 0,
            "terms_set_scores": 0, "distance_feature_scores": 0,
            "boosting_scores": 0, "script_score_wrap": 0,
            "blockmax_keep": 1, "bm25_candidate_keep": 1,
            "score_text_clause_keep": 1, "row_merge": 0,
            "row_value_key": 0, "nested_join": 0, "nested_agg": 0,
            "reverse_nested_agg": 0, "binned_scatter": 1,
            "geo_distance_scores": 0, "geo_bbox_scores": 0,
            "distance_feature_geo_scores": 0, "rank_feature_scores": 0,
            "expand_pad": 5}
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
        "knn_exact": ("opensearch_tpu_torch/ops/csrc/knn_exact.cu",
                      "opensearch_tpu/ops/knn.py:38"),
        "knn_topk_mark": ("opensearch_tpu_torch/ops/csrc/knn_exact.cu",
                          "opensearch_tpu/ops/knn.py:68"),
        "ivf_probe": ("opensearch_tpu_torch/ops/csrc/ivf_probe.cu",
                      "opensearch_tpu/ops/knn.py:200"),
        "ivf_block_keys": ("opensearch_tpu_torch/ops/csrc/ivf_probe.cu",
                           "opensearch_tpu/ops/knn.py:218"),
        "kmeans_step": ("opensearch_tpu_torch/ops/csrc/kmeans_step.cu",
                        "opensearch_tpu/ops/knn.py:120"),
        "maxsim_exact": ("opensearch_tpu_torch/ops/csrc/maxsim_exact.cu",
                         "opensearch_tpu/ops/maxsim.py:76"),
        "pq_lut": ("opensearch_tpu_torch/ops/csrc/maxsim_pq.cu",
                   "opensearch_tpu/ops/maxsim.py:100"),
        "maxsim_pq": ("opensearch_tpu_torch/ops/csrc/maxsim_pq.cu",
                      "opensearch_tpu/ops/maxsim.py:110"),
        "hybrid_window": ("opensearch_tpu_torch/ops/csrc/hybrid_window.cu",
                          "opensearch_tpu/search/executor.py:1750"),
        "masked_topk_threshold": (
            "opensearch_tpu_torch/ops/csrc/masked_topk.cu",
            "opensearch_tpu/ops/knn.py:68"),
        "sort_key": ("opensearch_tpu_torch/ops/csrc/sort_key.cu",
                     "opensearch_tpu/search/executor.py:1903"),
        "masked_topk_keyed": (
            "opensearch_tpu_torch/ops/csrc/masked_topk.cu",
            "opensearch_tpu/search/executor.py:1157"),
        "page_merge": ("opensearch_tpu_torch/ops/csrc/page_merge.cu",
                       "opensearch_tpu/search/executor.py:2028"),
        "dense_numeric": ("opensearch_tpu_torch/ops/csrc/dense_numeric.cu",
                          "opensearch_tpu/search/plan_eval.py:59"),
        "matrix_moments": (
            "opensearch_tpu_torch/ops/csrc/matrix_moments.cu",
            "opensearch_tpu/search/aggs/engine.py:1629"),
        "adjacency_counts": (
            "opensearch_tpu_torch/ops/csrc/adjacency_counts.cu",
            "opensearch_tpu/search/aggs/engine.py:1611"),
        "function_score": ("opensearch_tpu_torch/ops/csrc/function_score.cu",
                           "opensearch_tpu/search/plan_eval.py:261"),
        "terms_set_scores": ("opensearch_tpu_torch/ops/csrc/score_kinds.cu",
                             "opensearch_tpu/search/plan_eval.py:392"),
        "distance_feature_scores": (
            "opensearch_tpu_torch/ops/csrc/score_kinds.cu",
            "opensearch_tpu/search/plan_eval.py:413"),
        "boosting_scores": ("opensearch_tpu_torch/ops/csrc/score_kinds.cu",
                            "opensearch_tpu/search/plan_eval.py:463"),
        "script_score_wrap": (
            "opensearch_tpu_torch/ops/csrc/score_kinds.cu",
            "opensearch_tpu/search/plan_eval.py:246"),
        "blockmax_keep": ("opensearch_tpu_torch/ops/csrc/blockmax_keep.cu",
                          "opensearch_tpu/ops/bm25.py:54"),
        "bm25_candidate_keep": (
            "opensearch_tpu_torch/ops/csrc/bm25_candidate.cu",
            "opensearch_tpu/search/executor.py:1351"),
        "score_text_clause_keep": (
            "opensearch_tpu_torch/ops/csrc/score_text_clause.cu",
            "opensearch_tpu/parallel/distributed.py:357"),
        "row_merge": ("opensearch_tpu_torch/ops/csrc/row_merge.cu",
                      "opensearch_tpu/parallel/distributed.py:397"),
        "row_value_key": ("opensearch_tpu_torch/ops/csrc/row_merge.cu",
                          "opensearch_tpu/ops/topk.py:61"),
        "nested_join": ("opensearch_tpu_torch/ops/csrc/nested_join.cu",
                        "opensearch_tpu/search/plan_eval.py:100"),
        "nested_agg": ("opensearch_tpu_torch/ops/csrc/nested_aggs.cu",
                       "opensearch_tpu/search/aggs/engine.py:1559"),
        "reverse_nested_agg": (
            "opensearch_tpu_torch/ops/csrc/nested_aggs.cu",
            "opensearch_tpu/search/aggs/engine.py:1579"),
        "binned_scatter": ("opensearch_tpu_torch/ops/csrc/binned_scatter.cu",
                           "opensearch_tpu/search/aggs/engine.py:1115"),
        "geo_distance_scores": ("opensearch_tpu_torch/ops/csrc/geo_scores.cu",
                                "opensearch_tpu/search/plan_eval.py:443"),
        "geo_bbox_scores": ("opensearch_tpu_torch/ops/csrc/geo_scores.cu",
                            "opensearch_tpu/search/plan_eval.py:451"),
        "distance_feature_geo_scores": (
            "opensearch_tpu_torch/ops/csrc/geo_scores.cu",
            "opensearch_tpu/search/plan_eval.py:420"),
        "rank_feature_scores": ("opensearch_tpu_torch/ops/csrc/geo_scores.cu",
                                "opensearch_tpu/search/plan_eval.py:428"),
        "expand_pad": ("opensearch_tpu_torch/ops/csrc/expand_pad.cu",
                       "opensearch_tpu/ops/device_segment.py:314"),
    }
    kernels = []
    for name in _build.LAUNCHES:
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
                        "call_ms": rec["call_ms"], "shape": rec["shape"],
                        **{k: rec[k] for k in ("peak_scratch_bytes",)
                           if k in rec}})
    log(f"total wall {time.perf_counter() - t_all:.3f} s; card: {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
