"""The multi-shard query phase (search/spmd.py, parallel/distributed.py,
K21) of opensearch_tpu_torch held against opensearch_tpu:

- the port's program against the reference's `spmd_query_phase` on the
  same 3-shard index (candidates with their sort values, totals, and the
  reduced aggregation partials), and against the port's own host loop;
- K21's plain version against a numpy merge (key descending, then row,
  then rank), and its key entry against the reference's value_merge_key;
- a 9-row index takes the port's host loop (its cap is 8 rows on one
  card), which equals the reference's host loop;
- a row kernel that fails, or any other fault of the card, raises out of
  the request: nothing falls back to the host loop;
- any other error of the multi-shard program sends the request to the
  per-shard host loop, as the reference's does (logged and counted in
  `spmd.HOST_FALLBACKS`).
"""

import contextlib
import json

import numpy as np
import pytest
import torch

from opensearch_tpu.node import Node as JNode
from opensearch_tpu.ops.topk import value_merge_key as j_value_merge_key
from opensearch_tpu.search import spmd as jspmd
from opensearch_tpu.search.aggs.reduce import reduce_aggs as j_reduce

from opensearch_tpu_torch.node import Node as TNode
from opensearch_tpu_torch.ops import _build
from opensearch_tpu_torch.ops import spmd as kspmd
from opensearch_tpu_torch.parallel import distributed as tdist
from opensearch_tpu_torch.search import controller as tcontroller
from opensearch_tpu_torch.search import spmd as tspmd
from opensearch_tpu_torch.search.aggs.reduce import reduce_aggs as t_reduce
from opensearch_tpu_torch.search.controller import execute_search

from test_torch_common import (AGG_BODIES, DOCS_MAPPING,
                               assert_same_response, bulk_ndjson,
                               docs_corpus)

N_DOCS = 900


def _load(node, index, shards, refreshes):
    body = json.loads(json.dumps(DOCS_MAPPING))
    body["settings"] = {"number_of_shards": shards}
    assert node.request("PUT", f"/{index}", body)["_status"] == 200
    docs = docs_corpus(N_DOCS)
    step = -(-N_DOCS // refreshes)
    for r in range(refreshes):
        part = {f"d{i}": docs[i]
                for i in range(r * step, min(N_DOCS, (r + 1) * step))}
        deletes = [f"d{i}" for i in range(7, r * step, 61)]
        res = node.request("POST", "/_bulk", bulk_ndjson(index, part,
                                                         deletes))
        assert not res["errors"]
        node.request("POST", f"/{index}/_refresh")


@pytest.fixture(scope="module")
def nodes():
    """idx3: 3 shards x 2 segments (6 rows); idx9: 3 shards x 3 segments
    (9 rows)."""
    jn, tn = JNode(), TNode(device="cpu")
    for node in (jn, tn):
        _load(node, "idx3", 3, 2)
        _load(node, "idx9", 3, 3)
    return jn, tn


def _executors(node, index):
    return [s.executor for s in node.indices.get(index).shards]


BODIES = {
    "match": {"query": {"match": {"body": "w00011 w00004 w00002"}},
              "size": 10},
    "bool": {"query": {"bool": {
        "must": [{"match": {"body": "w00021 w00005"}}],
        "filter": [{"range": {"views": {"gte": 1000}}}]}}},
    "views_desc": {"query": {"match": {"body": "w00006 w00011"}},
                   "sort": [{"views": "desc"}]},
    "views_asc": {"sort": [{"views": "asc"}]},
    "aggs": {**AGG_BODIES["terms_metrics"]},
    "date_hist": {**AGG_BODIES["date_hist_sub"]},
    "min_score": {"query": {"match": {"body": "w00011 w00004"}},
                  "min_score": 1.5},
    "term": {"query": {"term": {"tag": "cat1"}}},
    "bool_should": {"query": {"bool": {
        "must": [{"match": {"body": "w00021"}}],
        "should": [{"match": {"body": "w00005"}}]}}},
    "date_histogram": {"query": {"match": {"body": "w00011"}}, "aggs": {
        "d": {"date_histogram": {"field": "ts", "fixed_interval": "1d"}}}},
}
# bodies whose rows compile to diverging structures on this corpus (a
# doc-value column whose layout differs between segments): both packages
# decline the program and run the host loop
DECLINED = ("bool", "aggs", "date_hist")


@pytest.mark.parametrize("k", [10, 100, 5000])
@pytest.mark.parametrize("name", sorted(BODIES))
def test_program_equals_reference_program(nodes, name, k):
    """Candidates (score, segment, doc, sort values, shard), the total
    and the reduced agg partials equal the reference's program's on the
    same rows; the port's k_r = min(k, the row's Dp) gives the reference's
    candidates at its common stacked Dp once its -inf slots drop."""
    jn, tn = nodes
    body = BODIES[name]
    jex, tex = _executors(jn, "idx3"), _executors(tn, "idx3")
    rows = tspmd.spmd_rows(tex)
    assert rows == jspmd.spmd_rows(jex) and len(rows) == 6
    want = jspmd._spmd_query_phase_raw(jex, body, k, None, rows)
    got = tspmd.spmd_query_phase(tex, body, k, rows)
    # both decline (rows of diverging structures: the host loop) or both
    # answer; the query bodies always answer
    assert (got is None) == (want is None) == (name in DECLINED)
    if want is None:
        return
    wc, wdec, wtot, wpr = want
    gc, gdec, gtot, gpr = got
    assert gtot == wtot and gpr == wpr == 0
    assert len(gc) == len(wc)
    for c, (score, seg_i, ord_, sv, shard_i) in zip(gc, wc):
        assert (c.seg_i, c.ord, c.shard_i) == (seg_i, ord_, shard_i)
        assert c.score == pytest.approx(score, rel=1e-6)
        if body.get("sort"):
            assert c.sort_values == sv
    if wdec:
        assert_same_response(t_reduce(gdec), j_reduce(wdec))


@pytest.mark.parametrize("name", sorted(set(BODIES) - set(DECLINED)))
def test_program_equals_host_loop(nodes, name):
    """The port's program against its own host loop on the same index:
    the same response (a sorted body's max_score aside, which the host
    loop takes over its larger pool)."""
    _jn, tn = nodes
    body = dict(BODIES[name], size=12)
    t0 = tspmd.SPMD_QUERIES[0]
    got = tn.request("POST", "/idx3/_search", body)
    assert tspmd.SPMD_QUERIES[0] == t0 + 1
    with tspmd.force_host_loop():
        want = tn.request("POST", "/idx3/_search", body)
    assert tspmd.SPMD_QUERIES[0] == t0 + 1
    assert_same_response(got, want)


def test_nine_rows_take_the_host_loop(nodes):
    """Nine rows exceed the port's pack of 8 (one card): its host loop
    answers, equal to the reference's host loop."""
    jn, tn = nodes
    assert len(tspmd.spmd_rows(_executors(tn, "idx9"))) == 9
    for body in BODIES.values():
        t0 = tspmd.SPMD_QUERIES[0]
        got = tn.request("POST", "/idx9/_search", body)
        assert tspmd.SPMD_QUERIES[0] == t0
        with jspmd.force_host_loop():
            want = jn.request("POST", "/idx9/_search", body)
        assert_same_response(got, want)


def test_row_failure_raises(nodes, monkeypatch):
    """A row kernel that fails raises out of the request: no catch drops
    the request to the host loop (a kernel's failure is the node's, so
    the port does not take the reference's fall-back for it)."""
    _jn, tn = nodes
    tex = _executors(tn, "idx3")
    calls = []
    for ex in tex:
        real = ex.execute_query_phase
        monkeypatch.setattr(ex, "execute_query_phase",
                            lambda *a, _r=real, **kw: calls.append(1)
                            or _r(*a, **kw))

    def broken(*a, **kw):
        raise _build.KernelError("CUDA kernel masked_topk_keyed failed")
    monkeypatch.setattr(tdist, "masked_topk_keyed", broken)
    fell_back = tspmd.HOST_FALLBACKS[0]
    with pytest.raises(RuntimeError, match="masked_topk_keyed failed"):
        execute_search(tex, BODIES["match"])
    assert calls == []
    assert tspmd.HOST_FALLBACKS[0] == fell_back


DEVICE_FAULTS = {
    "out_of_memory": lambda: torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"),
    "runtime": lambda: RuntimeError(
        "CUDA error: an illegal memory access was encountered"),
    "build": lambda: _build.KernelError("CUDA kernel build failed"),
}


@pytest.mark.parametrize("kind", sorted(DEVICE_FAULTS))
@pytest.mark.parametrize("where", ["program", "shard_query", "fetch"])
def test_device_fault_raises(nodes, monkeypatch, kind, where):
    """A fault of the card or a kernel, in the multi-shard program, in one
    shard's query on the host loop or in its fetch, raises out of the
    request: it is neither a fall-back nor a shard's failures[] entry."""
    _jn, tn = nodes
    tex = _executors(tn, "idx3")
    exc = DEVICE_FAULTS[kind]()

    def broken(*a, **kw):
        raise exc
    if where == "program":
        monkeypatch.setattr(tspmd, "spmd_query_phase", broken)
    else:
        monkeypatch.setattr(tex[1], "execute_query_phase"
                            if where == "shard_query" else "_hit_dict",
                            broken)
    fell_back, failed = tspmd.HOST_FALLBACKS[0], tcontroller.SHARD_FAILURES[0]
    with tspmd.force_host_loop() if where == "shard_query" \
            else contextlib.nullcontext():
        with pytest.raises(type(exc)) as got:
            execute_search(tex, BODIES["match"])
    assert got.value is exc
    assert tspmd.HOST_FALLBACKS[0] == fell_back
    assert tcontroller.SHARD_FAILURES[0] == failed


def test_program_fault_takes_the_host_loop(nodes, monkeypatch, caplog):
    """An untyped error of the multi-shard program that is no fault of
    the card (here a row's compile) sends the request to the per-shard
    host loop, as the reference's (`opensearch_tpu/search/controller.py:
    604-630`): logged and counted in `spmd.HOST_FALLBACKS`, and the page
    is the host loop's."""
    _jn, tn = nodes
    tex = _executors(tn, "idx3")
    with tspmd.force_host_loop():
        want = execute_search(tex, BODIES["match"])
    calls = []
    for ex in tex:
        real = ex.execute_query_phase
        monkeypatch.setattr(ex, "execute_query_phase",
                            lambda *a, _r=real, **kw: calls.append(1)
                            or _r(*a, **kw))

    def broken(*a, **kw):
        raise ValueError("a row's plan did not compile")
    monkeypatch.setattr(tspmd, "spmd_query_phase", broken)
    fell_back = tspmd.HOST_FALLBACKS[0]
    got = execute_search(tex, BODIES["match"])
    assert len(calls) == len(tex)
    assert tspmd.HOST_FALLBACKS[0] == fell_back + 1
    assert "a row's plan did not compile" in caplog.text
    assert got["_shards"]["failed"] == 0
    assert_same_response(got, want)


def test_layout_mismatch_takes_the_host_loop():
    """Indices whose segments map different fields (canonical_meta's
    raise in the reference) take the host loop in both packages, decided
    before any launch."""
    jn, tn = JNode(), TNode(device="cpu")
    for node in (jn, tn):
        for name, props in (("la", {"body": {"type": "text"},
                                    "views": {"type": "integer"}}),
                            ("lb", {"body": {"type": "text"}})):
            node.request("PUT", f"/{name}", {"mappings": {
                "properties": props}})
            docs = {f"{name}{i}": {"body": f"w{i % 5} w{i % 3}", "views": i}
                    for i in range(40)}
            if name == "lb":
                docs = {k: {"body": v["body"]} for k, v in docs.items()}
            node.request("POST", "/_bulk", bulk_ndjson(name, docs))
            node.request("POST", f"/{name}/_refresh")
    body = {"query": {"match": {"body": "w1 w2"}}, "size": 30}
    j0, t0 = jspmd.SPMD_QUERIES.value, tspmd.SPMD_QUERIES[0]
    want = jn.request("POST", "/la,lb/_search", body)
    got = tn.request("POST", "/la,lb/_search", body)
    assert jspmd.SPMD_QUERIES.value == j0 and tspmd.SPMD_QUERIES[0] == t0
    assert_same_response(got, want)


# --------------------------------------------------- K21's plain versions

def _rows(rng, ks, dup_every=3):
    width = 3 * max(ks) + 1
    buf = np.zeros((len(ks), width), np.float32)
    for r, kr in enumerate(ks):
        keys = np.sort(rng.choice(np.arange(40, dtype=np.float32), kr))[::-1]
        keys[rng.random(kr) < 0.2] = -np.inf
        keys = np.sort(keys)[::-1]
        buf[r, :kr] = keys
        buf[r, kr:2 * kr] = rng.random(kr, dtype=np.float32)
        buf[r, 2 * kr:3 * kr] = rng.integers(0, 10 ** 6, kr).astype(
            np.int32).view(np.float32)
        buf[r, 3 * kr] = np.int32(rng.integers(0, 10 ** 5)).view(np.float32)
    return buf


@pytest.mark.parametrize("ks,k", [([10, 10, 10, 10, 10], 10),
                                  ([64, 3, 64, 17, 64, 64, 1, 64], 100),
                                  ([1000, 1000], 1000), ([5], 7),
                                  ([300] * 8, 65536)])
def test_row_merge_plain_equals_numpy(ks, k):
    """K21's plain version: the k best of the rows' entries by key
    descending, then row ascending, then rank; ties abound (keys drawn
    from 40 values) and -inf entries sort last; the total is the sum of
    the row totals and the pruned counts pass through."""
    rng = np.random.default_rng(len(ks) * 1000 + k)
    buf = _rows(rng, ks)
    pruned = rng.integers(0, 50, len(ks)).astype(np.int32)
    out = kspmd.row_merge(torch.from_numpy(buf), ks,
                          torch.from_numpy(pruned), k).numpy()
    keys, scores, rows, ords, total, got_pruned = kspmd.unpack_merged(
        out, k, len(ks))
    ent = [(buf[r, j], r, j) for r, kr in enumerate(ks) for j in range(kr)]
    order = sorted(range(len(ent)),
                   key=lambda e: (-ent[e][0], ent[e][1], ent[e][2]))[:k]
    n = len(order)
    assert np.array_equal(keys[:n], np.array([ent[e][0] for e in order],
                                             np.float32))
    assert np.all(keys[n:] == -np.inf)
    assert np.array_equal(rows[:n], [ent[e][1] for e in order])
    for e, s, o in zip(order, scores[:n], ords[:n]):
        r, j = ent[e][1], ent[e][2]
        kr = ks[r]
        assert s == buf[r, kr + j]
        assert o == buf[r, 2 * kr + j].view(np.int32)
    assert total == sum(int(buf[r, 3 * kr].view(np.int32))
                        for r, kr in enumerate(ks))
    assert np.array_equal(got_pruned, pruned)


# ------------------------------------ K21's rank formula (the kernel's)

def _ordered(keys: torch.Tensor) -> torch.Tensor:
    """The total order of f32 bits that lax.top_k and K21 use (-0.0 below
    +0.0, NaN by its bits: +NaN above +inf, -NaN below -inf), as int64."""
    bits = keys.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7fffffff, bits).long()


def _rank_merge_mirror(buf, ks, pruned, k):
    """row_merge.cu's merge, written with torch.searchsorted: lane j of
    row r (j < min(k_r, k)) lands in slot j + #{lanes of earlier rows
    ordered >= its key} + #{lanes of later rows ordered > its key},
    counted over each row's first min(k_r, k) lanes; slots past the rows'
    lanes are padding. Holds only for rows sorted in that order."""
    n = [min(kr, k) for kr in ks]
    neg = [-_ordered(buf[r, :n[r]]) for r in range(len(ks))]  # ascending
    out = torch.zeros(4 * k, dtype=torch.int32)
    out[:k] = torch.tensor([-np.inf], dtype=torch.float32).view(torch.int32)
    for r, kr in enumerate(ks):
        if n[r] == 0:
            continue
        rank = torch.arange(n[r])
        for p in range(len(ks)):
            if p != r:
                rank = rank + torch.searchsorted(neg[p], neg[r],
                                                 right=p < r)
        won = rank < k
        slot, lane = rank[won], torch.arange(n[r])[won]
        row = buf[r].view(torch.int32)
        out[slot] = row[lane]
        out[k + slot] = row[kr + lane]
        out[2 * k + slot] = r
        out[3 * k + slot] = row[2 * kr + lane]
    total = sum(int(buf[r, 3 * kr:3 * kr + 1].view(torch.int32)[0])
                for r, kr in enumerate(ks))
    return torch.cat([out, torch.tensor([total], dtype=torch.int32),
                      pruned.to(torch.int32)]).view(torch.float32)


SPECIAL_KEYS = np.array([np.inf, 3.0, 1.0, 0.0, -0.0, -1.0, -np.inf, np.nan,
                         -np.nan], np.float32)


def _sorted_rows(rng, ks, special: bool):
    """R rows in K3-keyed's layout, each sorted in the total order (ties
    in lane order): keys from 6 values (ties within and across rows), or
    from +-inf, +-0.0, +-NaN and a few values; -inf padding at the tail
    of some rows."""
    width = 3 * max(max(ks), 1) + 1
    buf = np.zeros((len(ks), width), np.float32)
    for r, kr in enumerate(ks):
        keys = (rng.choice(SPECIAL_KEYS, kr) if special
                else rng.integers(-3, 3, kr).astype(np.float32))
        if r % 3 == 1:
            keys[kr - kr // 4:] = -np.inf
        order = np.argsort(-_ordered(torch.from_numpy(keys)).numpy(),
                           kind="stable")
        buf[r, :kr] = keys[order]
        buf[r, kr:2 * kr] = rng.random(kr, dtype=np.float32)
        buf[r, 2 * kr:3 * kr] = rng.integers(0, 10 ** 6, kr).astype(
            np.int32).view(np.float32)
        buf[r, 3 * kr] = np.int32(rng.integers(0, 10 ** 5)).view(np.float32)
    return torch.from_numpy(buf)


def _merge_cases():
    cases = []
    for n_rows in range(1, 9):
        ks = [(37 * (r + n_rows)) % 90 + 1 for r in range(n_rows)]
        lanes = sum(ks)
        for k in (max(lanes // 3, 1), lanes, lanes + 17):
            cases.append((ks, k))
    cases += [([0, 0, 0], 5), ([0] * 8, 64), ([0, 40, 0, 9], 30),
              ([64, 0, 64], 128), ([200, 3, 0, 150], 100), ([1], 1),
              ([5, 5], 1)]
    return cases


@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("ks,k", _merge_cases())
def test_row_merge_rank_formula_equals_plain(ks, k, special):
    """The kernel's design, held on the CPU: on sorted rows (ties within
    and across rows; +-0.0, +-inf and NaN of both signs, which sort by
    their bits), the rank formula places every lane where row_merge_plain's
    total-order top-k puts it, bit for bit: uneven k_r, empty rows, every
    row empty, k below, at and above the rows' lanes, R = 1 .. 8."""
    rng = np.random.default_rng(len(ks) * 1000 + k + special)
    buf = _sorted_rows(rng, ks, special)
    pruned = torch.from_numpy(rng.integers(0, 50, len(ks)).astype(np.int32))
    want = kspmd.row_merge_plain(buf, ks, pruned, k)
    got = _rank_merge_mirror(buf, ks, pruned, k)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("key_kind", ["sort key", "scores"])
def test_keyed_rows_arrive_sorted(key_kind):
    """K21's precondition: K3-keyed's rows are non-increasing in the total
    order, on keys with ties, +-0.0, +-inf, NaN of both signs and
    ineligible lanes (-inf); in score mode (no key) on such scores. Only a
    sort key carries a NaN into a row: a NaN score fails `score >=
    min_score`, so its lane is ineligible and keyed -inf."""
    from opensearch_tpu_torch.ops.topk import masked_topk_keyed_plain
    rng = np.random.default_rng(5)
    bsz, d_pad, k = 4, 3000, 700
    vals = torch.from_numpy(rng.choice(SPECIAL_KEYS, (bsz, d_pad)))
    scores = vals if key_kind == "scores" \
        else torch.from_numpy(rng.random((bsz, d_pad), dtype=np.float32))
    key = None if key_kind == "scores" else vals[0].contiguous()
    matches = torch.from_numpy(rng.random((bsz, d_pad)) < 0.6)
    live = torch.ones(d_pad, dtype=torch.bool)
    rows = masked_topk_keyed_plain(scores, matches, live, live, d_pad - 5,
                                   torch.full((bsz,), -np.inf), key, k)
    ordered = _ordered(rows[:, :k])
    assert bool((ordered[:, 1:] <= ordered[:, :-1]).all())
    assert bool(torch.isnan(rows[:, :k]).any()) == (key_kind == "sort key")


def test_row_merge_has_one_caller():
    """K21's precondition is K3-keyed's output as run_rows lays it out:
    parallel/distributed.py is the only module of the port that calls
    row_merge."""
    import pathlib
    import re
    import opensearch_tpu_torch
    root = pathlib.Path(opensearch_tpu_torch.__file__).parent
    callers = set()
    for path in root.rglob("*.py"):
        for line in path.read_text().splitlines():
            if re.search(r"\brow_merge\s*\(", line) \
                    and not line.lstrip().startswith("def "):
                callers.add(path.relative_to(root).as_posix())
    assert callers == {"parallel/distributed.py"}


@pytest.mark.parametrize("order", ["asc", "desc"])
def test_row_value_key_plain_equals_reference(nodes, order):
    """K21's key entry against the reference's value_merge_key on the
    same `views` column (bit for bit; missing docs at MISSING_VALUE_KEY)."""
    jn, tn = nodes
    jarrays, jmeta = jn.indices.get("idx3").shards[1].reader.device[0]
    tarrays, tmeta = tn.indices.get("idx3").shards[1].reader.device[0]
    want = np.asarray(j_value_merge_key(jarrays["numeric"]["views"], order,
                                        jmeta.d_pad))
    got = kspmd.row_value_key(tarrays["numeric"]["views"], order,
                              tmeta.d_pad, torch.device("cpu")).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    none = kspmd.row_value_key(None, order, 64, torch.device("cpu"))
    want_none = np.asarray(j_value_merge_key(None, order, 64))
    assert np.array_equal(none.numpy(), want_none)


@pytest.mark.parametrize("name", ["date_histogram", "aggs"])
def test_alignment_matches_reference(nodes, name):
    """align_agg_plans and plan_struct decide as the reference's do on the
    same compiled agg plans: both align (and agree on the structures) or
    both raise."""
    from opensearch_tpu.parallel import distributed as jdist
    from opensearch_tpu.search.aggs.engine import compile_aggs as jcompile
    from opensearch_tpu.search.aggs.parse import parse_aggs as jparse
    from opensearch_tpu.search.compile import Compiler as JCompiler
    from opensearch_tpu_torch.search.aggs.engine import \
        compile_aggs as tcompile
    from opensearch_tpu_torch.search.aggs.parse import parse_aggs as tparse
    from opensearch_tpu_torch.search.compile import Compiler as TCompiler
    jn, tn = nodes
    spec = BODIES[name]["aggs"]
    jrows, trows = [], []
    for js, ts in zip(jn.indices.get("idx3").shards,
                      tn.indices.get("idx3").shards):
        jstats, jsegs, jdev = js.reader.stats_snapshot()
        tstats, tsegs, tdev = ts.reader.stats_snapshot()
        for g in range(len(jsegs)):
            jrows.append(jcompile(jparse(spec), js.reader.mapper, jsegs[g],
                                  jdev[g][1], JCompiler(js.reader.mapper,
                                                        jstats),
                                  allow_fused=False))
            trows.append(tcompile(tparse(spec), ts.reader.mapper, tsegs[g],
                                  tdev[g][1], TCompiler(ts.reader.mapper,
                                                        tstats),
                                  allow_fused=False))
    if name in DECLINED:
        with pytest.raises(ValueError):
            jdist.align_agg_plans(jrows)
        with pytest.raises(ValueError):
            tdist.align_agg_plans(trows)
        return
    jdist.align_agg_plans(jrows)
    tdist.align_agg_plans(trows)
    assert [tuple(tdist.plan_struct(a) for a in r) for r in trows] == \
        [tuple(jdist.plan_struct(a) for a in r) for r in jrows]
