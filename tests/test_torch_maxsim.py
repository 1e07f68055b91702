"""Late-interaction MaxSim of opensearch_tpu_torch held against
opensearch_tpu: the plain versions of K10 (exact) and K11 (`pq_lut` and
the code scorer) against opensearch_tpu.ops.maxsim, the seal-time PQ
training and encoding, the `rank_vectors` mapping and its parse errors,
and `maxsim` pages through both Nodes (exact and pq, filter, boost, bool,
exists, deletes, two segments).

Contract: ids, order and totals exactly; `_score` within rtol 1e-5. The
reference sums its dot products as blocked matmuls and its PQ tables in
XLA's order, the port in dim / subspace order, so a score differs by a few
ulps of the sum of |q||d| behind it: the op tests allow rtol 1e-6 and atol
1e-6 * sum_t max_s sum_j |q_tj| |d_sj|. The port's own `_msearch` pages
equal its `_search` pages bit for bit, whatever the batch (every sum runs
in one fixed order); the reference's batched pages do not (its vmapped
dot sums in another order), so the port is held against the reference's
single searches."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_tpu.index.mapper import MapperService as JMapper
from opensearch_tpu.index.segment import SegmentBuilder as JBuilder
from opensearch_tpu.node import Node as JNode
from opensearch_tpu.ops import maxsim as jmaxsim
from opensearch_tpu.search.executor import SearchExecutor as JExecutor
from opensearch_tpu.search.executor import ShardReader as JReader

from opensearch_tpu_torch.index.mapper import MapperService as TMapper
from opensearch_tpu_torch.index.segment import (SegmentBuilder as TBuilder,
                                                segment_from_arrays)
from opensearch_tpu_torch.node import Node as TNode
from opensearch_tpu_torch.ops import maxsim as tmaxsim
from opensearch_tpu_torch.search.executor import SearchExecutor as TExecutor
from opensearch_tpu_torch.search.executor import ShardReader as TReader

from test_torch_common import (assert_same_response, bulk_ndjson,
                               msearch_ndjson, segment_arrays)

DIMS = 8
MAX_TOKENS = 16
RTOL = 1e-5
INDEX = "mx"


# ------------------------------------------------------------- the ops

def _op_data(n_docs, t_bucket, dims, bsz, tq, n_real, seed):
    """Token blocks with zero-token docs (every 7th) and queries with
    padded lanes (the last tq - n_real of each)."""
    rng = np.random.RandomState(seed)
    count = rng.randint(1, t_bucket + 1, n_docs).astype(np.int32)
    count[::7] = 0
    tokens = rng.randn(n_docs, t_bucket, dims).astype(np.float32)
    tokens[np.arange(t_bucket)[None, :] >= count[:, None]] = 0.0
    query = rng.randn(bsz, tq, dims).astype(np.float32)
    query[:, n_real:] = 0.0
    qmask = np.zeros((bsz, tq), np.float32)
    qmask[:, :n_real] = 1.0
    return tokens, count, query, qmask


def _abs_bound(tokens, count, query, qmask):
    """1e-6 * sum_t qmask * max_s sum_j |q_tj| |d_sj| per (query, doc)."""
    a = np.einsum("btj,dsj->bdts", np.abs(query).astype(np.float64),
                  np.abs(tokens).astype(np.float64))
    real = np.arange(tokens.shape[1])[None, :] < count[:, None]
    a = np.where(real[None, :, None, :], a, 0.0).max(axis=3)
    return 1e-6 * (a * qmask[:, None, :]).sum(axis=2)


OP_CASES = [(8, 16, 4, 3), (16, 7, 8, 5), (16, 12, 4, 4), (8, 64, 32, 30)]


@pytest.mark.parametrize("t_bucket,dims,tq,n_real", OP_CASES)
def test_exact_scores_equal_the_reference(t_bucket, dims, tq, n_real):
    tokens, count, query, qmask = _op_data(60, t_bucket, dims, 3, tq,
                                           n_real, seed=t_bucket + dims)
    got = tmaxsim.exact_maxsim_scores(
        torch.from_numpy(tokens), torch.from_numpy(count),
        torch.from_numpy(query), torch.from_numpy(qmask)).numpy()
    want = np.stack([np.asarray(jmaxsim.exact_maxsim_scores(
        jnp.asarray(tokens), jnp.asarray(count), jnp.asarray(q),
        jnp.asarray(m))) for q, m in zip(query, qmask)])
    assert (got[:, count == 0] == 0).all()
    bound = _abs_bound(tokens, count, query, qmask)
    assert (np.abs(got - want) <= 1e-6 * np.abs(want) + bound).all()


def _codebook(dims, m, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(m, 256, dims // m).astype(np.float32)


@pytest.mark.parametrize("t_bucket,dims,tq,n_real", OP_CASES)
def test_pq_lut_and_scores_equal_the_reference(t_bucket, dims, tq, n_real):
    m = dims // 4 if dims % 4 == 0 else dims     # the mapping's default
    tokens, count, query, qmask = _op_data(60, t_bucket, dims, 3, tq,
                                           n_real, seed=dims)
    codebook = _codebook(dims, m, seed=dims + 1)
    rng = np.random.RandomState(dims + 2)
    codes = rng.randint(0, 256, (60, t_bucket, m)).astype(np.uint8)
    lut = tmaxsim.pq_lut(torch.from_numpy(codebook),
                         torch.from_numpy(query)).numpy()
    want_lut = np.stack([np.asarray(jmaxsim.pq_lut(jnp.asarray(codebook),
                                                   jnp.asarray(q)))
                         for q in query])
    dsub = dims // m
    lut_bound = 1e-6 * np.einsum(
        "mcj,btmj->btmc", np.abs(codebook).astype(np.float64),
        np.abs(query).reshape(3, tq, m, dsub).astype(np.float64))
    assert (np.abs(lut - want_lut) <= 1e-6 * np.abs(want_lut)
            + lut_bound).all()
    got = tmaxsim.pq_maxsim_scores(
        torch.from_numpy(codes), torch.from_numpy(codebook),
        torch.from_numpy(count), torch.from_numpy(query),
        torch.from_numpy(qmask)).numpy()
    want = np.stack([np.asarray(jmaxsim.pq_maxsim_scores(
        jnp.asarray(codes), jnp.asarray(codebook), jnp.asarray(count),
        jnp.asarray(q), jnp.asarray(mk))) for q, mk in zip(query, qmask)])
    assert (got[:, count == 0] == 0).all()
    decoded = tmaxsim.decode_pq(codes.reshape(-1, m), codebook).reshape(
        tokens.shape)
    bound = _abs_bound(decoded, count, query, qmask)
    assert (np.abs(got - want) <= 1e-6 * np.abs(want) + bound).all()


def test_scores_do_not_depend_on_the_batch():
    """A query's scores carry the same bits alone and in a batch."""
    tokens, count, query, qmask = _op_data(40, 16, 12, 5, 8, 6, seed=3)
    t = [torch.from_numpy(a) for a in (tokens, count, query, qmask)]
    batch = tmaxsim.exact_maxsim_scores(*t)
    m = 3
    codebook = torch.from_numpy(_codebook(12, m, 4))
    codes = torch.from_numpy(np.random.RandomState(5).randint(
        0, 256, (40, 16, m)).astype(np.uint8))
    pq = tmaxsim.pq_maxsim_scores(codes, codebook, t[1], t[2], t[3])
    for b in range(5):
        one = tmaxsim.exact_maxsim_scores(t[0], t[1], t[2][b:b + 1],
                                          t[3][b:b + 1])
        assert torch.equal(one[0].view(torch.int32),
                           batch[b].view(torch.int32))
        one = tmaxsim.pq_maxsim_scores(codes, codebook, t[1],
                                       t[2][b:b + 1], t[3][b:b + 1])
        assert torch.equal(one[0].view(torch.int32), pq[b].view(torch.int32))


@pytest.mark.parametrize("dims,m", [(8, 2), (6, 6), (12, 3)])
def test_train_and_encode_pq_equal_the_reference(dims, m):
    vecs = np.random.RandomState(dims).randn(700, dims).astype(np.float32)
    book = tmaxsim.train_pq(vecs, m)
    want = jmaxsim.train_pq(vecs, m)
    assert book.dtype == want.dtype and np.array_equal(book, want)
    codes = tmaxsim.encode_pq(vecs, book)
    assert np.array_equal(codes, jmaxsim.encode_pq(vecs, want))
    assert np.array_equal(tmaxsim.decode_pq(codes, book),
                          jmaxsim.decode_pq(codes, want))


# ----------------------------------------------------- mapping and seal

def _mapping(compression="none"):
    spec = {"type": "rank_vectors", "dimension": DIMS,
            "max_tokens": MAX_TOKENS}
    if compression != "none":
        spec["compression"] = compression
    return {"mappings": {"properties": {
        "tok": spec, "tokpq": {**spec, "compression": "pq"},
        "title": {"type": "text"}, "tag": {"type": "keyword"}}}}


MAPPING_ERRORS = {
    "no_dims": {"type": "rank_vectors"},
    "zero_dims": {"type": "rank_vectors", "dimension": 0},
    "zero_max_tokens": {"type": "rank_vectors", "dimension": 8,
                        "max_tokens": 0},
    "bad_compression": {"type": "rank_vectors", "dimension": 8,
                        "compression": "zip"},
    "pq_m_not_a_divisor": {"type": "rank_vectors", "dimension": 8,
                           "compression": "pq", "pq_m": 3},
}


@pytest.mark.parametrize("name", sorted(MAPPING_ERRORS))
def test_mapping_errors_equal_the_reference(name):
    body = {"mappings": {"properties": {"tok": MAPPING_ERRORS[name]}}}
    want = JNode().request("PUT", "/bad", body)
    got = TNode(device="cpu").request("PUT", "/bad", body)
    assert want["_status"] == 400, want
    assert got == want


def test_bulk_responses_equal_the_reference():
    """Good docs, an empty and a missing token list, too many tokens,
    wrong dims, a non-list, a boolean element: item for item the
    reference's statuses and reasons."""
    docs = {
        "ok": {"tok": [[0.5] * DIMS, [1.0] * DIMS]},
        "empty": {"tok": []},
        "missing": {"title": "no tokens"},
        "too_many": {"tok": [[0.0] * DIMS] * (MAX_TOKENS + 1)},
        "wrong_dims": {"tok": [[0.0] * (DIMS - 1)]},
        "not_a_list": {"tok": "1,2,3"},
        "flat": {"tok": [0.1] * DIMS},
        "boolean": {"tok": [[True] + [0.0] * (DIMS - 1)]},
    }
    out = []
    for node in (JNode(), TNode(device="cpu")):
        node.request("PUT", f"/{INDEX}", _mapping())
        res = node.request("POST", "/_bulk", bulk_ndjson(INDEX, docs))
        out.append([(next(iter(i.values()))["status"],
                     next(iter(i.values())).get("error"))
                    for i in res["items"]])
    want, got = out
    assert sum(s >= 400 for s, _ in want) == 5, want
    assert got == want


def test_seal_equals_the_reference():
    """Both builders seal the same token block, counts, bucket, codebook
    and codes from the same documents (PQ training is the same numpy code
    with RandomState(29))."""
    docs = _docs(90, seed=4)
    segs = []
    for mapper_cls, builder_cls in ((JMapper, JBuilder), (TMapper, TBuilder)):
        m = mapper_cls(_mapping()["mappings"])
        b = builder_cls(m)
        for i, d in enumerate(docs):
            b.add(m.parse_document(f"d{i}", d))
        segs.append(b.seal())
    jseg, tseg = segs
    for field in ("tok", "tokpq"):
        j, t = jseg.rank_vectors_dv[field], tseg.rank_vectors_dv[field]
        assert t.t_bucket == j.t_bucket
        for a in ("tokens", "token_count", "exists"):
            assert np.array_equal(getattr(t, a), getattr(j, a)), a
    j, t = jseg.rank_vectors_dv["tokpq"], tseg.rank_vectors_dv["tokpq"]
    assert np.array_equal(t.codebook, j.codebook)
    assert np.array_equal(t.codes, j.codes)
    assert tseg.rank_vectors_dv["tok"].codes is None
    # both keep the host positions of the text fields now
    assert tseg.memory_bytes() == jseg.memory_bytes()


# ------------------------------------------------------------ the pages

def _docs(n, seed):
    """Token matrices of 1..8 tokens, ~8% without the field and ~4% with
    an empty list (neither ever matches)."""
    rng = np.random.RandomState(seed)
    docs = []
    for i in range(n):
        src = {"title": "fox red" if i % 3 else "dog", "tag":
               ["even", "odd"][i % 2]}
        r = rng.rand()
        if r >= 0.12:
            toks = rng.randn(int(rng.randint(1, 9)), DIMS).round(3).tolist()
            src["tok"] = toks
            src["tokpq"] = toks
        elif r >= 0.08:
            src["tok"] = []
        docs.append(src)
    return docs


DELETED = ("d3", "d150", "d151")


def _load(node, docs):
    """Two refreshes (two segments), deletes in the second batch."""
    assert node.request("PUT", f"/{INDEX}", _mapping())["_status"] == 200
    half = len(docs) // 2
    for part, deletes in ((range(half), ()),
                          (range(half, len(docs)), DELETED)):
        res = node.request("POST", "/_bulk", bulk_ndjson(
            INDEX, {f"d{i}": docs[i] for i in part}, deletes))
        assert res["_status"] == 200 and not res["errors"], res
        node.request("POST", f"/{INDEX}/_refresh")


def _queries(n, seed, n_tokens=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(n_tokens, DIMS).round(3).tolist() for _ in range(n)]


@pytest.fixture(scope="module")
def nodes():
    docs = _docs(240, seed=7)
    jn, tn = JNode(), TNode(device="cpu")
    for node in (jn, tn):
        _load(node, docs)
    return jn, tn


def _bodies():
    q = _queries(8, seed=11)
    return {
        "exact": {"query": {"maxsim": {"tok": {"query_vectors": q[0],
                                               "k": 10}}}},
        "exact_k30_size12": {"query": {"maxsim": {"tok": {
            "query_vectors": q[1], "k": 30}}}, "size": 12, "from": 3},
        "pq": {"query": {"maxsim": {"tokpq": {"query_vectors": q[2],
                                              "k": 10}}}},
        "filtered": {"query": {"maxsim": {"tok": {
            "query_vectors": q[3], "k": 8,
            "filter": {"term": {"tag": "odd"}}}}}, "size": 20},
        "pq_filtered_boost": {"query": {"maxsim": {"tokpq": {
            "query_vectors": q[4], "k": 6, "boost": 2.5,
            "filter": {"match": {"title": "fox"}}}}}},
        "one_token": {"query": {"maxsim": {"tok": {
            "query_vectors": q[5][:1], "k": 5}}}},
        "in_bool": {"query": {"bool": {
            "must": [{"maxsim": {"tok": {"query_vectors": q[6],
                                         "k": 20}}}],
            "filter": [{"term": {"tag": "even"}}],
            "should": [{"match": {"title": "fox"}}]}}, "size": 15},
        "exists": {"query": {"exists": {"field": "tok"}}, "size": 50},
        "exists_pq_in_bool": {"query": {"bool": {
            "must": [{"exists": {"field": "tokpq"}}],
            "must_not": [{"term": {"tag": "odd"}}]}}, "size": 30},
        "many_tokens": {"query": {"maxsim": {"tok": {
            "query_vectors": _queries(1, 12, MAX_TOKENS)[0], "k": 10}}}},
    }


@pytest.mark.parametrize("name", sorted(_bodies()))
def test_search_pages_equal_the_reference(nodes, name):
    jn, tn = nodes
    body = _bodies()[name]
    want = jn.request("POST", f"/{INDEX}/_search", body)
    got = tn.request("POST", f"/{INDEX}/_search", body)
    assert want["_status"] == 200 and want["hits"]["hits"], want
    assert_same_response(got, want, name, score_rtol=RTOL)


def _msearch_bodies(b):
    q = _queries(b, seed=13)
    out = []
    for i in range(b):
        field = "tokpq" if i % 3 == 2 else "tok"
        spec = {"query_vectors": q[i][:1 + i % 3], "k": 5 + i % 4}
        if i % 5 == 4:
            spec["filter"] = {"term": {"tag": "even"}}
        out.append({"query": {"maxsim": {field: spec}}, "size": 8})
    return out


@pytest.mark.parametrize("b", [1, 32])
def test_msearch_pages_equal_the_ports_single_searches(nodes, b):
    """The port's batched pages carry the bits of its own B=1 pages, and
    equal the reference's single searches within the contract."""
    jn, tn = nodes
    bodies = _msearch_bodies(b)
    got = tn.request("POST", "/_msearch", msearch_ndjson(INDEX, bodies))
    assert got["_status"] == 200
    for i, body in enumerate(bodies):
        one = tn.request("POST", f"/{INDEX}/_search", body)
        item = got["responses"][i]
        assert item["status"] == 200
        assert [(h["_id"], h["_score"]) for h in item["hits"]["hits"]] == \
            [(h["_id"], h["_score"]) for h in one["hits"]["hits"]]
        assert item["hits"]["total"] == one["hits"]["total"]
        want = jn.request("POST", f"/{INDEX}/_search", body)
        assert_same_response(one, want, f"[{i}]", score_rtol=RTOL)


QUERY_ERRORS = {
    "dims_mismatch": {"maxsim": {"tok": {"query_vectors": [[0.0] * 9]}}},
    "too_many_tokens": {"maxsim": {"tok": {
        "query_vectors": [[0.0] * DIMS] * (MAX_TOKENS + 1)}}},
    "empty": {"maxsim": {"tok": {"query_vectors": []}}},
    "no_vectors": {"maxsim": {"tok": {}}},
    "not_rank_vectors": {"maxsim": {"title": {
        "query_vectors": [[0.0] * DIMS]}}},
    "two_fields": {"maxsim": {"tok": {"query_vectors": [[0.0] * DIMS]},
                              "tokpq": {}}},
}


@pytest.mark.parametrize("name", sorted(QUERY_ERRORS))
def test_query_errors_equal_the_reference(nodes, name):
    jn, tn = nodes
    body = {"query": QUERY_ERRORS[name]}
    want = jn.request("POST", f"/{INDEX}/_search", body)
    got = tn.request("POST", f"/{INDEX}/_search", body)
    assert want["_status"] == 400, want
    assert got == want


def test_carried_pq_segment_serves_the_references_codes():
    """A PQ segment sealed by the reference, carried across through
    segment_from_arrays (codes and codebook as they are), serves the
    reference's pages."""
    jm = JMapper(_mapping()["mappings"])
    b = JBuilder(jm)
    docs = _docs(120, seed=9)
    for i, d in enumerate(docs):
        b.add(jm.parse_document(f"d{i}", d))
    jseg = b.seal()
    arrays = segment_arrays(jseg)
    arrays["rank_vectors_dv"] = {
        f: {"tokens": c.tokens, "token_count": c.token_count,
            "exists": c.exists, "t_bucket": c.t_bucket, "codes": c.codes,
            "codebook": c.codebook}
        for f, c in jseg.rank_vectors_dv.items()}
    reader = TReader(TMapper(_mapping()["mappings"]), "cpu", INDEX)
    reader.add_segment(segment_from_arrays(arrays))
    jex, tex = JExecutor(JReader(jm, [jseg], index_name=INDEX)), \
        TExecutor(reader)
    for q in _queries(4, seed=21):
        body = {"query": {"maxsim": {"tokpq": {"query_vectors": q,
                                               "k": 10}}}}
        assert_same_response(tex.search(body), jex.search(body),
                             json.dumps(q)[:20], score_rtol=RTOL)
