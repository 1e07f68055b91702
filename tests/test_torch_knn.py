"""Dense k-NN of opensearch_tpu_torch held against opensearch_tpu: `knn`
bodies (three spaces, `k`, `boost`, `filter`, `bool`, deletes, the doc-0
scatter cases, IVF) through both Nodes' `_search` and `_msearch` on a
16-dim index of two segments; IVF serving with the reference's IVFIndex
carried across; the port's `build_ivf` against the reference's; the
kernels' plain versions against the reference's functions; and the mapping
and parse errors.

Contract: ids, order and totals exactly; `_score` within rtol 1e-5 /
atol 1e-5. The reference computes its dot products as blocked matmuls and
the port in dim order, so scores differ by a few ulps (about dims * 2^-24
* sum|v_i q_i|, carried through the score); every parity case asserts on
its own data that the scores around each decision (the k-th / (k+1)-th
doc of a segment, consecutive hits of the page) lie further apart than
that f32 bound (`np_scores`), so a tie flip fails loudly instead of
passing by luck."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_tpu.index.mapper import MapperService as JMapper
from opensearch_tpu.index.segment import SegmentBuilder as JBuilder
from opensearch_tpu.node import Node as JNode
from opensearch_tpu.ops import knn as jknn
from opensearch_tpu.search.executor import SearchExecutor as JExecutor
from opensearch_tpu.search.executor import ShardReader as JReader

from opensearch_tpu_torch.index.mapper import MapperService as TMapper
from opensearch_tpu_torch.index.segment import (SegmentBuilder as TBuilder,
                                                segment_from_arrays)
from opensearch_tpu_torch.node import Node as TNode
from opensearch_tpu_torch.ops import knn as tknn
from opensearch_tpu_torch.ops import topk
from opensearch_tpu_torch.search.executor import SearchExecutor as TExecutor
from opensearch_tpu_torch.search.executor import ShardReader as TReader
from opensearch_tpu_torch.utils.demo import clustered_vectors

from kmeans_assign_mirror import lanes_assign, scan_assign
from test_torch_common import (bulk_ndjson, msearch_ndjson,
                               segment_arrays)

DIMS = 16
N_VECS = 300
INDEX = "vecs"
KNN_RTOL = 1e-5
KNN_ATOL = 1e-5
SPACES = ("l2", "cosinesimil", "innerproduct")
CPU = torch.device("cpu")


def assert_knn_response(got, want, path="", truth=None, over=None):
    """Structural equality with `_score` / `max_score` to the knn bound.
    `truth(path)`, where given, answers (f64 score, f32 bound) for a hit's
    score: a score pair outside the contract then passes only when both
    scores lie within the f32 bound of the f64 score, and is appended to
    the list `over` as (path, port, reference, f64)."""
    if isinstance(want, dict):
        assert isinstance(got, dict), f"{path}: {got!r}"
        keys = set(want) - {"took"}
        assert set(got) - {"took"} == keys, \
            f"{path}: keys {sorted(got)} != {sorted(want)}"
        for key in keys:
            assert_knn_response(got[key], want[key], f"{path}.{key}",
                                truth, over)
        return
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), \
            f"{path}: {got!r} != {want!r}"
        for i, (g, w) in enumerate(zip(got, want)):
            assert_knn_response(g, w, f"{path}[{i}]", truth, over)
        return
    if isinstance(want, float) and path.endswith(("_score", "max_score")):
        assert isinstance(got, float), f"{path}: {got!r} != {want!r}"
        if math.isclose(got, want, rel_tol=KNN_RTOL, abs_tol=KNN_ATOL):
            return
        assert truth is not None, f"{path}: {got!r} != {want!r}"
        exact, bound = truth(path)
        assert abs(got - exact) <= bound and abs(want - exact) <= bound, \
            f"{path}: {got!r} / {want!r} off the f64 score {exact!r} " \
            f"by more than {bound!r}"
        over.append((path, got, want, exact))
        return
    assert got == want and type(got) is type(want), \
        f"{path}: {got!r} != {want!r}"


U = 2.0 ** -24


def np_scores(vectors, q, space):
    """f64 oracle of the k-NN plugin score of every row, and a bound on
    how far two f32 evaluations of it in different summation orders (the
    reference's blocked matmul, the port's dim order) can lie apart: each
    dims-term sum of magnitude S is within dims * 2^-24 * S of the exact
    one, carried through the score's derivative, plus a few ulps of the
    score's own roundings; doubled for the two sides."""
    v = vectors.astype(np.float64)
    q = np.asarray(q, np.float64)
    dims = v.shape[1]
    dots = v @ q
    adot = np.abs(v) @ np.abs(q)
    dn, qn = (v * v).sum(axis=1), (q * q).sum()
    if space == "l2":
        s = 1.0 / (1.0 + np.maximum(dn - 2 * dots + qn, 0.0))
        err = s * s * dims * U * (dn + 2 * adot + qn) + 8 * U * s
    elif space == "cosinesimil":
        den = np.maximum(np.sqrt(dn) * np.sqrt(qn), 1e-30)
        cos = dots / den
        s = (1.0 + np.clip(cos, -1, 1)) / 2.0
        err = dims * U * (adot / den + np.abs(cos)) + 8 * U
    else:
        s = np.where(dots >= 0, dots + 1.0, 1.0 / (1.0 - dots))
        slope = np.where(dots >= 0, 1.0, s * s)
        err = slope * dims * U * adot + 8 * U * s
    return s, 2 * err


def near_ties(scored, k: int):
    """The k-th / (k+1)-th score gaps, one per segment's eligible docs
    (`scored` holds one np_scores pair per segment), that lie within their
    two f32 bounds: there the two packages may pick different k-th
    docs."""
    out = []
    for s, err in scored:
        order = np.argsort(-np.asarray(s), kind="stable")[:k + 1]
        s, err = np.asarray(s)[order], np.asarray(err)[order]
        if len(s) > k and s[k - 1] - s[k] <= err[k - 1] + err[k]:
            out.append(float(s[k - 1] - s[k]))
    return out


def assert_margins(scored, k: int, what: str = ""):
    """A segment's k matches cannot flip between the two packages."""
    ties = near_ties(scored, k)
    assert not ties, f"{what}: k-th / (k+1)-th gaps {ties} within the bound"


def scored_segments(vectors, q, space, eligible):
    """assert_margins' input: np_scores of each segment's eligible rows."""
    out = []
    for e in eligible:
        s, b = np_scores(vectors[e], q, space)
        out.append((s, b))
    return out


# --------------------------------------------------------- the two Nodes

def _mapping(space, method=None, nlist=8, nprobes=None):
    m = {"space_type": space}
    if method:
        params = {"nlist": nlist}
        if nprobes is not None:
            params["nprobes"] = nprobes
        m = {"name": method, "space_type": space, "parameters": params}
    return {"mappings": {"properties": {
        "vec": {"type": "knn_vector", "dimension": DIMS, "method": m},
        "tag": {"type": "keyword"}}}}


DELETED = ("d17", "d160", "d201")


def _load(node, vectors, mapping, split: bool = True):
    """Docs d0.. with `vec` and an even/odd `tag` over two refreshes (two
    segments) with deletes in the second batch."""
    assert node.request("PUT", f"/{INDEX}", mapping)["_status"] == 200
    docs = {f"d{i}": {"vec": vectors[i].tolist(),
                      "tag": "even" if i % 2 == 0 else "odd"}
            for i in range(len(vectors))}
    items = list(docs.items())
    half = len(items) // 2 if split else len(items)
    res = node.request("POST", "/_bulk", bulk_ndjson(INDEX,
                                                     dict(items[:half])))
    assert res["_status"] == 200 and not res["errors"]
    node.request("POST", f"/{INDEX}/_refresh")
    if half < len(items):
        res = node.request("POST", "/_bulk",
                           bulk_ndjson(INDEX, dict(items[half:]), DELETED))
        assert res["_status"] == 200 and not res["errors"]
        node.request("POST", f"/{INDEX}/_refresh")


def _vectors(n=N_VECS, seed=0):
    return np.random.RandomState(seed).randn(n, DIMS).astype(np.float32)


@pytest.fixture(scope="module", params=SPACES)
def nodes(request):
    space = request.param
    vectors = _vectors()
    jn, tn = JNode(), TNode(device="cpu")
    for node in (jn, tn):
        _load(node, vectors, _mapping(space))
    return space, vectors, jn, tn


def _segments_of(n_docs: int):
    half = n_docs // 2
    return [np.arange(half), np.arange(half, n_docs)]


def _eligible(n_docs, filt=None):
    dead = {int(d[1:]) for d in DELETED}
    return [np.array([i for i in seg if i not in dead
                      and (filt is None or filt(i))], dtype=np.int64)
            for seg in _segments_of(n_docs)]


def _queries(seed, n=3):
    return np.random.RandomState(seed).randn(n, DIMS).astype(np.float32)


def _same(jn, tn, body, what):
    want = jn.request("POST", f"/{INDEX}/_search", body)
    got = tn.request("POST", f"/{INDEX}/_search", body)
    assert want["_status"] == 200, want
    assert_knn_response(got, want, what)
    return want


@pytest.mark.parametrize("k,size", [(10, 10), (7, 20), (3, 2)])
def test_exact_parity(nodes, k, size):
    """tests/test_knn.py's exact cases in each space: the page, the total
    (k per segment: `k` limits the matches) and the scores."""
    space, vectors, jn, tn = nodes
    for qi, q in enumerate(_queries(1)):
        assert_margins(scored_segments(vectors, q, space,
                                       _eligible(len(vectors))),
                       k, f"{space} q{qi}")
        want = _same(jn, tn, {"query": {"knn": {"vec": {
            "vector": q.tolist(), "k": k}}}, "size": size},
            f"{space} q{qi} k{k}")
        assert want["hits"]["total"]["value"] == 2 * k


@pytest.mark.parametrize("name", ["term", "bool", "boost"])
def test_filtered_and_boosted_exact(nodes, name):
    space, vectors, jn, tn = nodes
    q = _queries(2, 1)[0]
    if name == "term":
        spec = {"k": 5, "filter": {"term": {"tag": "even"}}}
        keep = lambda i: i % 2 == 0
    elif name == "bool":
        spec = {"k": 8, "filter": {"bool": {"must_not": [
            {"term": {"tag": "even"}}]}}}
        keep = lambda i: i % 2 == 1
    else:
        spec = {"k": 6, "boost": 2.5}
        keep = None
    assert_margins(scored_segments(vectors, q, space,
                                   _eligible(len(vectors), keep)),
                   spec["k"], name)
    want = _same(jn, tn, {"query": {"knn": {"vec": {
        "vector": q.tolist(), **spec}}}, "size": 12}, name)
    if keep is not None:
        assert all(keep(int(h["_id"][1:])) for h in want["hits"]["hits"])


def test_deleted_docs_are_not_matched(nodes):
    space, vectors, jn, tn = nodes
    q = vectors[17]
    assert_margins(scored_segments(vectors, q, space,
                                   _eligible(len(vectors))), 3, "deleted")
    want = _same(jn, tn, {"query": {"knn": {"vec": {
        "vector": q.tolist(), "k": 3}}}, "size": 4}, "deleted")
    assert "d17" not in [h["_id"] for h in want["hits"]["hits"]]


@pytest.mark.parametrize("name", ["must_filter", "should_term", "exists"])
def test_knn_in_bool(nodes, name):
    """tests/test_knn.py::test_knn_in_bool_hybrid's body, a `should` mix
    and an `exists` on the vector field."""
    space, vectors, jn, tn = nodes
    q = np.full(DIMS, 0.1, np.float32)
    if name == "must_filter":
        body = {"query": {"bool": {
            "must": [{"knn": {"vec": {"vector": q.tolist(), "k": 20}}}],
            "filter": [{"term": {"tag": "odd"}}]}}, "size": 30}
    elif name == "should_term":
        body = {"query": {"bool": {"should": [
            {"knn": {"vec": {"vector": q.tolist(), "k": 6}}},
            {"term": {"tag": "odd"}}]}}, "size": 25}
    else:
        body = {"query": {"bool": {"must": [{"exists": {"field": "vec"}}],
                                   "must_not": [{"term": {"tag": "odd"}}]}},
                "size": 5}
    if name != "exists":
        k = body["query"]["bool"].get("must", body["query"]["bool"].get(
            "should"))[0]["knn"]["vec"]["k"]
        assert_margins(scored_segments(vectors, q, space,
                                       _eligible(len(vectors))), k, name)
    want = _same(jn, tn, body, name)
    if name == "must_filter":
        assert 0 < want["hits"]["total"]["value"] <= 40
        assert all(int(h["_id"][1:]) % 2 == 1 for h in want["hits"]["hits"])


def _msearch_bodies(b):
    qs = _queries(40, b)
    out = []
    for i, q in enumerate(qs):
        spec = {"vector": q.tolist(), "k": 10}
        if i % 4 == 1:
            spec["k"] = 4
        if i % 4 == 2:
            spec["filter"] = {"term": {"tag": "odd"}}
        body = {"query": {"knn": {"vec": spec}}, "size": 10 - i % 3}
        if i % 8 == 3:
            body = {"query": {"bool": {
                "must": [{"knn": {"vec": spec}}],
                "filter": [{"term": {"tag": "even"}}]}}}
        out.append(body)
    return out


@pytest.mark.parametrize("b", [1, 32])
def test_msearch(nodes, b):
    """_msearch at B=1 and 32: the port's batch equals the reference's
    batch and the port's own per-body _search."""
    space, vectors, jn, tn = nodes
    bodies = _msearch_bodies(b)
    for i, q in enumerate(_queries(40, b)):
        k = 4 if i % 4 == 1 else 10
        keep = (lambda d: d % 2 == 1) if i % 4 == 2 else None
        assert_margins(scored_segments(vectors, q, space,
                                       _eligible(len(vectors), keep)), k,
                       f"msearch {i}")
    payload = msearch_ndjson(INDEX, bodies)
    want = jn.request("POST", "/_msearch", payload)
    got = tn.request("POST", "/_msearch", payload)
    assert_knn_response(got, want, "msearch")
    for i, body in enumerate(bodies):
        single = tn.request("POST", f"/{INDEX}/_search", body)
        single.pop("_status")
        single["status"] = 200
        assert_knn_response(got["responses"][i], single, f"single {i}")


# ------------------------------------------------------ scatter regressions

def test_doc_zero_wins_exact_fewer_than_k():
    """k > eligible docs: invalid top-k slots must not clobber doc 0."""
    vectors = _vectors(5)
    jn, tn = JNode(), TNode(device="cpu")
    for node in (jn, tn):
        _load(node, vectors, _mapping("l2"), split=False)
    body = {"query": {"knn": {"vec": {"vector": vectors[0].tolist(),
                                      "k": 10}}}}
    assert_margins([np_scores(vectors, vectors[0], "l2")], 10, "doc0")
    want = _same(jn, tn, body, "doc0")
    assert want["hits"]["hits"][0]["_id"] == "d0"
    assert want["hits"]["total"]["value"] == 5


def test_doc_zero_wins_ivf():
    """IVF with padding slots: -1 ids must not clobber doc 0. With nprobes
    = nlist every block is probed, so both packages score every present
    doc whatever their centroids."""
    vectors = np.random.RandomState(9).randn(400, DIMS).astype(np.float32)
    jn, tn = JNode(), TNode(device="cpu")
    for node in (jn, tn):
        _load(node, vectors, _mapping("l2", "ivf", nlist=4, nprobes=4),
              split=False)
    for node in (jn, tn):
        seg = node.indices.get(INDEX).shards[0].engine.segments[0]
        assert seg.vector_dv["vec"].ivf is not None
    body = {"query": {"knn": {"vec": {"vector": vectors[0].tolist(),
                                      "k": 5}}}}
    assert_margins([np_scores(vectors, vectors[0], "l2")], 5, "doc0 ivf")
    want = _same(jn, tn, body, "doc0 ivf")
    assert want["hits"]["hits"][0]["_id"] == "d0"


# ----------------------------------------------------- IVF carried across

def _ivf_corpus(n=800, seed=3):
    """tests/test_knn.py::TestIvfKnn's data: 8 centers x5, sigma 0.5."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(8, DIMS).astype(np.float32) * 5
    assign = rng.randint(0, 8, size=n)
    vectors = centers[assign] + rng.randn(n, DIMS).astype(np.float32) * 0.5
    queries = [centers[rng.randint(0, 8)]
               + rng.randn(DIMS).astype(np.float32) * 0.5
               for _ in range(10)]
    return vectors, np.stack(queries)


def _ivf_segment_pair(space, nlist=8, nprobes=3):
    vectors, queries = _ivf_corpus()
    spec = {"properties": {"vec": {
        "type": "knn_vector", "dimension": DIMS,
        "method": {"name": "ivf", "space_type": space,
                   "parameters": {"nlist": nlist, "nprobes": nprobes}}},
        "tag": {"type": "keyword"}}}
    jm = JMapper(spec)
    builder = JBuilder(jm)
    for i, v in enumerate(vectors):
        builder.add(jm.parse_document(f"d{i}", {
            "vec": v.tolist(), "tag": "even" if i % 2 == 0 else "odd"}))
    jseg = builder.seal()
    for i in range(0, len(vectors), 37):
        jseg.delete(f"d{i}")
    ivf = jseg.vector_dv["vec"].ivf
    assert ivf is not None
    arrays = segment_arrays(jseg)
    arrays["vector_dv"] = {"vec": {
        "vectors": jseg.vector_dv["vec"].vectors,
        "exists": jseg.vector_dv["vec"].exists,
        "ivf": {"centroids": ivf.centroids, "lists": ivf.lists,
                "block_centroid": ivf.block_centroid, "nlist": ivf.nlist,
                "nprobe": ivf.nprobe}}}
    tseg = segment_from_arrays(arrays)
    return vectors, queries, jm, jseg, TMapper(spec), tseg


def _assert_probe_margin(ivf, q, nprobe):
    """The blocks a probe picks are stable under the f32 error bound of
    the centroid keys |c|^2 - 2 c.q (dims * 2^-24 * (|c|^2 + 2 |c|.|q|)
    per side): the keys at the budget boundary are equal (one centroid's
    blocks) or further apart than two such bounds."""
    c = ivf.centroids.astype(np.float64)
    cent_key = (c * c).sum(axis=1) - 2.0 * (c @ q)
    cent_err = 2 * DIMS * U * ((c * c).sum(axis=1) + 2 * np.abs(c) @ np.abs(q))
    key = cent_key[ivf.block_centroid]
    budget = tknn.ivf_budget(nprobe, len(c), len(key))
    if budget >= len(key):
        return
    order = np.argsort(key, kind="stable")
    a, b = order[budget - 1], order[budget]
    gap = key[b] - key[a]
    err = cent_err[ivf.block_centroid[a]] + cent_err[ivf.block_centroid[b]]
    assert gap == 0 or gap > err, f"probe boundary gap {gap} <= {err}"


# The carried-index data (TestIvfKnn's: 8 centers x5, sigma 0.5) holds
# places where the contract cannot decide, both listed here so a change
# fails loudly: (1) k boundaries whose two scores lie closer than their
# f32 bounds (cosinesimil, queries 3 and 8; query 3's 10th and 11th
# candidates lie 4.5e-7 apart, 8 ulps); ids, order and totals are still
# held exactly there, and agree; (2) served l2 scores of near neighbors (|v|^2 ~ 700, d^2 ~ 1.5:
# the |v|^2 - 2 v.q + |q|^2 expansion cancels ~3 digits in both packages)
# that differ from the reference's by more than 1e-5 while both lie within
# the f32 bound of the f64 score.
IVF_NEAR_TIES = {"cosinesimil": [3, 8]}
IVF_OVER_CONTRACT = {"l2": {"q3.hits.hits[0]._score", "q3.hits.max_score",
                            ".responses[3].hits.hits[7]._score"}}


@pytest.mark.parametrize("space", SPACES)
def test_ivf_parity_with_carried_index(space):
    """Serving over the reference's own IVFIndex: the probe is held
    exactly (block-key margins asserted), so pages equal the reference's:
    ids, order and totals exactly, scores under the knn bound."""
    vectors, queries, jm, jseg, tm, tseg = _ivf_segment_pair(space)
    ivf = jseg.vector_dv["vec"].ivf
    jex = JExecutor(JReader(jm, [jseg]))
    reader = TReader(tm, CPU)
    reader.add_segment(tseg)
    tex = TExecutor(reader)
    live = np.array([jseg.live[i] for i in range(len(vectors))])
    bodies, ties = [], []
    for qi, q in enumerate(queries):
        nprobe = 3 if qi % 2 else 5
        _assert_probe_margin(ivf, q.astype(np.float64), nprobe)
        # the probe's candidates: every live doc of the chosen blocks
        c = ivf.centroids.astype(np.float64)
        key = ((c * c).sum(axis=1) - 2.0 * (c @ q))[ivf.block_centroid]
        budget = tknn.ivf_budget(nprobe, len(c), len(key))
        blocks = np.argsort(key, kind="stable")[:budget]
        cand = ivf.lists[blocks].reshape(-1)
        cand = cand[(cand >= 0)]
        cand = cand[live[cand]]
        if near_ties([np_scores(vectors[cand], q, space)], 10):
            ties.append(qi)
        spec = {"vector": q.tolist(), "k": 10}
        if qi % 2:
            spec["method_parameters"] = {"nprobes": 3}
        else:
            spec["method_parameters"] = {"nprobe": 5}
        bodies.append({"query": {"knn": {"vec": spec}}, "size": 10})
    assert ties == IVF_NEAR_TIES.get(space, [])

    def truth_of(responses):
        """(f64 score, f32 bound) of the hit a score path names."""
        def truth(path):
            r = int(path.split("]")[0].split("[")[-1]) \
                if path.startswith(".responses") \
                else int(path[1:].split(".")[0])
            hits = responses[r]["hits"]["hits"]
            h = 0 if path.endswith("max_score") \
                else int(path.split("hits[")[-1].split("]")[0])
            exact, bound = np_scores(
                vectors[int(hits[h]["_id"][1:])][None, :], queries[r],
                space)
            return float(exact[0]), float(bound[0])
        return truth

    over = []
    singles = [jex.search(body) for body in bodies]
    for qi, body in enumerate(bodies):
        assert_knn_response(tex.search(body), singles[qi], f"q{qi}",
                            truth_of(singles), over)
    batch = jex.multi_search(bodies)
    assert_knn_response(tex.multi_search(bodies), batch, "",
                        truth_of(batch["responses"]), over)
    assert {o[0] for o in over} == IVF_OVER_CONTRACT.get(space, set())


def test_ivf_recall_on_clustered_data():
    """tests/test_knn.py::TestIvfKnn's recall bar (>= 0.9 at k=10) for the
    port's own IVF, built at seal by the plain k-means step."""
    vectors, queries = _ivf_corpus()
    tn = TNode(device="cpu")
    tn.request("PUT", f"/{INDEX}", {"mappings": {"properties": {"vec": {
        "type": "knn_vector", "dimension": DIMS,
        "method": {"name": "ivf", "space_type": "l2",
                   "parameters": {"nlist": 8, "nprobes": 4}}}}}})
    tn.request("POST", "/_bulk", bulk_ndjson(INDEX, {
        f"d{i}": {"vec": v.tolist()} for i, v in enumerate(vectors)}))
    tn.request("POST", f"/{INDEX}/_refresh")
    seg = tn.indices.get(INDEX).shards[0].engine.segments[0]
    assert seg.vector_dv["vec"].ivf is not None
    recalls = []
    for q in queries:
        resp = tn.request("POST", f"/{INDEX}/_search", {"query": {"knn": {
            "vec": {"vector": q.tolist(), "k": 10}}}, "size": 10})
        got = {h["_id"] for h in resp["hits"]["hits"]}
        want = {f"d{i}" for i in np.argsort(
            -np_scores(vectors, q, "l2")[0])[:10]}
        recalls.append(len(got & want) / 10)
    assert np.mean(recalls) >= 0.9, recalls


def test_build_ivf_matches_the_reference():
    """The port's build_ivf (plain k-means step) against the reference's
    on the well-separated TestIvfKnn data: centroids within the f32 sum
    bound of the last step's means, and the lists equal, with every
    point's best and second-best centroid distances further apart than
    the distance bound."""
    vectors, _q = _ivf_corpus()
    exists = np.ones(len(vectors), bool)
    exists[::53] = False
    j = jknn.build_ivf(vectors, exists, nlist=8, nprobe=4)
    t = tknn.build_ivf(vectors, exists, nlist=8, nprobe=4, device="cpu")
    data = vectors[exists].astype(np.float64)
    c = t.centroids.astype(np.float64)
    d2 = ((data[:, None, :] - c[None, :, :]) ** 2).sum(axis=2)
    assign = np.argmin(d2, axis=1)
    # centroid bound: two f32 sums of the same members (n * 2^-24 *
    # sum|x| each) over the count, plus the division's rounding
    bound = np.zeros_like(c)
    for k in range(len(c)):
        m = data[assign == k]
        bound[k] = 2 * 2.0 ** -24 * np.abs(m).sum(axis=0) \
            + 2 * 2.0 ** -24 * np.abs(c[k])
    diff = np.abs(t.centroids.astype(np.float64)
                  - j.centroids.astype(np.float64))
    assert (diff <= bound).all(), float((diff - bound).max())
    # distance bound of the host assignment in f32 (dims-term sums of
    # magnitude |x|^2 + 2|x||c| + |c|^2) plus the centroid difference
    scale = (data ** 2).sum(axis=1)[:, None] + (c ** 2).sum(axis=1)[None, :] \
        + 2 * np.abs(data) @ np.abs(c).T
    tol = 4 * DIMS * 2.0 ** -24 * scale \
        + 2 * np.sqrt(d2) * np.linalg.norm(diff, axis=1)[None, :]
    best2 = np.sort(d2, axis=1)[:, :2]
    gap = best2[:, 1] - best2[:, 0]
    assert (gap > tol[np.arange(len(data)), assign]).all()
    np.testing.assert_array_equal(t.lists, j.lists)
    np.testing.assert_array_equal(t.block_centroid, j.block_centroid)
    assert (t.nlist, t.nprobe) == (j.nlist, j.nprobe)


# -------------------------------------------- plain versions vs reference

@pytest.mark.parametrize("space", SPACES)
def test_exact_scores_and_match_topk_equal_the_reference(space):
    """K7's plain version against raw_similarity + space_score, and
    knn_match_topk (through K3's plain version) against the reference's,
    including k past the eligible count and a doc-0 winner."""
    rng = np.random.RandomState(4)
    vecs = rng.randn(256, DIMS).astype(np.float32)
    vecs[200:] = 0.0                       # padding rows
    qs = rng.randn(5, DIMS).astype(np.float32)
    qs[1] = vecs[0]
    got = tknn.exact_knn_scores(torch.from_numpy(vecs), torch.from_numpy(qs),
                                space).numpy()
    for b, q in enumerate(qs):
        want = np.asarray(jknn.exact_knn_scores(jnp.asarray(vecs),
                                                jnp.asarray(q), space))
        np.testing.assert_allclose(got[b], want, rtol=KNN_RTOL,
                                   atol=KNN_ATOL)
    eligible = np.zeros((5, 256), bool)
    eligible[:, :200] = rng.rand(5, 200) < 0.6
    eligible[1, 0] = True
    eligible[4] = False
    eligible[4, [0, 7, 9]] = True           # fewer eligible than k
    live = torch.ones(256, dtype=torch.bool)
    ts, tm = tknn.knn_match_topk(torch.from_numpy(got),
                                 torch.from_numpy(eligible), live, 10)
    for b in range(5):
        assert_margins([np_scores(vecs[eligible[b]], qs[b], space)], 10,
                       f"row {b}")
        js, jm_ = jknn.knn_match_topk(jnp.asarray(got[b]),
                                      jnp.asarray(eligible[b]), 10)
        np.testing.assert_array_equal(tm[b].numpy(), np.asarray(jm_))
        np.testing.assert_array_equal(ts[b].numpy(), np.asarray(js))
    assert bool(tm[1, 0]) and int(tm[4].sum()) == 3


@pytest.mark.parametrize("space", SPACES)
def test_ivf_scores_equal_the_reference(space):
    """K8's plain version against ivf_knn_scores on a carried index:
    candidate masks exactly, scores within the bound."""
    vectors, queries, _jm, jseg, _tm, _tseg = _ivf_segment_pair(space)
    ivf = jseg.vector_dv["vec"].ivf
    packed, ids = jknn.pack_ivf_lists(vectors, ivf.lists)
    d = 1024
    for nprobe in (1, 3, 8):
        dense, mask = tknn.ivf_knn_scores(
            torch.from_numpy(packed), torch.from_numpy(ids),
            torch.from_numpy(np.array(ivf.centroids)),
            torch.from_numpy(np.array(ivf.block_centroid)), d,
            torch.from_numpy(queries), space, nprobe)
        for b, q in enumerate(queries):
            _assert_probe_margin(ivf, q.astype(np.float64), nprobe)
            jd, jmask = jknn.ivf_knn_scores(
                jnp.asarray(packed), jnp.asarray(ids),
                jnp.asarray(ivf.centroids), jnp.asarray(ivf.block_centroid),
                d, jnp.asarray(q), space, nprobe)
            np.testing.assert_array_equal(mask[b].numpy(), np.asarray(jmask))
            # every candidate's score, served or not, within the f32 bound
            # of two summation orders (the contract's 1e-5 holds for the
            # served top-k; a far-off candidate with heavy cancellation,
            # ip = v.q near 0 from |v||q| ~ 400, may exceed it)
            cand = np.nonzero(np.asarray(jmask))[0]
            _s, err = np_scores(vectors[cand], q, space)
            diff = np.abs(dense[b].numpy()[cand].astype(np.float64)
                          - np.asarray(jd)[cand])
            assert (diff <= err).all(), float((diff - err).max())
            assert (dense[b].numpy()[~np.asarray(jmask)] == 0).all()


def test_kmeans_step_equals_the_reference():
    """K9's plain version against one step of the reference's _kmeans:
    assignments exactly (margins asserted), centroids within the f32 sum
    bound of the exact means."""
    vectors, _q = _ivf_corpus()
    rng = np.random.RandomState(17)
    init = vectors[rng.choice(len(vectors), size=8, replace=False)]
    new, assign = tknn.kmeans_step(torch.from_numpy(vectors),
                                   torch.from_numpy(init))
    j1 = np.asarray(jknn._kmeans(vectors, 8, iters=1, seed=17))
    x = vectors.astype(np.float64)
    d2 = ((x[:, None, :] - init.astype(np.float64)[None]) ** 2).sum(axis=2)
    best2 = np.sort(d2, axis=1)[:, :2]
    assert (best2[:, 1] - best2[:, 0] > 1e-3).all()
    np.testing.assert_array_equal(assign.numpy(), np.argmin(d2, axis=1))
    for k in range(8):
        m = x[assign.numpy() == k]
        exact = m.mean(axis=0)
        bound = 2.0 ** -24 * np.abs(m).sum(axis=0) + 2.0 ** -23 * np.abs(exact)
        for side in (new.numpy()[k], j1[k]):
            assert (np.abs(side - exact) <= bound).all(), k


def test_kmeans_step_keeps_empty_centroids_and_ties_low():
    """An empty cluster keeps its centroid; an exact distance tie goes to
    the lowest centroid, as jnp.argmin does."""
    data = torch.tensor([[0.0, 0.0], [2.0, 0.0], [2.0, 0.1]])
    cent = torch.tensor([[1.0, 0.0], [1.0, 0.0], [50.0, 50.0]])
    new, assign = tknn.kmeans_step(data, cent)
    assert assign.tolist() == [0, 0, 0]
    assert torch.equal(new[2], cent[2]) and torch.equal(new[1], cent[1])


def test_kmeans_step_ties_and_a_far_centroid_equal_the_reference():
    """One step from initial centroids with exact duplicates at indices
    (0, nlist - 1), (15, 16) and (63, 64) and one far centroid (a point at
    1e18: |c|^2 near 1e37, every other distance to it far from the
    minimum): the plain step's means equal the reference's within the f32
    sum bound (the lower duplicate takes the tie, the upper one stays
    empty and keeps its centroid), and its assignments are the f64
    argmin, ties to the lowest index."""
    nlist, far = 70, 40
    vectors, _q = _ivf_corpus(n=900, seed=11)
    idx = np.random.RandomState(17).choice(len(vectors), size=nlist,
                                           replace=False)
    for lo, hi in ((0, nlist - 1), (15, 16), (63, 64)):
        vectors[idx[hi]] = vectors[idx[lo]]
    vectors[idx[far]] = 1e18
    init = vectors[idx]
    new, assign = tknn.kmeans_step(torch.from_numpy(vectors),
                                   torch.from_numpy(init))
    j1 = np.asarray(jknn._kmeans(vectors, nlist, iters=1, seed=17))
    x = vectors.astype(np.float64)
    d2 = ((x[:, None, :] - init.astype(np.float64)[None]) ** 2).sum(axis=2)
    want = np.argmin(d2, axis=1)
    np.testing.assert_array_equal(assign.numpy(), want)
    assert assign[idx[far]] == far and (want == far).sum() == 1
    for lo, hi in ((0, nlist - 1), (15, 16), (63, 64)):
        assert (want == lo).any() and not (want == hi).any()
    # the assignment does not hang on rounding: distinct centroids differ
    # by more than the f32 error of either side's distances
    uniq = np.unique(init, axis=0, return_index=True)[1]
    near = np.sort(d2[:, uniq], axis=1)[:, :2]
    assert (near[:, 1] - near[:, 0] > 1e-3).all()
    for k in range(nlist):
        m = x[assign.numpy() == k]
        if len(m) == 0:
            assert np.array_equal(new.numpy()[k], init[k])
            assert np.array_equal(j1[k], init[k])
            continue
        exact = m.mean(axis=0)
        bound = 2.0 ** -24 * np.abs(m).sum(axis=0) + 2.0 ** -23 * np.abs(exact)
        for side in (new.numpy()[k], j1[k]):
            assert (np.abs(side - exact) <= bound).all(), k


def _tie_distances(n, nlist, seed):
    """f32 [n, nlist] distances with many exact ties (small integers), and
    rows that tie across the kernel's lane, register-tile and block
    boundaries, of +inf, of NaN and of -inf."""
    rng = np.random.RandomState(seed)
    dist = rng.randint(0, 6, (n, nlist)).astype(np.float32)
    rows = [(15, 16), (0, nlist - 1), (3, 4), (63, 64), (255, 256),
            (60, 124), (1, 257)]
    for r, pair in enumerate(rows):
        if max(pair) < nlist:
            dist[r] = 9.0
            dist[r, list(pair)] = 2.0
    dist[8] = np.inf                            # none finite: centroid 0
    dist[9] = np.inf
    dist[9, nlist - 1] = 7.0                    # only the last finite
    dist[10] = np.nan
    dist[10, nlist // 2] = 3.0                  # NaN is never taken
    dist[11, [5, nlist - 2]] = -np.inf          # the first -inf
    dist[12] = np.nan                           # none taken: centroid 0
    return dist


def test_kmeans_constants_are_the_kernels():
    """The wrapper's centroid block and the mirror's lane schedule are
    kmeans_step.cu's: 16 lanes a point group, 4 points x 16 centroids a
    lane, blocks of 256 centroids."""
    import re
    from pathlib import Path
    import kmeans_assign_mirror as mirror
    src = (Path(tknn.__file__).parent / "csrc" / "kmeans_step.cu"
           ).read_text()

    def const(name):
        return re.findall(rf"constexpr int {name} = (\w+(?: \* \w+)?);",
                          src)
    assert const("RP") == [str(mirror.RP)] and const("RC") == ["16"]
    assert const("CG") == [str(mirror.CG)] and const("CB") == ["CG * RC"]
    assert mirror.CB == tknn.KMEANS_BLOCK == mirror.CG * 16
    assert const("TILE") == [str(tknn.KMEANS_TILE)]
    assert const("CHUNK") == [str(tknn.KMEANS_CHUNK)]


@pytest.mark.parametrize("nlist", [17, 64, 256, 257, 600])
def test_kmeans_assign_mirror_keeps_the_scan(nlist):
    """K9's assignment schedule (tests/kmeans_assign_mirror.py: a
    half-warp's 16 lanes over 4 rotated point slots and 16 centroids a
    block each, scans with a strict <, then shuffle combines of (d, c))
    equals the ascending scan with a strict <, and torch.argmin (the plain
    version's) on every row without NaN: exact ties within a lane, across
    lanes, register tiles and blocks of 256, a row of +inf, NaN rows, -inf,
    and point counts off the 4-point group."""
    dist = _tie_distances(41, nlist, seed=nlist)
    got = lanes_assign(dist)
    want = scan_assign(dist)
    np.testing.assert_array_equal(got, want)
    assert want[8] == 0 and want[9] == nlist - 1 and want[12] == 0
    assert want[10] == nlist // 2 and want[11] == 5
    clean = ~np.isnan(dist).any(axis=1)
    np.testing.assert_array_equal(
        want[clean], torch.argmin(torch.from_numpy(dist[clean]), 1).numpy())


# ------------------------------------------------------------ the corpus

def test_clustered_vectors_is_the_reference_stream():
    """bench.py's bench_knn corpus and queries, drawn line for line."""
    n, dims, n_q = 500, 12, 9
    rng = np.random.RandomState(11)
    centers = rng.randn(256, dims).astype(np.float32) * 4
    assign = rng.randint(0, 256, size=n)
    vectors = centers[assign] + rng.randn(n, dims).astype(np.float32)
    queries = (centers[rng.randint(0, 256, size=n_q)]
               + rng.randn(n_q, dims).astype(np.float32))
    got_v, got_q = clustered_vectors(n, dims, n_queries=n_q)
    np.testing.assert_array_equal(got_v, vectors)
    np.testing.assert_array_equal(got_q, queries)
    assert got_v.dtype == np.float32 and got_q.dtype == np.float32


# ------------------------------------------------------ mappings and errors

@pytest.mark.parametrize("spec", [
    {"type": "knn_vector", "dimension": 4},
    {"type": "dense_vector", "dims": 3},
    {"type": "knn_vector", "dimension": 4, "space_type": "innerproduct"},
    {"type": "knn_vector", "dimension": 4, "method": {
        "name": "hnsw", "space_type": "cosinesimil"}},
    {"type": "knn_vector", "dimension": 8, "space_type": "l2", "method": {
        "name": "ivf", "parameters": {"nlist": 32, "nprobe": 5}}},
    {"type": "knn_vector", "dimension": 8, "method": {
        "name": "ivf", "space_type": "innerproduct",
        "parameters": {"nprobes": 7}}},
])
def test_mapping_field_types_equal_the_reference(spec):
    attrs = ("type", "dims", "similarity_space", "knn_method", "knn_nlist",
             "knn_nprobe")
    j = JMapper({"properties": {"v": spec}}).get_field("v")
    t = TMapper({"properties": {"v": spec}}).get_field("v")
    assert t.is_vector and j.is_vector
    assert {a: getattr(t, a) for a in attrs} == \
        {a: getattr(j, a) for a in attrs}


@pytest.mark.parametrize("settings", [None, {"index": {"knn": True}},
                                      {"index.knn": True,
                                       "number_of_shards": 1}])
def test_create_index_responses_equal_the_reference(settings):
    body = {"mappings": {"properties": {"v": {
        "type": "knn_vector", "dimension": 4,
        "method": {"name": "hnsw", "space_type": "l2"}}}}}
    if settings is not None:
        body["settings"] = settings
    want = JNode().request("PUT", "/k", body)
    got = TNode(device="cpu").request("PUT", "/k", body)
    assert got == want


ERROR_CASES = {
    "no_dimension": ("PUT", "/e", {"mappings": {"properties": {
        "v": {"type": "knn_vector"}}}}),
    "doc_dimension_mismatch": ("PUT", "/k/_doc/1", {"v": [1.0, 2.0, 3.0]}),
    "doc_not_numeric": ("PUT", "/k/_doc/1", {"v": [1, 2, "x", 4]}),
    "doc_not_a_list": ("PUT", "/k/_doc/1", {"v": "1,2,3,4"}),
    "query_dimension_mismatch": ("POST", "/k/_search", {"query": {"knn": {
        "v": {"vector": [1, 2, 3], "k": 3}}}}),
    "query_not_a_vector_field": ("POST", "/k/_search", {"query": {"knn": {
        "t": {"vector": [1, 2, 3, 4], "k": 3}}}}),
    "query_two_fields": ("POST", "/k/_search", {"query": {"knn": {
        "v": {"vector": [1, 2, 3, 4]}, "w": {"vector": [1]}}}}),
}


@pytest.mark.parametrize("name", sorted(ERROR_CASES))
def test_errors_equal_the_reference(name):
    method, path, body = ERROR_CASES[name]
    out = []
    for node in (JNode(), TNode(device="cpu")):
        node.request("PUT", "/k", {"mappings": {"properties": {
            "v": {"type": "knn_vector", "dimension": 4},
            "t": {"type": "keyword"}}}})
        node.request("PUT", "/k/_doc/0", {"v": [0, 1, 2, 3], "t": "x"},
                     refresh="true")
        out.append(node.request(method, path, body))
    want, got = out
    assert want["_status"] == 400, want
    assert got == want


def test_k_past_the_sort_limit_equals_the_reference():
    """k = 20,000 over a 24,000-vector index: the knn node's 20,000
    winners come from K3's threshold entry (past MAX_K = 16,384), the
    page from K3; `hits.total` and the page equal the reference's."""
    vectors = np.random.RandomState(7).randn(24000, 8).astype(np.float32)
    mapping = {"mappings": {"properties": {"v": {
        "type": "knn_vector", "dimension": 8}}}}
    docs = {f"d{i}": {"v": v.tolist()} for i, v in enumerate(vectors)}
    q = np.random.RandomState(8).randn(8).astype(np.float32)
    out = []
    for node in (JNode(), TNode(device="cpu")):
        node.request("PUT", "/big", mapping)
        res = node.request("POST", "/_bulk", bulk_ndjson("big", docs))
        assert not res["errors"]
        node.request("POST", "/big/_refresh")
        out.append(node.request("POST", "/big/_search", {"query": {"knn": {
            "v": {"vector": q.tolist(), "k": 20000}}}, "size": 25}))
    want, got = out
    assert want["hits"]["total"] == {"value": 20000, "relation": "eq"}
    s, err = np_scores(vectors, q, "l2")
    assert_margins([(s, err)], 25, "page")
    assert_knn_response(got, want, "k20000")


@pytest.mark.parametrize("method", ["exact", "ivf"])
def test_selections_past_a_lowered_limit_equal_the_reference(monkeypatch,
                                                             method):
    """With MAX_K lowered to 4, a knn k of 5 and an IVF probe budget of 5
    blocks take the selections past the limit (K3's threshold entry; on
    the CPU its plain version) and serve the reference's pages."""
    monkeypatch.setattr(tknn, "MAX_K", 4)
    vectors = _vectors()
    mapping = _mapping("l2", "ivf" if method == "ivf" else None, nlist=8,
                       nprobes=2)
    jn, tn = JNode(), TNode(device="cpu")
    for node in (jn, tn):
        _load(node, vectors, mapping, split=False)
    seg = tn.indices.get(INDEX).shards[0].engine.segments[0]
    assert (seg.vector_dv["vec"].ivf is not None) == (method == "ivf")
    q = _queries(5, 1)[0].tolist()
    spec = {"vector": q, "k": 5}
    if method == "ivf":
        spec.update(k=3, method_parameters={"nprobes": 4})
        ivf = seg.vector_dv["vec"].ivf
        assert tknn.ivf_budget(4, ivf.nlist, ivf.lists.shape[0]) > 4
    body = {"query": {"knn": {"vec": spec}}, "size": 10}
    _same(jn, tn, body, method)


def test_segment_memory_bytes_count_vectors():
    """The sealed vector column counts in the segment's host bytes, as in
    the reference (a segment with no text: no positions on either side)."""
    vectors = _vectors(40)
    spec = {"properties": {"vec": {"type": "knn_vector", "dimension": DIMS}}}
    segs = []
    for mapper_cls, builder_cls in ((JMapper, JBuilder), (TMapper, TBuilder)):
        m = mapper_cls(spec)
        b = builder_cls(m)
        for i, v in enumerate(vectors):
            if i % 5:
                b.add(m.parse_document(f"d{i}", {"vec": v.tolist()}))
            else:
                b.add(m.parse_document(f"d{i}", {}))
        segs.append(b.seal())
    jseg, tseg = segs
    np.testing.assert_array_equal(tseg.vector_dv["vec"].vectors,
                                  jseg.vector_dv["vec"].vectors)
    np.testing.assert_array_equal(tseg.vector_dv["vec"].exists,
                                  jseg.vector_dv["vec"].exists)
    assert tseg.memory_bytes() == jseg.memory_bytes()


def test_masked_topk_is_the_block_choice():
    """The IVF block choice is K3 over the negated centroid keys: with all
    lanes eligible it is lax.top_k, lowest block first among the blocks of
    one centroid."""
    key = torch.tensor([[3.0, 1.0, 1.0, 2.0, 1.0]])
    every = torch.ones(5, dtype=torch.bool)
    packed = topk.masked_topk(-key, every[None, :], every, every, 5,
                              torch.tensor([float("-inf")]), 3)
    _s, idx, total = topk.unpack_rows(packed.numpy(), 3)
    assert idx.tolist() == [[1, 2, 4]] and total.tolist() == [5]
