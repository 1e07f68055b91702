"""Segments and device images of opensearch_tpu_torch held against
opensearch_tpu: the same documents through each package's mapper and
SegmentBuilder.seal() give exactly equal term dictionaries, postings, norms,
field stats and block bounds; `upload_segment` images are equal tensor for
tensor; `segment_from_arrays` round-trips a reference segment."""

import numpy as np
import pytest
import torch

from opensearch_tpu.index.mapper import MapperService as JMapper
from opensearch_tpu.index.segment import SegmentBuilder as JBuilder
from opensearch_tpu.index.segment import block_score_bounds as j_bounds
from opensearch_tpu.ops.device_segment import upload_segment as j_upload

from opensearch_tpu_torch.index.mapper import MapperService as TMapper
from opensearch_tpu_torch.index.segment import SegmentBuilder as TBuilder
from opensearch_tpu_torch.index.segment import (block_score_bounds,
                                                segment_from_arrays)
from opensearch_tpu_torch.ops.device_segment import upload_segment
from opensearch_tpu_torch.utils import demo as tdemo
from opensearch_tpu.utils import demo as jdemo

from test_torch_common import MAPPING, corpus, segment_arrays

IMAGE_KEYS = ("post_docs", "post_tf", "post_bound", "norms", "length_table",
              "live", "root", "parent_ptr", "nested_path")


def _seal(mapper_cls, builder_cls, docs, deleted=()):
    mapper = mapper_cls(MAPPING["mappings"])
    builder = builder_cls(mapper)
    for i, doc in enumerate(docs):
        builder.add(mapper.parse_document(f"d{i}", doc))
    seg = builder.seal()
    for doc_id in deleted:
        seg.delete(doc_id)
    return seg


@pytest.fixture(scope="module")
def pair():
    docs = corpus(900)
    # multi-valued text, an object field and an empty text value, on top
    docs[1] = {"passage": ["first value", "second w00001 value"],
               "pid": ["p1", "p2", "p1"], "meta": {"tag": "x"}}
    docs[2] = {"passage": "", "tag": "cat0"}
    deleted = [f"d{i}" for i in range(0, 900, 41)]
    return (_seal(JMapper, JBuilder, docs, deleted),
            _seal(TMapper, TBuilder, docs, deleted))


def _assert_same_segment(t, j):
    assert t.num_docs == j.num_docs
    assert t.doc_ids == j.doc_ids and t.sources == j.sources
    assert list(t.term_dict) == list(j.term_dict)
    for key, tm in j.term_dict.items():
        assert vars(t.term_dict[key]) == vars(tm), key
    np.testing.assert_array_equal(t.post_docs, j.post_docs)
    np.testing.assert_array_equal(t.post_tf, j.post_tf)
    assert t.post_docs.dtype == j.post_docs.dtype
    assert t.post_tf.dtype == j.post_tf.dtype
    assert sorted(t.norms) == sorted(j.norms)
    for f in j.norms:
        np.testing.assert_array_equal(t.norms[f], j.norms[f])
        assert t.norms[f].dtype == j.norms[f].dtype
    assert {f: vars(s) for f, s in t.field_stats.items()} == \
        {f: vars(s) for f, s in j.field_stats.items()}
    np.testing.assert_array_equal(t.live, j.live)
    np.testing.assert_array_equal(t.root, j.root)
    np.testing.assert_array_equal(block_score_bounds(t), j_bounds(j))


def test_sealed_segments_are_equal(pair):
    _assert_same_segment(pair[1], pair[0])


def test_segment_from_arrays_round_trips(pair):
    jseg = pair[0]
    _assert_same_segment(segment_from_arrays(segment_arrays(jseg)), jseg)


@pytest.mark.parametrize("source", ["sealed_here", "from_arrays"])
def test_device_images_are_equal(pair, source):
    jseg, tseg = pair
    if source == "from_arrays":
        tseg = segment_from_arrays(segment_arrays(jseg))
    jimg, jmeta = j_upload(jseg)
    timg, tmeta = upload_segment(tseg, torch.device("cpu"))
    # the flat leaves, plus the doc-value, vector and token-matrix
    # subtrees (keyword columns here, no vectors)
    assert set(IMAGE_KEYS) <= set(jimg) \
        and set(timg) == set(IMAGE_KEYS) | {"numeric", "ordinal", "vector",
                                            "rank_vectors"}
    for key in IMAGE_KEYS:
        want = np.asarray(jimg[key])
        got = timg[key].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    for kind in ("numeric", "ordinal", "vector", "rank_vectors"):
        assert set(timg[kind]) == set(jimg[kind]), kind
        for field, leaves in jimg[kind].items():
            assert set(timg[kind][field]) == set(leaves), (kind, field)
            for leaf, want in leaves.items():
                got = timg[kind][field][leaf].numpy()
                want = np.asarray(want)
                assert got.dtype == want.dtype \
                    and got.shape == want.shape, (kind, field, leaf)
                np.testing.assert_array_equal(got, want)
    assert (tmeta.num_docs, tmeta.d_pad, tmeta.nb_pad, tmeta.norm_rows) == \
        (jmeta.num_docs, jmeta.d_pad, jmeta.nb_pad, jmeta.norm_rows)


VECTOR_LEAVES = ("vectors", "exists", "ivf_packed_vecs", "ivf_packed_ids",
                 "ivf_centroids", "ivf_block_centroid")


def _vector_pair(method):
    """One reference segment with an exact and (optionally) an IVF vector
    field, docs without vectors and deletes; the port's segment carries
    it across with the reference's IVFIndex."""
    dims = 8
    vec = {"type": "knn_vector", "dimension": dims}
    spec = {"properties": {
        "v": {**vec, "method": {"space_type": "cosinesimil"}},
        "w": {**vec, "method": {"name": method, "space_type": "l2",
                                "parameters": {"nlist": 5}}},
        "tag": {"type": "keyword"}}}
    rng = np.random.RandomState(8)
    mapper = JMapper(spec)
    builder = JBuilder(mapper)
    for i in range(700):
        doc = {"tag": f"t{i % 3}"}
        if i % 11:
            doc["v"] = rng.randn(dims).tolist()
        if i % 7:
            doc["w"] = rng.randn(dims).tolist()
        builder.add(mapper.parse_document(f"d{i}", doc))
    jseg = builder.seal()
    for i in range(0, 700, 29):
        jseg.delete(f"d{i}")
    arrays = segment_arrays(jseg)
    arrays["vector_dv"] = {
        f: {"vectors": c.vectors, "exists": c.exists,
            "ivf": None if c.ivf is None else {
                "centroids": c.ivf.centroids, "lists": c.ivf.lists,
                "block_centroid": c.ivf.block_centroid,
                "nlist": c.ivf.nlist, "nprobe": c.ivf.nprobe}}
        for f, c in jseg.vector_dv.items()}
    return jseg, arrays


@pytest.mark.parametrize("method", ["exact", "ivf"])
def test_vector_images_are_equal(method):
    """The port's "vector" subtree equals the reference's upload_segment
    image leaf for leaf (exact and IVF fields), and the meta names the
    vector fields."""
    jseg, arrays = _vector_pair(method)
    assert (jseg.vector_dv["w"].ivf is not None) == (method == "ivf")
    tseg = segment_from_arrays(arrays)
    jimg, jmeta = j_upload(jseg, to_device=False)
    timg, tmeta = upload_segment(tseg, torch.device("cpu"))
    assert set(timg["vector"]) == set(jimg["vector"]) == {"v", "w"}
    for field, leaves in jimg["vector"].items():
        assert set(timg["vector"][field]) == set(leaves)
        assert set(leaves) <= set(VECTOR_LEAVES)
        for leaf, want in leaves.items():
            got = timg["vector"][field][leaf].numpy()
            want = np.asarray(want)
            assert got.dtype == want.dtype and got.shape == want.shape, \
                (field, leaf)
            np.testing.assert_array_equal(got, want)
    assert tmeta.vector_fields == tuple(jmeta.vector_fields) == ("v", "w")
    assert tmeta.compile_key() != upload_segment(
        segment_from_arrays({**arrays, "vector_dv": {}}),
        torch.device("cpu"))[1].compile_key()


def test_segment_from_arrays_refuses_bad_ivf_lists():
    """A doc ord twice in the IVF lists would race in the probe's stores;
    so would an ord past the segment: both are refused."""
    jseg, arrays = _vector_pair("ivf")
    lists = np.array(arrays["vector_dv"]["w"]["ivf"]["lists"])
    twice = lists.copy()
    twice[1, 0] = twice[0, 0]
    arrays["vector_dv"]["w"]["ivf"]["lists"] = twice
    with pytest.raises(ValueError, match="at most once"):
        segment_from_arrays(arrays)
    past = lists.copy()
    past[0, 0] = jseg.num_docs
    arrays["vector_dv"]["w"]["ivf"]["lists"] = past
    with pytest.raises(ValueError, match="at most once"):
        segment_from_arrays(arrays)
    arrays["vector_dv"]["w"]["ivf"]["lists"] = lists
    assert segment_from_arrays(arrays).vector_dv["w"].ivf is not None


def test_demo_generators_are_the_references():
    assert tdemo.synth_docs(40, 500, 20, 3) == jdemo.synth_docs(40, 500, 20, 3)
    assert tdemo.query_terms(9, 500, 4, 3) == jdemo.query_terms(9, 500, 4, 3)
    _m, tsegs, tterms = tdemo.build_shards_fast(3000, 2, 4000, 30, 5, 64)
    _m, jsegs, jterms = jdemo.build_shards_fast(3000, 2, 4000, 30, 5, 64)
    assert tterms == jterms
    assert tdemo.fast_query_terms(7, tterms, 2, 3) == \
        jdemo.fast_query_terms(7, jterms, 2, 3)
    for t, j in zip(tsegs, jsegs):
        _assert_same_segment(t, j)


def test_rank_vectors_images_are_equal():
    """The port's "rank_vectors" subtree (exact: tokens; PQ: codes and
    codebook; both: token counts and exists) equals the reference's
    upload_segment image leaf for leaf, after each package seals the same
    documents, and the meta names each field with its token bucket and
    storage."""
    spec = {"type": "rank_vectors", "dimension": 6, "max_tokens": 12}
    mapping = {"properties": {"tok": spec,
                              "pq": {**spec, "compression": "pq"}}}
    rng = np.random.RandomState(17)
    docs = []
    for i in range(70):
        toks = rng.randn(int(rng.randint(0, 10)), 6).round(3).tolist()
        docs.append({"tok": toks, "pq": toks} if i % 6 else {})
    segs = []
    for mapper_cls, builder_cls in ((JMapper, JBuilder), (TMapper, TBuilder)):
        m = mapper_cls(mapping)
        b = builder_cls(m)
        for i, d in enumerate(docs):
            b.add(m.parse_document(f"d{i}", d))
        segs.append(b.seal())
    jseg, tseg = segs
    jimg, jmeta = j_upload(jseg, to_device=False)
    timg, tmeta = upload_segment(tseg, torch.device("cpu"))
    assert set(timg["rank_vectors"]) == set(jimg["rank_vectors"]) \
        == {"tok", "pq"}
    assert set(timg["rank_vectors"]["pq"]) == {"token_count", "exists",
                                               "codes", "codebook"}
    for field, leaves in jimg["rank_vectors"].items():
        assert set(timg["rank_vectors"][field]) == set(leaves)
        for leaf, want in leaves.items():
            got = timg["rank_vectors"][field][leaf].numpy()
            want = np.asarray(want)
            assert got.dtype == want.dtype and got.shape == want.shape, \
                (field, leaf)
            np.testing.assert_array_equal(got, want)
    assert tmeta.rank_vector_fields == tuple(jmeta.rank_vector_fields) \
        == (("pq", 16, "pq"), ("tok", 16, "none"))


def test_positions_equal_the_reference(pair):
    """The host positions phrase queries read: one sorted int32 array per
    posting of each text term, across multi-valued fields' position gaps,
    equal to the reference's; `_positions_for`, `terms_for_field` and a
    `segment_from_arrays` round trip agree too."""
    j, t = pair
    assert list(t.positions) == list(j.positions)
    for key, lists in j.positions.items():
        got = t.positions[key]
        assert len(got) == len(lists) == t.term_dict[key].doc_freq
        for g, w in zip(got, lists):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    assert t.terms_for_field("passage") == j.terms_for_field("passage")
    for term in ("w00001", "value", "first"):
        want = j._positions_for("passage", term)
        got = t._positions_for("passage", term)
        assert sorted(got) == sorted(want)
        for d in want:
            np.testing.assert_array_equal(got[d], want[d])
    arrays = segment_arrays(j)
    arrays["positions"] = dict(j.positions)
    carried = segment_from_arrays(arrays)
    assert carried.memory_bytes() == j.memory_bytes()
    bad = dict(arrays, positions={("passage", "value"): []})
    with pytest.raises(ValueError, match="one array per posting"):
        segment_from_arrays(bad)
