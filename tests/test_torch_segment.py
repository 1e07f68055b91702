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
    # the flat leaves, plus the doc-value subtrees (keyword columns here)
    assert set(IMAGE_KEYS) <= set(jimg) \
        and set(timg) == set(IMAGE_KEYS) | {"numeric", "ordinal"}
    for key in IMAGE_KEYS:
        want = np.asarray(jimg[key])
        got = timg[key].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    for kind in ("numeric", "ordinal"):
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
