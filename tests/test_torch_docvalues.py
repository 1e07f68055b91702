"""Doc values of opensearch_tpu_torch held against opensearch_tpu: the same
documents through each package's mapper and SegmentBuilder.seal() give
equal numeric / date / boolean / keyword columns (pairs, ranks, unique
tables, dictionaries, hashes, identity layout); `segment_from_arrays`
carries a reference segment's columns across; and `upload_segment`'s
numeric and ordinal leaves equal the reference's tensor for tensor, on the
identity layout and on multi-valued / missing layouts."""

import numpy as np
import pytest
import torch

from opensearch_tpu.index.mapper import MapperService as JMapper
from opensearch_tpu.index.mapper import format_date_millis as j_fmt
from opensearch_tpu.index.mapper import parse_date_millis as j_parse
from opensearch_tpu.index.segment import SegmentBuilder as JBuilder
from opensearch_tpu.index.segment import ident_pairs as j_ident
from opensearch_tpu.ops.device_segment import upload_segment as j_upload

from opensearch_tpu_torch.common.errors import MapperParsingError
from opensearch_tpu_torch.index.mapper import MapperService as TMapper
from opensearch_tpu_torch.index.mapper import format_date_millis as t_fmt
from opensearch_tpu_torch.index.mapper import parse_date_millis as t_parse
from opensearch_tpu_torch.index.segment import SegmentBuilder as TBuilder
from opensearch_tpu_torch.index.segment import (ident_pairs,
                                                segment_from_arrays)
from opensearch_tpu_torch.ops.device_segment import upload_segment

from test_torch_common import DOCS_MAPPING, docs_corpus, segment_arrays

MAPPING = {"properties": {
    "k": {"type": "keyword"},
    "l": {"type": "long"},
    "i": {"type": "integer"},
    "s": {"type": "short"},
    "b8": {"type": "byte"},
    "d": {"type": "double"},
    "f": {"type": "float"},
    "t": {"type": "date"},
    "es": {"type": "date", "format": "epoch_second"},
    "flag": {"type": "boolean"},
    "nodv": {"type": "long", "doc_values": False},
    "txt": {"type": "text"},
}}

# identity layouts (every doc one value: k, l, t) and multi-valued /
# missing layouts (i, d, flag, ...), dates as strings and epoch numbers,
# booleans as strings, numbers as strings, nulls
DOCS = [
    {"k": "b", "l": 5, "i": [3, 1, 3], "d": 2.5, "t": "2024-01-05",
     "flag": True, "s": 7, "es": 1700000000, "txt": "a b"},
    {"k": "a", "l": -2, "d": [1.25, -0.5], "t": 1704067200000,
     "flag": "false", "b8": -3, "f": 0.1, "nodv": 4},
    {"k": "c", "l": 5, "i": "12", "t": "2024-02-29T12:30:00Z",
     "flag": [True, False], "f": [3.5, None]},
    {"k": "b", "l": 0, "t": "2023-12-31T23:59:59.999+01:00", "d": None,
     "i": None, "dyn_int": 3, "dyn_float": 1.5, "dyn_bool": True,
     "dyn_date": "2024-03-01", "dyn_str": "hello"},
    {"k": "a", "l": 9, "i": [2], "t": "2024-01", "flag": "true",
     "dyn_int": [4, 5]},
]


def _seal(mapper_cls, builder_cls, mapping, docs):
    mapper = mapper_cls(mapping)
    builder = builder_cls(mapper)
    for n, doc in enumerate(docs):
        builder.add(mapper.parse_document(f"d{n}", doc))
    return mapper, builder.seal()


@pytest.fixture(scope="module")
def small():
    return (_seal(JMapper, JBuilder, MAPPING, DOCS),
            _seal(TMapper, TBuilder, MAPPING, DOCS))


@pytest.fixture(scope="module")
def corpus():
    docs = docs_corpus(700)
    return (_seal(JMapper, JBuilder, DOCS_MAPPING["mappings"], docs),
            _seal(TMapper, TBuilder, DOCS_MAPPING["mappings"], docs))


def _assert_same_columns(t, j):
    assert sorted(t.numeric_dv) == sorted(j.numeric_dv)
    for f, jc in j.numeric_dv.items():
        tc = t.numeric_dv[f]
        for attr in ("doc_ids", "values", "exists", "counts", "value_ords",
                     "unique"):
            got, want = getattr(tc, attr), getattr(jc, attr)
            assert got.dtype == want.dtype and got.shape == want.shape, \
                (f, attr)
            np.testing.assert_array_equal(got, want, err_msg=f"{f}.{attr}")
        assert ident_pairs(tc) == j_ident(jc), f
    assert sorted(t.ordinal_dv) == sorted(j.ordinal_dv)
    for f, jc in j.ordinal_dv.items():
        tc = t.ordinal_dv[f]
        assert tc.dictionary == jc.dictionary, f
        for attr in ("doc_ids", "ords", "exists", "ord_hashes"):
            got, want = getattr(tc, attr), getattr(jc, attr)
            assert got.dtype == want.dtype and got.shape == want.shape, \
                (f, attr)
            np.testing.assert_array_equal(got, want, err_msg=f"{f}.{attr}")
        assert ident_pairs(tc) == j_ident(jc), f


def test_mapping_and_parsed_values_are_the_references(small):
    (jm, _j), (tm, _t) = small
    assert {n: ft.type for n, ft in tm.field_types.items()} == \
        {n: ft.type for n, ft in jm.field_types.items()}
    for n, doc in enumerate(DOCS):
        jd = jm.parse_document(f"d{n}", doc)
        td = tm.parse_document(f"d{n}", doc)
        assert sorted(td.fields) == sorted(jd.fields)
        for f, jpf in jd.fields.items():
            tpf = td.fields[f]
            assert tpf.numeric_values == jpf.numeric_values, f
            assert tpf.exact_values == jpf.exact_values, f


@pytest.mark.parametrize("value", [
    "2024-01-05", "2024-02-29T12:30:00Z", "2023-12-31T23:59:59.999+01:00",
    "2024-01", "2024", 1704067200000, "1704067200000", 1.7e12])
def test_dates_parse_and_format_like_the_reference(value):
    assert t_parse(value) == j_parse(value)
    assert t_fmt(t_parse(value)) == j_fmt(j_parse(value))


@pytest.mark.parametrize("field,value", [
    ("i", 2 ** 31), ("b8", 300), ("l", "x"), ("flag", "yes"), ("t", "nope"),
    ("d", float("nan")), ("l", True)])
def test_bad_values_raise_the_references_error(field, value):
    tm = TMapper(MAPPING)
    with pytest.raises(MapperParsingError) as got:
        tm.parse_document("x", {field: value})
    jm = JMapper(MAPPING)
    with pytest.raises(Exception) as want:
        jm.parse_document("x", {field: value})
    assert got.value.reason == want.value.reason


def test_sealed_columns_are_equal(small):
    (_jm, j), (_tm, t) = small
    _assert_same_columns(t, j)
    assert "nodv" not in t.numeric_dv and "txt" not in t.numeric_dv
    # the keyword postings still serve term queries on booleans
    assert t.get_term("flag", "true").doc_freq == \
        j.get_term("flag", "true").doc_freq


def test_corpus_columns_are_equal(corpus):
    (_jm, j), (_tm, t) = corpus
    _assert_same_columns(t, j)
    # the corpus leaves the identity layout on tag and views, keeps it on ts
    assert (ident_pairs(t.ordinal_dv["tag"]),
            ident_pairs(t.numeric_dv["views"]),
            ident_pairs(t.numeric_dv["ts"])) == (False, False, True)


@pytest.mark.parametrize("which", ["small", "corpus"])
def test_segment_from_arrays_carries_doc_values(small, corpus, which):
    (_jm, j), _ = small if which == "small" else corpus
    _assert_same_columns(segment_from_arrays(segment_arrays(j)), j)


def test_segment_from_arrays_refuses_bad_columns(small):
    (_jm, j), _ = small
    arrays = segment_arrays(j)
    arrays["numeric_dv"]["l"] = dict(arrays["numeric_dv"]["l"],
                                     value_ords=np.full(5, 99, np.int32))
    with pytest.raises(ValueError, match="unique table"):
        segment_from_arrays(arrays)


@pytest.mark.parametrize("which,source", [
    ("small", "sealed_here"), ("small", "from_arrays"),
    ("corpus", "sealed_here"), ("corpus", "from_arrays")])
def test_device_leaves_are_the_references(small, corpus, which, source):
    (_jm, j), (_tm, t) = small if which == "small" else corpus
    if source == "from_arrays":
        t = segment_from_arrays(segment_arrays(j))
    jimg, jmeta = j_upload(j)
    timg, tmeta = upload_segment(t, torch.device("cpu"))
    for kind in ("numeric", "ordinal"):
        assert sorted(timg[kind]) == sorted(jimg[kind]), kind
        for field, leaves in jimg[kind].items():
            assert sorted(timg[kind][field]) == sorted(leaves)
            for leaf, want in leaves.items():
                got = timg[kind][field][leaf].numpy()
                want = np.asarray(want)
                assert got.dtype == want.dtype \
                    and got.shape == want.shape, (kind, field, leaf)
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{field}.{leaf}")
    assert (tmeta.numeric_fields, tmeta.ordinal_fields) == \
        (jmeta.numeric_fields, jmeta.ordinal_fields)
    assert tmeta.compile_key()[4:6] == jmeta.compile_key()[4:6]


def test_structured_segment_equals_sealed_documents():
    """The vectorized scale-phase segment has exactly the columns of its
    documents sealed one by one by the reference."""
    from opensearch_tpu_torch.utils.demo import (STRUCTURED_MAPPING,
                                                 structured_columns,
                                                 structured_segment)
    _m, seg = structured_segment(1500, seed=5)
    tag, views, ts = structured_columns(1500, seed=5)
    docs = [{"tag": f"cat{a}", "views": int(b), "ts": int(c)}
            for a, b, c in zip(tag, views, ts)]
    _jm, j = _seal(JMapper, JBuilder, STRUCTURED_MAPPING, docs)
    _assert_same_columns(seg, j)
    assert seg.doc_ids == j.doc_ids and seg.num_docs == j.num_docs


def test_build_shards_index_every_demo_field():
    """build_shards seals the whole DEMO_MAPPING (body, tag, views, ts)
    from the reference's random stream, columns included."""
    from opensearch_tpu.utils import demo as jdemo
    from opensearch_tpu_torch.utils import demo as tdemo
    _tm, tsegs = tdemo.build_shards(300, 2, 500, 20, 7)
    _jm, jsegs = jdemo.build_shards(300, 2, 500, 20, 7)
    for t, j in zip(tsegs, jsegs):
        _assert_same_columns(t, j)
        assert sorted(t.numeric_dv) == ["ts", "views"]
        assert t.term_dict.keys() == j.term_dict.keys()
