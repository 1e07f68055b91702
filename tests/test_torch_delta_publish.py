"""The delta segment publish of opensearch_tpu_torch against the reference's
(opensearch_tpu.ops.device_segment, `DELTA_PUBLISH`), on the CPU.

It mirrors tests/test_ingest_concurrent_serving.py::TestDeltaPublish for
the port (the gate off by default; off, publish_segment is upload_segment;
on, the expanded image equals it leaf by leaf for fewer bytes; a refresh
that leaves a live mask as it was sends nothing for it), and adds:
- row 16's plain version (`expand_pad_plain`) against the reference's
  `_expand_fn` on a hypothesis grid of 1-3-dim shapes, the four leaf dtypes
  and their fills, with axes left whole;
- delta images equal to `upload_segment` on segments with nested blocks,
  an exact and an IVF vector field, `rank_vectors` with PQ and a
  multi-valued numeric column;
- the bytes sent (`publish_segment`'s count and the reader's
  `upload_bytes` / `live_mask_bytes`) equal to the reference's on the same
  writes, gate on and off. The port's image has two leaves the
  reference's has not, K22's `child_start` and `child_rows`; they cross
  in full, so the port sends their bytes more.
Everything compares exactly: the publish moves bits and computes nothing.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from opensearch_tpu.index.mapper import MapperService as JMapper
from opensearch_tpu.index.shard import IndexShard as JShard
from opensearch_tpu.ops import device_segment as jdevseg
from opensearch_tpu.search import executor as jexec
from opensearch_tpu.telemetry import TELEMETRY

from opensearch_tpu_torch.index.mapper import MapperService as TMapper
from opensearch_tpu_torch.index.shard import IndexShard as TShard
from opensearch_tpu_torch.node import Node as TNode
from opensearch_tpu_torch.ops import device_segment as tdevseg

CPU = torch.device("cpu")

MAPPING = {"properties": {"title": {"type": "text"},
                          "body": {"type": "text"},
                          "n": {"type": "integer"}}}

# one mapping per segment kind the publish must carry
KIND_MAPPINGS = {
    "text": MAPPING,
    "nested": {"properties": {
        "title": {"type": "text"},
        "comments": {"type": "nested", "properties": {
            "who": {"type": "keyword"}, "stars": {"type": "integer"}}}}},
    "vectors": {"properties": {
        "tag": {"type": "keyword"},
        "vec": {"type": "knn_vector", "dimension": 8,
                "method": {"space_type": "l2"}},
        "ivec": {"type": "knn_vector", "dimension": 8,
                 "method": {"name": "ivf", "space_type": "l2",
                            "parameters": {"nlist": 4}}}}},
    "pq": {"properties": {
        "title": {"type": "text"},
        "tok": {"type": "rank_vectors", "dimension": 8, "max_tokens": 8,
                "compression": "pq"}}},
    "multi": {"properties": {
        "vals": {"type": "long"}, "tags": {"type": "keyword"},
        "score": {"type": "double"}}},
}
# the IVF seal's k-means differs between the packages (the port's runs on
# torch), so the IVF packing's size may too: bytes compare on the others
BYTE_KINDS = ("text", "nested", "pq", "multi")


def kind_docs(kind: str, n: int, seed: int = 7) -> dict:
    rng = np.random.default_rng(seed)
    docs = {}
    for i in range(n):
        if kind == "text":
            doc = {"title": f"alpha delta {i}", "body": f"gamma {i % 5}",
                   "n": i}
        elif kind == "nested":
            doc = {"title": f"post {i % 3}", "comments": [
                {"who": f"u{(i + j) % 4}", "stars": int(j + i % 3)}
                for j in range(i % 4)]}
        elif kind == "vectors":
            doc = {"tag": "even" if i % 2 == 0 else "odd",
                   "ivec": rng.standard_normal(8).round(3).tolist()}
            if i % 5:
                doc["vec"] = rng.standard_normal(8).round(3).tolist()
        elif kind == "pq":
            doc = {"title": f"doc {i % 7}", "tok": rng.standard_normal(
                (1 + i % 5, 8)).round(3).tolist()}
        else:
            doc = {"vals": [int(v) for v in rng.integers(0, 50, i % 4)],
                   "tags": [f"t{j}" for j in range(i % 3)],
                   "score": float(i) / 4}
        docs[f"d{i}"] = doc
    return docs


def _port_shard(kind: str, delta: bool = False) -> TShard:
    return TShard(0, TMapper(KIND_MAPPINGS[kind]), CPU, delta=delta)


def _ref_shard(kind: str) -> JShard:
    return JShard(0, JMapper(KIND_MAPPINGS[kind]), index_name="ref")


def _write(shard, kind: str, n: int, deletes=()):
    for did, doc in kind_docs(kind, n).items():
        shard.index_doc(did, doc)
    for did in deletes:
        shard.delete_doc(did)
    shard.refresh()


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, path + (k,)))
        return out
    return {path: tree}


def _same_image(got, want):
    a, b = _leaves(got), _leaves(want)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape, k
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), f"delta publish corrupted {k}"


# ------------------------------------------------------ the reference's four

def test_gate_off_by_default():
    assert jdevseg.DELTA_PUBLISH is False
    node = TNode(device="cpu")
    assert node.delta is False
    node.request("PUT", "/i", {"mappings": MAPPING})
    assert node.indices.get("i").shards[0].reader.delta is False
    on = TNode(device="cpu", settings={"indices.publish.delta": "true"})
    on.request("PUT", "/i", {"mappings": MAPPING})
    assert on.indices.get("i").shards[0].reader.delta is True


def test_delta_setting_rejects_a_non_boolean():
    from opensearch_tpu_torch.common.errors import SettingsError
    with pytest.raises(SettingsError):
        TNode(device="cpu", settings={"indices.publish.delta": "yes"})


def _segment(kind: str = "text", n: int = 10):
    shard = _port_shard(kind)
    _write(shard, kind, n, deletes=("d3",))      # a partial live mask
    return shard.engine.segments[0]


def test_disabled_is_exactly_upload_segment():
    seg = _segment()
    arrays, meta, sent = tdevseg.publish_segment(seg, CPU)
    ref, ref_meta = tdevseg.upload_segment(seg, CPU)
    assert meta == ref_meta
    assert sent == tdevseg.tree_nbytes(ref)
    _same_image(arrays, ref)


@pytest.mark.parametrize("kind", sorted(KIND_MAPPINGS))
def test_enabled_expands_to_identical_arrays(kind):
    """The delta path's expansion reproduces the padded image bit for bit
    (shapes, dtypes, fills, data) on every segment kind. A compact extent
    is bucketed like a padded one, from 8 instead of 128: it sends fewer
    bytes where a count is at most 64 (40 docs), and the whole image
    where every count is above (the 300-doc IVF segment)."""
    seg = _segment(kind, n=300 if kind == "vectors" else 40)
    if kind == "vectors":
        assert seg.vector_dv["ivec"].ivf is not None
    ref, _ = tdevseg.upload_segment(seg, CPU)
    arrays, _, sent = tdevseg.publish_segment(seg, CPU, delta=True)
    _same_image(arrays, ref)
    if kind == "vectors":
        assert sent == tdevseg.tree_nbytes(ref)
    else:
        assert 0 < sent < tdevseg.tree_nbytes(ref)


def test_reader_counts_compact_bytes_exactly():
    shard = _port_shard("text", delta=True)
    _write(shard, "text", 10)
    seg = shard.engine.segments[0]
    _, _, expected = tdevseg.publish_segment(seg, CPU, delta=True)
    _, _, padded = tdevseg.publish_segment(seg, CPU)
    assert shard.reader.upload_bytes == expected < padded
    assert expected < shard.reader.device_bytes()
    assert shard.reader.live_mask_bytes == 0


@pytest.mark.parametrize("delta", [False, True])
def test_unchanged_live_mask_ships_nothing_on_next_refresh(delta):
    """The live-mask skip holds with the gate on and off."""
    shard = _port_shard("text", delta=delta)
    _write(shard, "text", 12)
    live0 = shard.reader.live_mask_bytes
    shard.index_doc("extra", {"title": "alpha extra"})
    shard.refresh()
    assert shard.reader.live_mask_bytes == live0 == 0
    # a delete changes the first segment's mask: it crosses once
    shard.delete_doc("d1")
    shard.refresh()
    d_pad = shard.reader.device[0][1].d_pad
    assert shard.reader.live_mask_bytes == d_pad
    shard.refresh()
    assert shard.reader.live_mask_bytes == d_pad


# ------------------------------------------------ row 16's plain version

FILLS = {"int32": (-1, 0, int(tdevseg.INT32_MAX)), "float32": (0.0,),
         "bool": (False,), "uint8": (0,)}
TORCH_DTYPES = {"int32": torch.int32, "float32": torch.float32,
                "bool": torch.bool, "uint8": torch.uint8}


@st.composite
def expand_cases(draw):
    ndim = draw(st.integers(1, 3))
    full = tuple(draw(st.integers(1, 40)) for _ in range(ndim))
    # each axis cut or left whole
    compact = tuple(f if draw(st.booleans()) else draw(st.integers(1, f))
                    for f in full)
    dtype = draw(st.sampled_from(sorted(FILLS)))
    fill = draw(st.sampled_from(FILLS[dtype]))
    seed = draw(st.integers(0, 2 ** 16))
    return compact, full, dtype, fill, seed


@settings(max_examples=40, deadline=None)
@given(expand_cases())
def test_expand_pad_plain_equals_reference_expand_fn(case):
    compact, full, dtype, fill, seed = case
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        x = rng.standard_normal(compact).astype(np.float32)
    elif dtype == "bool":
        x = rng.random(compact) < 0.5
    else:
        x = rng.integers(0, 200, compact).astype(dtype)
    want = np.asarray(jdevseg._expand_fn(compact, full, fill, dtype)(x))
    got = tdevseg.expand_pad(torch.from_numpy(x), full, fill)
    assert got.dtype == TORCH_DTYPES[dtype]
    assert tuple(got.shape) == full
    np.testing.assert_array_equal(got.numpy(), want)


def test_expand_pad_plain_is_the_full_and_slice():
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    out = tdevseg.expand_pad_plain(x, (4, 5), -1)
    assert out.tolist() == [[0, 1, 2, -1, -1], [3, 4, 5, -1, -1],
                            [-1] * 5, [-1] * 5]


def test_compact_spec_leaves_out_the_child_csr():
    seg = _segment("nested", n=40)
    spec = tdevseg.compact_spec(seg)
    assert ("child_start",) not in spec and ("child_rows",) not in spec
    assert ("length_table",) not in spec
    image, _ = tdevseg.segment_image(seg)
    # child_start's tail is a running total, not a constant fill
    tail = image["child_start"][seg.num_docs:]
    assert tail.min() == tail.max() == int((seg.parent_ptr >= 0).sum())


# ------------------------------------- bytes against the reference's, the same writes

def _child_bytes(seg) -> int:
    image, _ = tdevseg.segment_image(seg)
    return int(image["child_start"].nbytes + image["child_rows"].nbytes)


@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("kind", BYTE_KINDS)
def test_transfer_nbytes_equal_reference(monkeypatch, kind, delta):
    jshard, tshard = _ref_shard(kind), _port_shard(kind)
    for shard in (jshard, tshard):
        _write(shard, kind, 40, deletes=("d5",))
    jseg, tseg = jshard.engine.segments[0], tshard.engine.segments[0]
    monkeypatch.setattr(jdevseg, "DELTA_PUBLISH", delta)
    _, _, jsent = jdevseg.publish_segment(jseg)
    _, _, tsent = tdevseg.publish_segment(tseg, CPU, delta=delta)
    assert tsent == jsent + _child_bytes(tseg)


def _ref_counters(monkeypatch, run):
    """(upload bytes, live-mask bytes) of the reference over run(): its
    transfer ledger's upload.corpus bytes, and the live masks that its
    refresh_live uploads."""
    live = [0]
    real = jexec.refresh_live

    def counting(arrays, seg):
        live[0] += int(arrays["live"].nbytes)
        return real(arrays, seg)
    monkeypatch.setattr(jexec, "refresh_live", counting)
    ledger = TELEMETRY.ledger
    ledger.enabled = True
    ledger.reset()
    try:
        run()
        snap = ledger.snapshot()
    finally:
        ledger.enabled = False
        ledger.reset()
    upload = snap["channels"].get("h2d", {}).get("upload.corpus",
                                                 {}).get("bytes", 0)
    return upload, live[0]


def _churn(shard, kind: str):
    """Refreshes with new segments, deletes, a no-op refresh, a merge."""
    docs = kind_docs(kind, 60)
    ids = list(docs)
    for did in ids[:20]:
        shard.index_doc(did, docs[did])
    shard.refresh()
    for did in ids[20:45]:
        shard.index_doc(did, docs[did])
    shard.delete_doc(ids[3])
    shard.refresh()
    shard.refresh()
    shard.index_doc(ids[4], docs[ids[7]])       # an update across segments
    for did in ids[45:]:
        shard.index_doc(did, docs[did])
    shard.refresh()
    shard.flush()
    shard.force_merge()


def _ref_churn(monkeypatch, kind: str, delta: bool):
    """The reference's (upload bytes, live-mask bytes) over _churn with its
    DELTA_PUBLISH set to `delta`."""
    monkeypatch.setattr(jdevseg, "DELTA_PUBLISH", delta)
    jshard = _ref_shard(kind)
    out = _ref_counters(monkeypatch, lambda: _churn(jshard, kind))
    assert len(jshard.engine.segments) == 1
    return out


@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("kind", ["text", "nested"])
def test_reader_counters_equal_reference(monkeypatch, kind, delta):
    """The port skips an unchanged live mask with the gate on and off; the
    reference skips it only with its gate on. So the live masks compare
    with the reference's gate on, and the images with its gate set as the
    port's."""
    jup, jlive = _ref_churn(monkeypatch, kind, delta)
    if not delta:
        on_live = _ref_churn(monkeypatch, kind, True)[1]
        assert on_live < jlive
        jup, jlive = jup - jlive + on_live, on_live
    tshard = _port_shard(kind, delta=delta)
    # every segment the port publishes carries the two K22 leaves in full
    children = [0]
    add = tshard.reader.add_segment

    def counting_add(seg):
        children[0] += _child_bytes(seg)
        add(seg)
    tshard.reader.add_segment = counting_add
    _churn(tshard, kind)
    assert len(tshard.engine.segments) == 1
    assert tshard.reader.live_mask_bytes == jlive > 0
    assert tshard.reader.upload_bytes == jup + children[0]


@pytest.mark.parametrize("delta", [False, True])
def test_notify_deletes_uploads_the_live_mask_alone(delta):
    """The reference's notify_deletes: one segment's live leaf uploads
    again, the segment list (and its stats) stays; an id the reader does
    not hold changes nothing."""
    shard = _port_shard("text", delta=delta)
    _write(shard, "text", 30)
    seg = shard.engine.segments[0]
    stats = shard.reader.stats_snapshot()[0]
    up, live = shard.reader.upload_bytes, shard.reader.live_mask_bytes
    seg.delete("d4")
    shard.reader.notify_deletes(seg)
    arrays, meta = shard.reader.device[0]
    assert shard.reader.live_mask_bytes - live == meta.d_pad
    assert shard.reader.upload_bytes - up == meta.d_pad
    assert torch.equal(arrays["live"], torch.from_numpy(
        tdevseg.live_mask(seg, meta.d_pad)))
    assert shard.reader.stats_snapshot()[0] is stats
    other = _segment("text", 5)
    other.seg_id = "absent"
    shard.reader.notify_deletes(other)
    assert shard.reader.live_mask_bytes - live == meta.d_pad


@pytest.mark.parametrize("delta", [False, True])
def test_update_segment_adopts_another_segment_of_the_id(delta):
    """A different segment object under a published id re-publishes its
    whole image; an id the reader lacks is added."""
    shard = _port_shard("text", delta=delta)
    _write(shard, "text", 20)
    old = shard.engine.segments[0]
    other = _segment("text", 8)
    other.seg_id = old.seg_id
    up = shard.reader.upload_bytes
    shard.reader.update_segment(other)
    assert shard.reader.segments == [other]
    want, _ = tdevseg.upload_segment(other, CPU)
    _same_image(shard.reader.device[0][0], want)
    _, _, sent = tdevseg.publish_segment(other, CPU, delta=delta)
    assert shard.reader.upload_bytes - up == sent
    new = _segment("text", 3)
    new.seg_id = "fresh"
    shard.reader.update_segment(new)
    assert [s.seg_id for s in shard.reader.segments] == [old.seg_id, "fresh"]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("kind", sorted(KIND_MAPPINGS))
def test_fold_axes_keeps_every_compacted_leaf(kind, raw):
    """Row 16's axis fold, which the CUDA wrapper applies before its
    launch: for every leaf compact_spec compacts (at the publish's bucketed
    extents, or with `raw` at the populated ones), the plain version on
    the folded extents, reshaped back, equals it on the original ones."""
    from opensearch_tpu_torch.index.segment import pad_bucket
    seg = _segment(kind)
    host, _meta = tdevseg.segment_image(seg)
    for path, (ext, fill) in tdevseg.compact_spec(seg).items():
        leaf = host
        for key in path:
            leaf = leaf[key]
        full = tuple(int(s) for s in leaf.shape)
        compact = tuple(
            f if e is None else min(max(int(e), 1) if raw else pad_bucket(
                max(int(e), 1), minimum=8), f) for e, f in zip(ext, full))
        x = torch.from_numpy(np.ascontiguousarray(
            leaf[tuple(slice(0, e) for e in compact)]))
        c, f = tdevseg.fold_axes(compact, full)
        assert 1 <= len(c) == len(f) <= len(full), path
        assert int(np.prod(c)) == x.numel() and \
            int(np.prod(f)) == int(np.prod(full)), path
        # only a whole inner axis merges outward: every folded axis but the
        # first is ragged
        assert all(ci < fi for ci, fi in zip(c[1:], f[1:])), path
        got = tdevseg.expand_pad_plain(x.reshape(c), f, fill).reshape(full)
        want = tdevseg.expand_pad_plain(x, full, fill)
        assert torch.equal(_bits(got), _bits(want)), path


@pytest.mark.parametrize("compact,full,folded", [
    # the MaxSim cell's PQ codes and the k-NN cell's vectors: one axis
    ((100000, 128, 32), (131072, 128, 32), ((409600000,), (536870912,))),
    ((1000000, 128), (1048576, 128), ((128000000,), (134217728,))),
    # postings: both axes ragged, nothing merges
    ((7, 40), (8, 128), ((7, 40), (8, 128))),
    # a whole middle axis merges with the outer one, never into a ragged
    # inner one
    ((3, 4, 5), (8, 4, 8), ((12, 5), (32, 8))),
    ((3, 4, 8), (8, 4, 8), ((96,), (256,))),
    ((3, 2, 8), (8, 4, 8), ((3, 16), (8, 32))),
    # leading extents of 1 drop; a whole leaf folds to one axis
    ((1, 5), (1, 8), ((5,), (8,))),
    ((1, 5), (4, 8), ((1, 5), (4, 8))),
    ((4, 6), (4, 6), ((24,), (24,))),
    ((9,), (16,), ((9,), (16,))),
])
def test_fold_axes_shapes(compact, full, folded):
    assert tdevseg.fold_axes(compact, full) == folded
