"""K3 (masked_topk) plain version of opensearch_tpu_torch held against
jax.lax.top_k, the reference's selection, on keys with heavy ties, -inf
lanes and k above the eligible count, and on the inputs that stress the
kernels' radix select (shared high bits, signed zeros and NaNs, one bin
holding the row): indices and totals exactly equal. The select's pass
plan (tests/topk_select_mirror.py) picks the same winners."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_tpu_torch.ops.topk import (masked_topk,
                                           masked_topk_threshold,
                                           select_buffer_room, unpack_rows)

import test_torch_common  # noqa: F401  (one intra-op thread per worker)
import topk_select_mirror as mirror

# (Dp, num_docs, k, distinct score values, eligible share)
CASES = {
    "heavy_ties": (4096, 4000, 100, 5, 0.5),
    "k_above_eligible": (2048, 2048, 300, 50, 0.05),
    "all_ineligible": (1024, 900, 10, 3, 0.0),
    "k_is_dp": (256, 200, 256, 7, 0.7),
    "k_zero": (512, 512, 0, 4, 0.5),
    "distinct": (8192, 8000, 1000, 0, 0.9),
}


def _reference(scores, matches, live, root, num_docs, min_score, k):
    d_pad = scores.shape[1]
    in_seg = jnp.arange(d_pad) < num_docs
    eligible = matches & live & root & in_seg & (scores >= min_score[:, None])
    total = jnp.sum(eligible.astype(jnp.int32), axis=1)
    masked = jnp.where(eligible, scores, -jnp.inf)
    if k == 0:
        return (np.zeros((scores.shape[0], 0), np.float32),
                np.zeros((scores.shape[0], 0), np.int32), np.asarray(total))
    top, idx = jax.lax.top_k(masked, k)
    return np.asarray(top), np.asarray(idx), np.asarray(total)


@pytest.mark.parametrize("case", sorted(CASES))
def test_masked_topk_matches_lax_top_k(case):
    d_pad, num_docs, k, distinct, share = CASES[case]
    rng = np.random.default_rng(len(case))
    bsz = 3
    if distinct:
        scores = rng.integers(0, distinct, (bsz, d_pad)).astype(np.float32)
        scores *= np.float32(0.75)
    else:
        scores = rng.standard_normal((bsz, d_pad)).astype(np.float32)
    matches = rng.random((bsz, d_pad)) < share
    live = rng.random(d_pad) < 0.9
    root = np.ones(d_pad, bool)
    root[::97] = False
    min_score = np.asarray([-np.inf, 0.5, 1.0], np.float32)
    ws, wi, wt = _reference(jnp.asarray(scores), jnp.asarray(matches),
                            jnp.asarray(live), jnp.asarray(root), num_docs,
                            jnp.asarray(min_score), k)
    got = masked_topk(torch.from_numpy(scores), torch.from_numpy(matches),
                      torch.from_numpy(live), torch.from_numpy(root),
                      num_docs, torch.from_numpy(min_score), k).numpy()
    gs, gi, gt = unpack_rows(got, k)
    np.testing.assert_array_equal(gt, wt)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gs, ws)


# Inputs that stress the radix select of the kernels (masked_topk.cu): the
# plain versions, the kernels' yardstick on the card, held against
# lax.top_k on them. (Dp, num_docs, k, kind, eligible share)
SELECT_CASES = {
    # K13's value ranks near 2^23: keys that share their top 20+ bits
    "shared_high_bits": (8192, 8000, 500, "ranks", 0.9),
    # epoch milliseconds in f32: 2^17 ms steps, long runs of equal keys
    "epoch_ms": (4096, 4096, 300, "epoch_ms", 0.8),
    # -0.0 beside +0.0, NaNs of both signs, -1e30, +-inf
    "signed_zero_nan": (2048, 2000, 700, "specials", 0.8),
    # every key equal: one bin holds the whole row (the overflow rule)
    "one_huge_bin": (8192, 8192, 1000, "equal", 1.0),
    # fewer eligible lanes than k: the -inf bin is the k-th key's
    "inf_bin": (4096, 4000, 700, "normal", 0.05),
}


def _select_values(kind, rng, shape):
    if kind == "ranks":
        return (2.0 ** 23 + rng.integers(0, 4096, shape)).astype(np.float32)
    if kind == "epoch_ms":
        return (1.7e12 + rng.integers(0, 90 * 86400_000, shape)).astype(
            np.float32)
    if kind == "specials":
        pool = np.array([np.nan, -np.nan, 0.0, -0.0, -1e30, 1e30, np.inf,
                         -np.inf, 1.5, -1.5], np.float32)
        return rng.choice(pool, shape)
    if kind == "equal":
        return np.full(shape, 3.5, np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _select_inputs(case):
    d_pad, num_docs, k, kind, share = SELECT_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    bsz = 3
    scores = _select_values(kind, rng, (bsz, d_pad))
    matches = rng.random((bsz, d_pad)) < share
    live = rng.random(d_pad) < 0.95
    root = np.ones(d_pad, bool)
    root[::97] = False
    min_score = np.full(bsz, -np.inf, np.float32)
    return scores, matches, live, root, num_docs, min_score, k


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("case", sorted(SELECT_CASES))
def test_masked_topk_select_cases_match_lax_top_k(case):
    """Indices, the scores' bits and totals equal lax.top_k's, -0.0 below
    +0.0 (the kernels' total order) included."""
    scores, matches, live, root, num_docs, min_score, k = \
        _select_inputs(case)
    ws, wi, wt = _reference(jnp.asarray(scores), jnp.asarray(matches),
                            jnp.asarray(live), jnp.asarray(root), num_docs,
                            jnp.asarray(min_score), k)
    s, m, lv, rt, ms = _torch(scores, matches, live, root, min_score)
    got = masked_topk(s, m, lv, rt, num_docs, ms, k).numpy()
    gs, gi, gt = unpack_rows(got, k)
    np.testing.assert_array_equal(gt, wt)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gs.view(np.int32), ws.view(np.int32))


def test_masked_topk_plain_orders_signed_zero_as_lax_top_k():
    """-0.0 sorts below +0.0 in lax.top_k's order; a stable sort of the
    floats takes them as ties in index order."""
    scores = np.array([[-0.0, 0.0, -0.0, 0.0, 1.0]], np.float32)
    matches = np.ones((1, 5), bool)
    ones = np.ones(5, bool)
    ms = np.full(1, -np.inf, np.float32)
    _ws, wi, _wt = _reference(jnp.asarray(scores), jnp.asarray(matches),
                              jnp.asarray(ones), jnp.asarray(ones), 5,
                              jnp.asarray(ms), 5)
    got = masked_topk(*_torch(scores, matches, ones, ones), 5,
                      torch.from_numpy(ms), 5).numpy()
    assert wi.tolist() == [[4, 1, 3, 0, 2]]
    assert unpack_rows(got, 5)[1].tolist() == wi.tolist()


@pytest.mark.parametrize("case", sorted(set(SELECT_CASES) | set(CASES)))
def test_select_mirror_picks_the_plain_winners(case):
    """The pass plan of the kernels' select (tests/topk_select_mirror.py:
    digits, bins, the candidate buffer and its overflow rule) picks
    exactly the plain version's k winners in every row, and the threshold
    entry's marks; it reads the input twice unless a bin overflowed."""
    if case in SELECT_CASES:
        scores, matches, live, root, num_docs, min_score, k = \
            _select_inputs(case)
    else:
        d_pad, num_docs, k, distinct, share = CASES[case]
        rng = np.random.default_rng(len(case))
        scores = (rng.integers(0, distinct, (3, d_pad)) * 0.75).astype(
            np.float32) if distinct else rng.standard_normal(
            (3, d_pad)).astype(np.float32)
        matches = rng.random((3, d_pad)) < share
        live = rng.random(d_pad) < 0.9
        root = np.ones(d_pad, bool)
        min_score = np.asarray([-np.inf, 0.5, 1.0], np.float32)
    d_pad = scores.shape[1]
    t = _torch(scores, matches, live, root, min_score)
    packed = masked_topk(*t[:4], num_docs, t[4], k).numpy()
    _gs, gi, _gt = unpack_rows(packed, k)
    marks = masked_topk_threshold(*t[:4], num_docs, t[4], k).numpy()
    in_seg = np.arange(d_pad) < num_docs
    room = select_buffer_room(d_pad, scores.shape[0])
    for q in range(scores.shape[0]):
        elig = matches[q] & live & root & in_seg & (scores[q] >= min_score[q])
        keys = mirror.lane_keys(scores[q], elig)
        win, reads = mirror.select(keys, k, room)
        idx = mirror.key_index(np.sort(win)[::-1])
        assert idx.tolist() == gi[q].tolist()
        win_t, _ = mirror.select(keys, k, room, threshold=True)
        marked = np.zeros(d_pad, bool)
        picked = win_t[mirror.markable(win_t)]
        marked[mirror.key_index(picked)] = True
        assert np.array_equal(marked, marks[q])
        top_bin = np.bincount((keys >> np.uint64(53)).astype(np.int64),
                              minlength=2048)
        first = 2047 - int(np.searchsorted(np.cumsum(top_bin[::-1]), k))
        if k and top_bin[first] <= room:
            assert reads == 2
        assert reads >= (2 if k else 1)
