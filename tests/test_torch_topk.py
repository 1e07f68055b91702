"""K3 (masked_topk) plain version of opensearch_tpu_torch held against
jax.lax.top_k, the reference's selection, on keys with heavy ties, -inf
lanes and k above the eligible count: indices and totals exactly equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_tpu_torch.ops.topk import masked_topk, unpack_rows

import test_torch_common  # noqa: F401  (one intra-op thread per worker)

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
