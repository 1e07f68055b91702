"""K11 `maxsim_pq`'s schedule in numpy (ops/csrc/maxsim_pq.cu): the tests
hold it bit for bit against the plain version, so that the kernel's table
layout and order of additions are checked on the CPU too.

The query tokens are taken in groups of G (ops/maxsim.py pq_group), in
ascending t. A group's table is staged as [M, 256, G] (query token
innermost; 0 past Tq); a (doc token, sub-space) lookup reads one row of G
values, added to G running sums in m order from 0. Each query token's max
over the doc's real tokens (a non-finite max is 0) is added to the doc's
total, ascending t from 0, times qmask[t].
"""

import numpy as np


def group_table(lut_b, t0, g):
    """lut_b f32 [Tq, M, 256] -> the staged table f32 [M, 256, G]."""
    tq, m, codes = lut_b.shape
    tab = np.zeros((m, codes, g), np.float32)
    tn = min(g, tq - t0)
    tab[:, :, :tn] = np.transpose(lut_b[t0:t0 + tn], (1, 2, 0))
    return tab


def pq_scores_mirror(codes, lut, token_count, qmask, g):
    """codes u8 [Dp, T, M], lut f32 [B, Tq, M, 256], token_count i32 [Dp],
    qmask f32 [B, Tq] -> f32 [B, Dp] in the kernel's order."""
    d_pad, t_bucket, m = codes.shape
    bsz, tq = qmask.shape
    real = np.arange(t_bucket)[None, :] < np.minimum(
        token_count, t_bucket)[:, None]
    out = np.zeros((bsz, d_pad), np.float32)
    for b in range(bsz):
        total = np.zeros(d_pad, np.float32)
        for t0 in range(0, tq, g):
            tab = group_table(lut[b], t0, g)
            acc = np.zeros((d_pad, t_bucket, g), np.float32)
            for sub in range(m):                  # m order, from 0
                acc = acc + tab[sub][codes[:, :, sub]]
            best = np.where(real[:, :, None], acc, -np.inf).max(axis=1)
            best = np.where(np.isfinite(best), best, np.float32(0))
            for k in range(min(g, tq - t0)):      # ascending t
                total = total + best[:, k] * qmask[b, t0 + k]
        out[b] = total
    return out
