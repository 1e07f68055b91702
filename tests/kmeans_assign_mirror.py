"""K9's assignment schedule in numpy (opensearch_tpu_torch/ops/csrc/
kmeans_step.cu: assign_kernel and combine_lanes), given the distances.

A half-warp holds one group of RP = 4 points against CB = 256 centroids a
block: lane cg owns centroids 4 cg + 64 h + e (h, e < 4) of every block,
and its slot i holds point (cg + i) & 3 of the group. Each lane scans its
centroids in ascending order with a strict <, from "none" (+inf,
INT_MAX); the lanes then combine by the lexicographic minimum of (d, c)
over xor 4 and 8 (lanes of one rotation), un-rotate, and combine over
xor 1 and 2. `scan_assign` is the rule the kernel must meet: the ascending
scan over all centroids with a strict <, so a NaN or +inf distance is
never taken and a point with none finite gets centroid 0."""

import numpy as np

RP, CG, CB = 4, 16, 256
NONE = np.iinfo(np.int32).max


def scan_assign(dist: np.ndarray) -> np.ndarray:
    """The ascending scan with a strict < over each row of f32 [n, nlist]."""
    out = np.zeros(dist.shape[0], np.int64)
    for p, row in enumerate(dist):
        best = np.float32(np.inf)
        for c, d in enumerate(row):
            if d < best:
                best, out[p] = d, c
    return out


def _take_min(bd, bc, od, oc):
    """Element-wise: (od, oc) where it beats (bd, bc) lexicographically."""
    win = (od < bd) | ((od == bd) & (oc < bc))
    return np.where(win, od, bd), np.where(win, oc, bc)


def _xor_combine(bd, bc, o):
    """Every lane against its partner lane ^ o (lanes on axis 0)."""
    partner = np.arange(CG) ^ o
    return _take_min(bd, bc, bd[partner], bc[partner])


def lanes_assign(dist: np.ndarray) -> np.ndarray:
    """The kernel's per-lane scans and shuffle combine over f32
    [n, nlist] distances -> the centroid of each point."""
    n, nlist = dist.shape
    nblk = -(-nlist // CB)
    out = np.zeros(n, np.int64)
    cg = np.arange(CG)
    for p0 in range(0, n, RP):
        bd = np.full((CG, RP), np.inf, np.float32)
        bc = np.full((CG, RP), NONE, np.int64)
        for lane in range(CG):
            for i in range(RP):
                point = p0 + ((lane + i) & 3)
                if point >= n:
                    continue
                for blk in range(nblk):
                    for h in range(4):
                        for e in range(4):
                            c = blk * CB + 4 * lane + 64 * h + e
                            if c < nlist and dist[point, c] < bd[lane, i]:
                                bd[lane, i] = dist[point, c]
                                bc[lane, i] = c
        for o in (4, 8):
            bd, bc = _xor_combine(bd, bc, o)
        slot = (np.arange(RP)[None, :] - cg[:, None]) & 3
        ud = np.take_along_axis(bd, slot, axis=1)
        uc = np.take_along_axis(bc, slot, axis=1)
        for o in (1, 2):
            ud, uc = _xor_combine(ud, uc, o)
        for q in range(min(RP, n - p0)):
            c = uc[q, q]            # lane q writes point q
            out[p0 + q] = 0 if c == NONE else c
    return out
