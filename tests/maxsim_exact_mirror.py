"""K10's schedule in numpy (opensearch_tpu_torch/ops/csrc/maxsim_exact.cu),
in f32 with one rounding per operation, as the kernel runs it.

The docs are cut into windows of DW = 32. A window's token counts,
clamped to [0, T] and rounded up to RS = 4, give each doc its slots: the
window's real tokens end to end, each doc from a multiple of RS, cut into
subtiles of ROWS = 256 slots (a doc may run on into the next subtile).
Per (subtile, query tile of NQ = 32 tokens): every slot's dots in dim
order; each row thread's max over its RS slots that hold real tokens;
per doc, the max over its row threads and the running max carried from
the subtile before; non-finite maxima to 0; the qmask-weighted sum in t
order, carried across one query's tiles. Docs with no tokens get 0.
`window_plan` lists each subtile's slots, so a test can hold that every
real token is covered once, in doc order."""

import numpy as np

DW, RS, ROWS, NQ = 32, 4, 256, 32
RTH = ROWS // RS


def window_table(count: np.ndarray, d0: int, t_bucket: int):
    """(off [DW + 1], cnt [DW]) of the window from doc d0."""
    cnt = np.zeros(DW, np.int64)
    n = min(DW, len(count) - d0)
    cnt[:n] = np.clip(count[d0:d0 + n], 0, t_bucket)
    off = np.zeros(DW + 1, np.int64)
    off[1:] = np.cumsum((cnt + RS - 1) // RS * RS)
    return off, cnt


def doc_of(off: np.ndarray, slot: int) -> int:
    """The last doc d < DW with off[d] <= slot."""
    return int(np.searchsorted(off[:DW], slot, side="right")) - 1


def window_plan(count: np.ndarray, t_bucket: int):
    """[(d0, subtile, [(slot row, doc, token) of each real token])], every
    non-empty window's subtiles in order."""
    plan = []
    for d0 in range(0, len(count), DW):
        off, cnt = window_table(count, d0, t_bucket)
        for sub in range(-(-int(off[DW]) // ROWS)):
            rows = []
            for r in range(ROWS):
                slot = sub * ROWS + r
                if slot >= off[DW]:
                    break
                d = doc_of(off, slot)
                if slot - off[d] < cnt[d]:
                    rows.append((r, d0 + d, int(slot - off[d])))
            plan.append((d0, sub, rows))
    return plan


def scores_mirror(tokens, count, query, qmask) -> np.ndarray:
    """f32 [B, Dp] scores as K10 computes them."""
    tokens = np.asarray(tokens, np.float32)
    query = np.asarray(query, np.float32)
    qmask = np.asarray(qmask, np.float32)
    d_pad, t_bucket, dims = tokens.shape
    bsz, tq, _ = query.shape
    ntt = -(-tq // NQ)
    out = np.full((bsz, d_pad), np.nan, np.float32)
    for d0 in range(0, d_pad, DW):
        off, cnt = window_table(count, d0, t_bucket)
        for j in range(min(DW, d_pad - d0)):
            if cnt[j] == 0:
                out[:, d0 + j] = 0.0
        n_slots = int(off[DW])
        carry = {}
        tot = np.zeros(DW, np.float32)
        for sub in range(-(-n_slots // ROWS)):
            s0, s1 = sub * ROWS, min(n_slots, (sub + 1) * ROWS)
            x = np.zeros((ROWS, dims), np.float32)
            real = np.zeros(ROWS, bool)
            for r in range(s1 - s0):
                d = doc_of(off, s0 + r)
                tok = s0 + r - off[d]
                if tok < cnt[d]:
                    x[r], real[r] = tokens[d0 + d, tok], True
            for qtile in range(bsz * ntt):
                b, tt = divmod(qtile, ntt)
                qs = np.zeros((NQ, dims), np.float32)
                lo_t = tt * NQ
                qs[:min(NQ, tq - lo_t)] = query[b, lo_t:lo_t + NQ]
                acc = np.zeros((ROWS, NQ), np.float32)
                for j in range(dims):
                    acc = acc + x[:, j, None] * qs[None, :, j]
                part = np.full((RTH, NQ), -np.inf, np.float32)
                for rt in range(RTH):
                    for i in range(RS):
                        if real[rt * RS + i]:
                            part[rt] = np.fmax(part[rt], acc[rt * RS + i])
                da, db = doc_of(off, s0), doc_of(off, s1 - 1)
                best = {}
                for d in range(da, db + 1):
                    lo, hi = max(off[d], s0), min(off[d + 1], s1)
                    if lo >= hi:
                        continue
                    m = carry[(sub - 1) & 1, qtile] if off[d] < s0 \
                        else np.full(NQ, -np.inf, np.float32)
                    for r in range((lo - s0) // RS, (hi - s0) // RS):
                        m = np.fmax(m, part[r])
                    if off[d + 1] > s1:
                        carry[sub & 1, qtile] = m
                    else:
                        best[d] = np.where(np.isfinite(m), m,
                                           np.float32(0.0))
                for d in range(da, db + 1):
                    if cnt[d] == 0 or off[d + 1] > s1:
                        continue
                    total = np.float32(0.0) if tt == 0 else tot[d]
                    for q in range(min(NQ, tq - lo_t)):
                        total = np.float32(
                            total + np.float32(best[d][q]
                                               * qmask[b, lo_t + q]))
                    if tt == ntt - 1:
                        out[b, d0 + d] = total
                    else:
                        tot[d] = total
    return out
