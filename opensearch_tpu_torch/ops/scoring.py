"""Kernels of the scoring query kinds, each a CUDA kernel with its plain
PyTorch version beside its wrapper:

- K18 `function_score` (csrc/function_score.cu): one function_score node
  for B queries over Dp docs: each function's value (weight, a
  field_value_factor with its modifier, random_score's hash, a decay on a
  numeric or date column, a script plane), its weight and filter, the
  score_mode combine, max_boost, the boost_mode, min_score and boost;
- K19 `score_kinds` (csrc/score_kinds.cu), one entry per kind: terms_set
  (`terms_set_scores`), distance_feature on a numeric or date column
  (`distance_feature_scores`), boosting (`boosting_scores`) and
  script_score's wrap of its script plane (`script_score_wrap`).

Every plain version repeats its kernel's operations in the reference's
order (opensearch_tpu/search/plan_eval.py), one rounding each. A wrapper
runs its plain version only for tensors on the CPU; for CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from opensearch_tpu_torch.common.errors import QueryShardError
from opensearch_tpu_torch.ops import _build

KINDS = ("weight_only", "fvf", "random", "script", "decay")
MODIFIERS = ("none", "log", "log1p", "log2p", "ln", "ln1p", "ln2p",
             "square", "sqrt", "reciprocal")
SCORE_MODES = ("multiply", "sum", "avg", "max", "min", "first")
BOOST_MODES = ("multiply", "replace", "sum", "avg", "max", "min")
DECAYS = ("gauss", "exp", "linear")
# K18's per-query parameter table: boost, max_boost, min_score, then
# FN_SLOTS per function
FS_HEAD = 3
FN_SLOTS = ("weight", "factor", "missing", "origin", "scale", "offset",
            "decay")
MAX_FUNCTIONS = 16
# K19 terms_set: children a launch (a longer list chains launches)
TS_MAX = 32
# jnp.log10 is log(x) times this f32 constant
ONE_OVER_LN10 = 0.4342944819032518


@dataclass
class ScoreFunction:
    """One function of a function_score node on one segment: its kind
    (KINDS), its options and its inputs on the device. `value` / `exists`
    are the column of an fvf or decay function (None: the field has no
    values in this segment), `plane` a script's f32 [B, Dp] values,
    `filter` the function's bool [B, Dp] filter mask (None: it applies
    everywhere)."""
    kind: str
    modifier: str = "none"
    decay: str = "gauss"
    seed: int = 0
    has_weight: bool = False
    filter: Optional[torch.Tensor] = None
    value: Optional[torch.Tensor] = None
    exists: Optional[torch.Tensor] = None
    plane: Optional[torch.Tensor] = None


def modifier_code(modifier) -> int:
    name = "none" if modifier in (None, "") else modifier
    if name not in MODIFIERS:
        raise QueryShardError(f"Unknown modifier [{modifier}]")
    return MODIFIERS.index(name)


def mode_code(mode: str, modes: Sequence[str], what: str) -> int:
    if mode not in modes:
        raise QueryShardError(f"illegal {what} [{mode}]")
    return modes.index(mode)


# ----------------------------------------------------------------- K18 ------

def _f32(x, dev) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=dev)


def apply_modifier_plain(value: torch.Tensor, modifier) -> torch.Tensor:
    """field_value_factor's modifier (reference plan_eval._apply_modifier);
    log10 as jnp.log10 computes it, log(x) * f32(1 / ln 10)."""
    code = modifier_code(modifier)
    dev = value.device
    name = MODIFIERS[code]
    if name == "log":
        return torch.log(value) * _f32(ONE_OVER_LN10, dev)
    if name == "log1p":
        return torch.log(value + 1.0) * _f32(ONE_OVER_LN10, dev)
    if name == "log2p":
        return torch.log(value + 2.0) * _f32(ONE_OVER_LN10, dev)
    if name == "ln":
        return torch.log(value)
    if name == "ln1p":
        return torch.log1p(value)
    if name == "ln2p":
        return torch.log(value + 2.0)
    if name == "square":
        return value * value
    if name == "sqrt":
        return torch.sqrt(value)
    if name == "reciprocal":
        return torch.ones_like(value) / value
    return value


def _mul_u32(h: torch.Tensor, c: int) -> torch.Tensor:
    """h * c mod 2^32 for int64 h in [0, 2^32), without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & 0xFFFFFFFF


def random_values_plain(d_pad: int, seed: int, dev) -> torch.Tensor:
    """random_score's per-doc value: the uint32 hash of (ord, seed), in
    int64 masked to 32 bits, scaled into [0, 1)."""
    h = torch.arange(d_pad, dtype=torch.int64, device=dev)
    h = (_mul_u32(h, 2654435761) + (seed & 0xFFFFFFFF)) & 0xFFFFFFFF
    h = h ^ (h >> 16)
    h = _mul_u32(h, 2246822519)
    h = h ^ (h >> 13)
    return (h % (1 << 24)).to(torch.float32) / 16777216.0


def function_score_plain(child_s: torch.Tensor, child_m: torch.Tensor,
                         fns: List[ScoreFunction], params: torch.Tensor,
                         score_mode: str, boost_mode: str,
                         has_min_score: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K18 on [B, Dp] tensors: the reference's
    function_score evaluation, function by function, then the combine
    with its identities and sentinels, max_boost, the boost_mode and
    min_score (compared before the final * boost)."""
    bsz, d_pad = child_s.shape
    dev = child_s.device
    smode = SCORE_MODES[mode_code(score_mode, SCORE_MODES, "score_mode")]
    bmode = BOOST_MODES[mode_code(boost_mode, BOOST_MODES, "boost_mode")]
    zero = _f32(0.0, dev)
    ones = torch.ones(bsz, d_pad, dtype=torch.float32, device=dev)
    everywhere = torch.ones(bsz, d_pad, dtype=torch.bool, device=dev)
    values = []
    for j, fn in enumerate(fns):
        base = FS_HEAD + len(FN_SLOTS) * j
        w, factor, missing, origin, scale, offset, decay = (
            params[:, base + k, None] for k in range(len(FN_SLOTS)))
        fmask = fn.filter if fn.filter is not None else everywhere
        weigh = fn.kind != "weight_only" and fn.has_weight
        if fn.kind == "weight_only":
            value = w.expand(bsz, d_pad)
        elif fn.kind == "fvf":
            if fn.value is None:
                value = missing.expand(bsz, d_pad)
            else:
                value = torch.where(fn.exists[None, :], fn.value[None, :],
                                    missing)
            value = apply_modifier_plain(value * factor, fn.modifier)
        elif fn.kind == "random":
            value = random_values_plain(d_pad, fn.seed, dev)[None, :] \
                .expand(bsz, d_pad)
        elif fn.kind == "script":
            value = fn.plane
        elif fn.kind == "decay":
            if fn.value is None:    # no values in this segment: no decay
                values.append((ones, fmask))
                continue
            dist = torch.maximum(torch.abs(fn.value[None, :] - origin)
                                 - offset, zero)
            if fn.decay == "gauss":
                sigma2 = (-(scale * scale)) / (2.0 * torch.log(decay))
                value = torch.exp((-(dist * dist)) / (2.0 * sigma2))
            elif fn.decay == "exp":
                lam = torch.log(decay) / scale
                value = torch.exp(lam * dist)
            else:
                s = scale / (1.0 - decay)
                value = torch.maximum((s - dist) / s, zero)
            value = torch.where(fn.exists[None, :], value, 1.0)
        else:
            raise QueryShardError(f"unknown score function [{fn.kind}]")
        if weigh:
            value = value * w
        values.append((value, fmask))

    if values:
        ident = 1.0 if smode == "multiply" else 0.0
        any_m = torch.zeros(bsz, d_pad, dtype=torch.bool, device=dev)
        for _, m in values:
            any_m = any_m | m
        stacked = [torch.where(m & ~torch.isnan(v), v, ident)
                   for v, m in values]
        if smode == "multiply":
            combined = ones
            for a in stacked:
                combined = combined * a
        elif smode in ("sum", "avg"):
            combined = torch.zeros_like(ones)
            for a in stacked:
                combined = combined + a
            if smode == "avg":
                count = torch.zeros_like(ones)
                for _, m in values:
                    count = count + m.to(torch.float32)
                combined = combined / torch.maximum(count, _f32(1.0, dev))
        elif smode in ("max", "min"):
            pick = torch.maximum if smode == "max" else torch.minimum
            fill = float("-inf") if smode == "max" else float("inf")
            combined = torch.full_like(ones, fill)
            for v, m in values:
                combined = pick(combined, torch.where(m, v, fill))
            combined = torch.where(any_m, combined, 1.0)
        else:   # first: the lowest function that applies
            combined = torch.full_like(ones, float("nan"))
            for v, m in reversed(values):
                combined = torch.where(m, v, combined)
            combined = torch.where(torch.isnan(combined), 1.0, combined)
        combined = torch.where(any_m, combined, 1.0)
        combined = torch.minimum(combined, params[:, 1, None])
    else:
        combined = ones

    if bmode == "multiply":
        scores = child_s * combined
    elif bmode == "replace":
        scores = combined
    elif bmode == "sum":
        scores = child_s + combined
    elif bmode == "avg":
        scores = (child_s + combined) / 2.0
    elif bmode == "max":
        scores = torch.maximum(child_s, combined)
    else:
        scores = torch.minimum(child_s, combined)
    matches = child_m
    if has_min_score:
        matches = matches & (scores >= params[:, 2, None])
    return torch.where(matches, scores * params[:, 0, None], 0.0), matches


class _Fn(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int), ("modifier", ctypes.c_int),
                ("decay", ctypes.c_int), ("has_weight", ctypes.c_int),
                ("has_column", ctypes.c_int), ("seed", ctypes.c_uint),
                ("filter", ctypes.c_void_p), ("value", ctypes.c_void_p),
                ("exists", ctypes.c_void_p), ("plane", ctypes.c_void_p)]


class _Desc(ctypes.Structure):
    _fields_ = [("n_fn", ctypes.c_int), ("score_mode", ctypes.c_int),
                ("boost_mode", ctypes.c_int),
                ("has_min_score", ctypes.c_int),
                ("fn", _Fn * MAX_FUNCTIONS)]


def _contig(t: Optional[torch.Tensor], dtype, shape, dev,
            what: str) -> Optional[torch.Tensor]:
    """A plane or column in the kernel's layout: broadcast to `shape` and
    made contiguous (a copy only where it is not already)."""
    if t is None:
        return None
    if t.dtype != dtype or t.device != dev:
        raise ValueError(f"[{what}] must be a {dtype} tensor on {dev}, got "
                         f"{t.dtype} on {t.device}")
    return t.expand(shape).contiguous()


def function_score(child_s: torch.Tensor, child_m: torch.Tensor,
                   fns: List[ScoreFunction], params: torch.Tensor,
                   score_mode: str, boost_mode: str, has_min_score: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K18: (scores f32 [B, Dp], matches bool [B, Dp]) of one
    function_score node from its child's scores and matches, the
    functions (at most MAX_FUNCTIONS) and the per-query parameter table
    `params` f32 [B, P] (boost, max_boost, min_score, then FN_SLOTS per
    function). Replaces opensearch_tpu/search/plan_eval.py:261-390."""
    if not child_s.is_cuda:
        return function_score_plain(child_s, child_m, fns, params,
                                    score_mode, boost_mode, has_min_score)
    dev = child_s.device
    bsz, d_pad = child_s.shape
    if len(fns) > MAX_FUNCTIONS:
        raise ValueError(f"function_score takes at most {MAX_FUNCTIONS} "
                         f"functions a launch, got {len(fns)}")
    if any((fn.kind == "script" and fn.plane is None)
           or (fn.value is not None and fn.exists is None) for fn in fns):
        raise ValueError("a script function needs its plane, and a column "
                         "its exists mask")
    n_p = FS_HEAD + len(FN_SLOTS) * len(fns)
    child_s = _contig(child_s, torch.float32, (bsz, d_pad), dev, "child_s")
    child_m = _contig(child_m, torch.bool, (bsz, d_pad), dev, "child_m")
    params = _contig(params, torch.float32, (bsz, n_p), dev, "params")
    desc = _Desc(n_fn=len(fns),
                 score_mode=mode_code(score_mode, SCORE_MODES, "score_mode"),
                 boost_mode=mode_code(boost_mode, BOOST_MODES, "boost_mode"),
                 has_min_score=int(bool(has_min_score)))
    keep = []
    for j, fn in enumerate(fns):
        f = desc.fn[j]
        f.kind = KINDS.index(fn.kind)
        f.modifier = modifier_code(fn.modifier) if fn.kind == "fvf" else 0
        f.decay = DECAYS.index(fn.decay) if fn.kind == "decay" else 0
        f.has_weight = int(bool(fn.has_weight))
        f.seed = fn.seed & 0xFFFFFFFF
        f.has_column = int(fn.value is not None)
        for name, t, dtype, shape in (
                ("filter", fn.filter, torch.bool, (bsz, d_pad)),
                ("value", fn.value, torch.float32, (d_pad,)),
                ("exists", fn.exists, torch.bool, (d_pad,)),
                ("plane", fn.plane, torch.float32, (bsz, d_pad))):
            t = _contig(t, dtype, shape, dev, f"functions[{j}].{name}")
            if t is not None:
                keep.append(t)
                setattr(f, name, t.data_ptr())
    out_s = torch.empty(bsz, d_pad, dtype=torch.float32, device=dev)
    out_m = torch.empty(bsz, d_pad, dtype=torch.bool, device=dev)
    fn_entry = _build.entry(
        "function_score", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [_Desc] + [ctypes.c_void_p] * 3)
    code = fn_entry(_build.ptr(child_s), _build.ptr(child_m),
                    _build.ptr(params), bsz, n_p, d_pad, desc,
                    _build.ptr(out_s), _build.ptr(out_m),
                    _build.stream_of(dev))
    _build.LAUNCHES["function_score"] += 1
    _build.check("function_score", code)
    return out_s, out_m


# ----------------------------------------------------------------- K19 ------

def terms_set_plain(children: List[Tuple[torch.Tensor, torch.Tensor]],
                    msm_value: Optional[torch.Tensor],
                    msm_exists: Optional[torch.Tensor],
                    msm_param: Optional[torch.Tensor], boost: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K19's terms_set: hits and the score sum in child
    order; the minimum from the column (docs without it never match; a
    doc may need more matches than the query has terms) or from the
    per-query parameter, at least 1."""
    s0 = children[0][0]
    hits = torch.zeros(s0.shape, dtype=torch.int32, device=s0.device)
    scores = torch.zeros(s0.shape, dtype=torch.float32, device=s0.device)
    for s, m in children:
        hits = hits + m.to(torch.int32)
        scores = scores + s
    one = torch.ones((), dtype=torch.int32, device=s0.device)
    if msm_value is not None:
        msm = msm_value.to(torch.int32)
        matches = msm_exists[None, :] & (hits >= torch.maximum(msm, one))
    else:
        matches = hits >= torch.maximum(msm_param, one)[:, None]
    return torch.where(matches, scores * boost[:, None], 0.0), matches


class _Children(ctypes.Structure):
    _fields_ = [("scores", ctypes.c_void_p * TS_MAX),
                ("matches", ctypes.c_void_p * TS_MAX)]


def terms_set(children: List[Tuple[torch.Tensor, torch.Tensor]],
              msm_value: Optional[torch.Tensor],
              msm_exists: Optional[torch.Tensor],
              msm_param: Optional[torch.Tensor], boost: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K19 terms_set: (scores, matches) [B, Dp] of a terms_set from its
    term clauses' (scores, matches) [B, Dp], the minimum column
    `msm_value` f32 / `msm_exists` bool [Dp] or the per-query minimum
    `msm_param` int32 [B], and boost f32 [B]; TS_MAX children a launch.
    Replaces opensearch_tpu/search/plan_eval.py:392-411."""
    s0 = children[0][0]
    if not s0.is_cuda:
        return terms_set_plain(children, msm_value, msm_exists, msm_param,
                               boost)
    dev = s0.device
    bsz, d_pad = s0.shape
    planes = [(_contig(s, torch.float32, (bsz, d_pad), dev, "scores"),
               _contig(m, torch.bool, (bsz, d_pad), dev, "matches"))
              for s, m in children]
    boost = _contig(boost, torch.float32, (bsz,), dev, "boost")
    if msm_value is not None:
        msm_value = _contig(msm_value, torch.float32, (d_pad,), dev,
                            "msm_value")
        msm_exists = _contig(msm_exists, torch.bool, (d_pad,), dev,
                             "msm_exists")
    else:
        msm_param = _contig(msm_param, torch.int32, (bsz,), dev,
                            "msm_param")
    out_s = torch.empty(bsz, d_pad, dtype=torch.float32, device=dev)
    out_m = torch.empty(bsz, d_pad, dtype=torch.bool, device=dev)
    hits = torch.empty(bsz, d_pad, dtype=torch.int32, device=dev) \
        if len(planes) > TS_MAX else out_s
    fn_entry = _build.entry(
        "terms_set_scores", [_Children] + [ctypes.c_int] * 3
        + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
        + [ctypes.c_void_p] * 4, lib="score_kinds")
    for lo in range(0, len(planes), TS_MAX):
        part = planes[lo:lo + TS_MAX]
        ch = _Children()
        for j, (s, m) in enumerate(part):
            ch.scores[j] = s.data_ptr()
            ch.matches[j] = m.data_ptr()
        code = fn_entry(
            ch, len(part), int(lo == 0), int(lo + TS_MAX >= len(planes)),
            None if msm_value is None else _build.ptr(msm_value),
            None if msm_exists is None else _build.ptr(msm_exists),
            None if msm_param is None else _build.ptr(msm_param),
            _build.ptr(boost), bsz, d_pad, _build.ptr(out_s),
            _build.ptr(hits), _build.ptr(out_m), _build.stream_of(dev))
        _build.LAUNCHES["terms_set_scores"] += 1
        _build.check("terms_set_scores", code, lib="score_kinds")
    return out_s, out_m


def distance_feature_plain(value: torch.Tensor, exists: torch.Tensor,
                           origin: torch.Tensor, pivot: torch.Tensor,
                           boost: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K19's distance_feature: boost * pivot / (pivot +
    |v - origin|) in that order, where the doc has the field."""
    bsz, d_pad = boost.shape[0], value.shape[0]
    dist = torch.abs(value[None, :] - origin[:, None])
    scores = boost[:, None] * pivot[:, None] / (pivot[:, None] + dist)
    matches = exists[None, :].expand(bsz, d_pad)
    return torch.where(matches, scores, 0.0), matches


def _score_kind(name: str, args, bsz: int, d_pad: int, dev
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch one of K19's elementwise entries on its checked inputs:
    (scores f32 [B, Dp], matches bool [B, Dp])."""
    out_s = torch.empty(bsz, d_pad, dtype=torch.float32, device=dev)
    out_m = torch.empty(bsz, d_pad, dtype=torch.bool, device=dev)
    fn_entry = _build.entry(name, [ctypes.c_void_p] * len(args)
                            + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3,
                            lib="score_kinds")
    code = fn_entry(*[_build.ptr(t) for t in args], bsz, d_pad,
                    _build.ptr(out_s), _build.ptr(out_m),
                    _build.stream_of(dev))
    _build.LAUNCHES[name] += 1
    _build.check(name, code, lib="score_kinds")
    return out_s, out_m


def distance_feature(value: torch.Tensor, exists: torch.Tensor,
                     origin: torch.Tensor, pivot: torch.Tensor,
                     boost: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K19 distance_feature: (scores, matches) [B, Dp] from a column
    `value` f32 / `exists` bool [Dp] and per-query origin, pivot and
    boost f32 [B] (dates in f32 epoch millis). Replaces
    opensearch_tpu/search/plan_eval.py:413-418."""
    if not value.is_cuda:
        return distance_feature_plain(value, exists, origin, pivot, boost)
    dev = value.device
    bsz, d_pad = boost.shape[0], value.shape[0]
    args = [_contig(value, torch.float32, (d_pad,), dev, "value"),
            _contig(exists, torch.bool, (d_pad,), dev, "exists")] + [
        _contig(t, torch.float32, (bsz,), dev, what)
        for t, what in ((origin, "origin"), (pivot, "pivot"),
                        (boost, "boost"))]
    return _score_kind("distance_feature_scores", args, bsz, d_pad, dev)


def boosting_plain(pos_s: torch.Tensor, pos_m: torch.Tensor,
                   neg_m: torch.Tensor, nb: torch.Tensor,
                   boost: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K19's boosting."""
    scores = pos_s * torch.where(neg_m, nb[:, None], 1.0)
    return torch.where(pos_m, scores * boost[:, None], 0.0), pos_m


def boosting(pos_s: torch.Tensor, pos_m: torch.Tensor, neg_m: torch.Tensor,
             nb: torch.Tensor, boost: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K19 boosting: the positive clause's scores [B, Dp] times
    negative_boost `nb` [B] where the negative clause matches, times
    boost [B], where the positive clause matches. Replaces
    opensearch_tpu/search/plan_eval.py:463-467."""
    if not pos_s.is_cuda:
        return boosting_plain(pos_s, pos_m, neg_m, nb, boost)
    dev = pos_s.device
    bsz, d_pad = pos_s.shape
    args = [_contig(pos_s, torch.float32, (bsz, d_pad), dev, "pos_s"),
            _contig(pos_m, torch.bool, (bsz, d_pad), dev, "pos_m"),
            _contig(neg_m, torch.bool, (bsz, d_pad), dev, "neg_m"),
            _contig(nb, torch.float32, (bsz,), dev, "nb"),
            _contig(boost, torch.float32, (bsz,), dev, "boost")]
    return _score_kind("boosting_scores", args, bsz, d_pad, dev)


def script_score_wrap_plain(child_m: torch.Tensor, value: torch.Tensor,
                            boost: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K19's script_score wrap."""
    return torch.where(child_m, value * boost[:, None], 0.0), child_m


def script_score_wrap(child_m: torch.Tensor, value: torch.Tensor,
                      boost: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K19 script_score: where(child matches, the script's value (f32,
    broadcast to [B, Dp]) * boost [B], 0). Replaces
    opensearch_tpu/search/plan_eval.py:246-259 (the wrap; the script is
    torch ops, script/painless.py)."""
    if not child_m.is_cuda:
        return script_score_wrap_plain(child_m, value, boost)
    dev = child_m.device
    bsz, d_pad = child_m.shape
    args = [_contig(child_m, torch.bool, (bsz, d_pad), dev, "child_m"),
            _contig(value, torch.float32, (bsz, d_pad), dev, "value"),
            _contig(boost, torch.float32, (bsz,), dev, "boost")]
    return _score_kind("script_score_wrap", args, bsz, d_pad, dev)
