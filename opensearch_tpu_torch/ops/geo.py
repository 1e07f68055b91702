"""K25 `geo_scores` (csrc/geo_scores.cu): the elementwise geo_point and
rank_feature query kinds, one C entry (and one kernel) each, for B
queries over a segment's Dp docs, each with its plain PyTorch version:

- `geo_distance_scores`: haversine metres from the query's point, a
  match within the distance (score: the boost);
- `geo_bbox_scores`: inside the box, the longitude range wrapping across
  the dateline where left > right (score: the boost);
- `distance_feature_geo_scores`: boost * pivot / (pivot + haversine);
- `rank_feature_scores`: saturation, log, sigmoid or linear of the
  feature (negative values count as 0), times the boost.

Columns are the doc's first (smallest) value through K15
(`plan_eval.dense_numeric`): a multi-valued point contributes its
smallest lat and, independently, its smallest lon, as in the reference.

The f32 constants are the reference's (opensearch_tpu/search/
plan_eval.py:_haversine_m): `rad` is pi / 180 rounded once to f32, the
metres factor is f32(6371008.7714 * 2.0), `sin(x) ** 2` is x * x of the
sine and `minimum(a, 1.0)` comes before the square root. A wrapper runs
its plain version only for tensors on the CPU; for CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from opensearch_tpu_torch.ops import _build
from opensearch_tpu_torch.ops.binned import _require

# rank_feature functions by their code
RANK_FUNCTIONS = ("saturation", "log", "sigmoid", "linear")
RAD = math.pi / 180.0
EARTH_2R = 6371008.7714 * 2.0
ENTRIES = ("geo_distance_scores", "geo_bbox_scores",
           "distance_feature_geo_scores", "rank_feature_scores")


def haversine_plain(lat: torch.Tensor, lon: torch.Tensor,
                    qlat: torch.Tensor, qlon: torch.Tensor) -> torch.Tensor:
    """Great-circle metres between docs (lat / lon f32 [Dp]) and query
    points (qlat / qlon f32 [B]), f32 [B, Dp], in the reference's order."""
    rad = torch.tensor(RAD, dtype=torch.float32)
    dlat = (qlat[:, None] - lat[None, :]) * rad
    dlon = (qlon[:, None] - lon[None, :]) * rad
    s_lat = torch.sin(dlat / 2.0)
    s_lon = torch.sin(dlon / 2.0)
    a = s_lat * s_lat + torch.cos(lat * rad)[None, :] \
        * torch.cos(qlat * rad)[:, None] * (s_lon * s_lon)
    return torch.tensor(EARTH_2R, dtype=torch.float32) \
        * torch.asin(torch.sqrt(torch.clamp(a, max=1.0)))


def geo_distance_plain(lat, lon, exists, qlat, qlon, dist, boost
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K25 geo_distance."""
    d = haversine_plain(lat, lon, qlat, qlon)
    matches = exists[None, :] & (d <= dist[:, None])
    return torch.where(matches, boost[:, None], 0.0), matches


def geo_bbox_plain(lat, lon, exists, top, left, bottom, right, boost
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K25 geo_bbox."""
    in_lat = (lat[None, :] <= top[:, None]) & (lat[None, :]
                                               >= bottom[:, None])
    ge_left = lon[None, :] >= left[:, None]
    le_right = lon[None, :] <= right[:, None]
    in_lon = torch.where((left <= right)[:, None], ge_left & le_right,
                         ge_left | le_right)
    matches = exists[None, :] & in_lat & in_lon
    return torch.where(matches, boost[:, None], 0.0), matches


def distance_feature_geo_plain(lat, lon, exists, qlat, qlon, pivot, boost
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K25 distance_feature_geo."""
    d = haversine_plain(lat, lon, qlat, qlon)
    scores = boost[:, None] * pivot[:, None] / (pivot[:, None] + d)
    matches = exists[None, :].expand(d.shape)
    return torch.where(matches, scores, 0.0), matches


def rank_feature_plain(value, exists, function: str, pivot, scaling_factor,
                       exponent, boost) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K25 rank_feature."""
    v = torch.clamp(value, min=0.0)[None, :]
    if function == "saturation":
        s = v / (v + pivot[:, None])
    elif function == "log":
        s = torch.log(scaling_factor[:, None] + v)
    elif function == "sigmoid":
        vp = torch.pow(v, exponent[:, None])
        s = vp / (vp + torch.pow(pivot, exponent)[:, None])
    else:
        s = v.expand(boost.shape[0], -1)
    matches = exists[None, :].expand(s.shape)
    return torch.where(matches, s * boost[:, None], 0.0), matches


def _launch(name: str, cols, params, bsz: int, d_pad: int, dev,
            extra_ints=()) -> Tuple[torch.Tensor, torch.Tensor]:
    """One K25 entry on its checked columns ([Dp]) and per-query
    parameters ([B])."""
    for t, dtype, what in cols:
        _require(t, dtype, (d_pad,), dev, what)
    for t, what in params:
        _require(t, torch.float32, (bsz,), dev, what)
    out_s = torch.empty(bsz, d_pad, dtype=torch.float32, device=dev)
    out_m = torch.empty(bsz, d_pad, dtype=torch.bool, device=dev)
    args = [t for t, _d, _w in cols] + [t for t, _w in params]
    fn = _build.entry(name, [ctypes.c_void_p] * len(args)
                      + [ctypes.c_int] * (2 + len(extra_ints))
                      + [ctypes.c_void_p] * 3, lib="geo_scores")
    code = fn(*[_build.ptr(t) for t in args], *extra_ints, bsz, d_pad,
              _build.ptr(out_s), _build.ptr(out_m), _build.stream_of(dev))
    _build.LAUNCHES[name] += 1
    _build.check(name, code, lib="geo_scores")
    return out_s, out_m


def _point_cols(lat, lon, exists):
    return [(lat, torch.float32, "lat"), (lon, torch.float32, "lon"),
            (exists, torch.bool, "exists")]


def geo_distance(lat, lon, exists, qlat, qlon, dist, boost
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K25 geo_distance: (scores, matches) [B, Dp] from the dense lat /
    lon f32 and exists bool [Dp] columns and per-query qlat, qlon, dist
    (metres) and boost f32 [B]. Replaces opensearch_tpu/search/
    plan_eval.py:443-449 with _haversine_m :24."""
    if not lat.is_cuda:
        return geo_distance_plain(lat, lon, exists, qlat, qlon, dist, boost)
    return _launch("geo_distance_scores", _point_cols(lat, lon, exists),
                   [(qlat, "qlat"), (qlon, "qlon"), (dist, "dist"),
                    (boost, "boost")], boost.shape[0], lat.shape[0],
                   lat.device)


def geo_bbox(lat, lon, exists, top, left, bottom, right, boost
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K25 geo_bbox: (scores, matches) [B, Dp] of per-query boxes (top,
    left, bottom, right f32 [B]). Replaces opensearch_tpu/search/
    plan_eval.py:451-462."""
    if not lat.is_cuda:
        return geo_bbox_plain(lat, lon, exists, top, left, bottom, right,
                              boost)
    return _launch("geo_bbox_scores", _point_cols(lat, lon, exists),
                   [(top, "top"), (left, "left"), (bottom, "bottom"),
                    (right, "right"), (boost, "boost")], boost.shape[0],
                   lat.shape[0], lat.device)


def distance_feature_geo(lat, lon, exists, qlat, qlon, pivot, boost
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K25 distance_feature on a geo_point: (scores, matches) [B, Dp] with
    per-query origin (qlat, qlon), pivot (metres) and boost f32 [B].
    Replaces opensearch_tpu/search/plan_eval.py:420-426."""
    if not lat.is_cuda:
        return distance_feature_geo_plain(lat, lon, exists, qlat, qlon,
                                          pivot, boost)
    return _launch("distance_feature_geo_scores",
                   _point_cols(lat, lon, exists),
                   [(qlat, "qlat"), (qlon, "qlon"), (pivot, "pivot"),
                    (boost, "boost")], boost.shape[0], lat.shape[0],
                   lat.device)


def rank_feature(value, exists, function: str, pivot, scaling_factor,
                 exponent, boost) -> Tuple[torch.Tensor, torch.Tensor]:
    """K25 rank_feature: (scores, matches) [B, Dp] of one function
    (RANK_FUNCTIONS) of the dense feature column with per-query pivot,
    scaling_factor, exponent and boost f32 [B]. Replaces
    opensearch_tpu/search/plan_eval.py:428-441."""
    if function not in RANK_FUNCTIONS:
        raise ValueError(f"rank_feature functions are {RANK_FUNCTIONS}, "
                         f"got [{function}]")
    if not value.is_cuda:
        return rank_feature_plain(value, exists, function, pivot,
                                  scaling_factor, exponent, boost)
    return _launch("rank_feature_scores",
                   [(value, torch.float32, "value"),
                    (exists, torch.bool, "exists")],
                   [(pivot, "pivot"), (scaling_factor, "scaling_factor"),
                    (exponent, "exponent"), (boost, "boost")],
                   boost.shape[0], value.shape[0], value.device,
                   extra_ints=(RANK_FUNCTIONS.index(function),))
