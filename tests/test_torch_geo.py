"""geo_point and rank_feature in opensearch_tpu_torch held against
opensearch_tpu: the three geo_point wire shapes, geo_distance (with its
near-radius band), geo_bounding_box (also across the dateline),
distance_feature on a geo_point, rank_feature's four functions and its
default pivot, and the geo_bounds / geo_centroid / geohash_grid /
geotile_grid aggregations; the grid keys' vector form against the
reference's per-doc functions; the plain versions of K25 against the
reference's plan kinds on seeded inputs.

Contract: ids, order, totals and counts exactly; scores to rtol 2e-6 (the
CPU back-ends' sin / cos / asin / pow may differ by an ulp); geo_bounds
exactly; geo_centroid within centroid_tol (f32 sums of coordinates).
A geo_distance body may disagree only on its band: the docs whose f32
distance lies within 4 ulps of the radius on either side, or on opposite
sides of it. GEO_NEAR_BAND lists each body's band: the corpus's places
built on each circle, where their f32 coordinates land that close.
Near the antipode the arcsine's slope amplifies an ulp of its argument:
there the two back-ends' distances differ by up to 32 ulps, and
GEO_OVER_CONTRACT lists the distance_feature scores past RTOL."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_tpu.indices.request_cache import REQUEST_CACHE
from opensearch_tpu.node import Node as JNode
from opensearch_tpu.search import spmd as jspmd
from opensearch_tpu.search.aggs.engine import _geohash, _geotile
from opensearch_tpu.search.compile import Plan as JPlan
from opensearch_tpu.search.plan_eval import _eval_plan as j_eval_plan
from opensearch_tpu.search.plan_eval import _haversine_m

from opensearch_tpu_torch.node import Node as TNode
from opensearch_tpu_torch.ops import geo
from opensearch_tpu_torch.search.aggs.engine import grid_buckets
from opensearch_tpu_torch.search import spmd as tspmd
from opensearch_tpu_torch.search.dsl import parse_distance

from test_torch_common import (GEO_AGG_BODIES, GEO_DISTANCE, GEO_MAPPING,
                               GEO_QUERY_BODIES, assert_same_response,
                               bulk_refresh, centroid_tol, create_index,
                               geo_corpus, geo_distance_body, load_geo_index)

RTOL = 2e-6
# per geo_distance body, the docs within 4 ulps of the radius (computed by
# test_geo_distance and held here, as test_torch_knn.py lists its ties)
GEO_NEAR_BAND = {"berlin_150km": ["p600"], "paris_1200km": ["p601"],
                 "fiji_300km": ["p602"], "tokyo_95km": []}
# per query of test_geo_plain_versions_against_reference, the docs whose
# distance_feature score differs from the reference's by more than RTOL
# (all near the antipode: the distances 19,857,408 and 19,857,472 m, 32
# ulps apart, give 3.2e-6)
GEO_OVER_CONTRACT = {(-33.9, 151.2): [672]}


@pytest.fixture(scope="module")
def nodes():
    jn, tn = JNode(), TNode(device="cpu")
    for n in (jn, tn):
        load_geo_index(n)
    return jn, tn


def _pair(nodes, body, path="/geo/_search"):
    jn, tn = nodes
    want = jn.request("POST", path, body)
    got = tn.request("POST", path, body)
    assert want["_status"] == 200, want
    return got, want


def _same(nodes, body, path="/geo/_search"):
    got, want = _pair(nodes, body, path)
    assert_same_response(got, want, score_rtol=RTOL,
                         agg_sum_tol=centroid_tol(want))
    return want


def test_wire_shapes_and_errors():
    """{"lat", "lon"}, "lat,lon", [lon, lat], a list of points, and a
    malformed point (the same error in both)."""
    docs = {"a": {"location": {"lat": 10.5, "lon": 20.25}},
            "b": {"location": "10.5,20.25"},
            "c": {"location": [20.25, 10.5]},
            "d": {"location": [[20.0, 10.0], [21.0, 11.0]]},
            "e": {"location": [{"lat": 10.0, "lon": 21.0},
                               {"lat": 11.0, "lon": 20.0}]}}
    pair = JNode(), TNode(device="cpu")
    for n in pair:
        create_index(n, "shapes", GEO_MAPPING, 1)
        bulk_refresh(n, "shapes", docs)
    for body in ({"query": {"match_all": {}}},
                 {"query": {"geo_distance": {"distance": "1km", "location": {
                     "lat": 10.5, "lon": 20.25}}}},
                 {"size": 0, "aggs": {"b": {"geo_bounds": {
                     "field": "location"}}}},
                 {"query": {"exists": {"field": "location"}}}):
        _same(pair, body, "/shapes/_search")
    bad = [n.request("PUT", "/shapes/_doc/x", {"location": "nowhere"})
           for n in pair]
    assert bad[0]["_status"] == bad[1]["_status"] == 400
    assert bad[0]["error"]["type"] == bad[1]["error"]["type"]


def test_multi_valued_point_takes_each_axis_minimum():
    """The reference reads a multi-valued point's smallest lat and,
    independently, its smallest lon: doc d's points (10, 21) and (11, 20)
    are read as (10, 20), a place it does not hold. The port follows."""
    pair = JNode(), TNode(device="cpu")
    for n in pair:
        create_index(n, "multi", GEO_MAPPING, 1)
        bulk_refresh(n, "multi", {"d": {"location": [
            {"lat": 10.0, "lon": 21.0}, {"lat": 11.0, "lon": 20.0}]}})
    want = _same(pair, {"query": {"geo_distance": {
        "distance": "1m", "location": {"lat": 10.0, "lon": 20.0}}}},
        "/multi/_search")
    assert [h["_id"] for h in want["hits"]["hits"]] == ["d"]


def _dense_points(docs):
    """Each doc's (smallest lat, smallest lon) as f32, NaN without a
    point: the columns the reference's dense_numeric reads."""
    lat = np.full(len(docs), np.nan, np.float32)
    lon = np.full(len(docs), np.nan, np.float32)
    for i, d in enumerate(docs):
        loc = d.get("location")
        if loc is None:
            continue
        pts = loc if isinstance(loc, list) and loc and not isinstance(
            loc[0], (int, float)) else [loc]
        parsed = []
        for p in pts:
            if isinstance(p, dict):
                parsed.append((p["lat"], p["lon"]))
            elif isinstance(p, str):
                a, o = p.split(",")
                parsed.append((float(a), float(o)))
            else:
                parsed.append((p[1], p[0]))
        lat[i] = np.float32(min(p[0] for p in parsed))
        lon[i] = np.float32(min(p[1] for p in parsed))
    return lat, lon


@pytest.mark.parametrize("name", sorted(GEO_DISTANCE))
def test_geo_distance(nodes, name):
    """Both sides' f32 distances of every place; the docs within 4 ulps
    of the radius on either side form the body's band (GEO_NEAR_BAND);
    outside it the hits agree exactly."""
    (clat, clon), dist = GEO_DISTANCE[name]
    docs = geo_corpus()
    lat, lon = _dense_points(docs)
    has = ~np.isnan(lat)
    r = np.float32(parse_distance(dist))
    q = (np.float32(clat), np.float32(clon))
    d_port = geo.haversine_plain(
        torch.from_numpy(np.where(has, lat, 0)),
        torch.from_numpy(np.where(has, lon, 0)),
        torch.tensor([q[0]]), torch.tensor([q[1]]))[0].numpy()
    d_ref = np.asarray(_haversine_m(jnp.asarray(np.where(has, lat, 0)),
                                    jnp.asarray(np.where(has, lon, 0)),
                                    jnp.float32(q[0]), jnp.float32(q[1])))
    ulp = np.spacing(r)
    near = has & ((np.abs(d_port - r) <= 4 * ulp)
                  | (np.abs(d_ref - r) <= 4 * ulp)
                  | ((d_port <= r) != (d_ref <= r)))
    band = [f"p{i}" for i in np.nonzero(near)[0]]
    assert band == GEO_NEAR_BAND[name]
    got, want = _pair(nodes, geo_distance_body(name))
    g = {h["_id"] for h in got["hits"]["hits"]}
    w = {h["_id"] for h in want["hits"]["hits"]}
    assert (g ^ w) <= set(band)
    if g == w:
        assert_same_response(got, want)
    else:
        assert abs(got["hits"]["total"]["value"]
                   - want["hits"]["total"]["value"]) <= len(band)
    # every place off the band: the port's verdict is the exact one's
    exact = np.array([_geo_f64(a, o, clat, clon) for a, o in
                      zip(np.where(has, lat, 0), np.where(has, lon, 0))])
    off = has & ~near
    np.testing.assert_array_equal((d_port <= r)[off], (exact <= r)[off])


def _geo_f64(lat, lon, qlat, qlon):
    rad = math.pi / 180.0
    a = math.sin((qlat - lat) * rad / 2) ** 2 + math.cos(lat * rad) \
        * math.cos(qlat * rad) * math.sin((qlon - lon) * rad / 2) ** 2
    return 6371008.7714 * 2.0 * math.asin(math.sqrt(min(a, 1.0)))


@pytest.mark.parametrize("name", sorted(GEO_QUERY_BODIES))
def test_query_bodies(nodes, name):
    _same(nodes, GEO_QUERY_BODIES[name])


def test_five_shards_take_the_reference_route():
    """Geo queries and aggregations on a 5-shard index (one segment a
    shard): the same responses and the same route as the reference."""
    pair = JNode(), TNode(device="cpu")
    docs = geo_corpus()
    for n in pair:
        create_index(n, "geo5", GEO_MAPPING, 5)
        bulk_refresh(n, "geo5", {f"p{i}": d for i, d in enumerate(docs)})
    bodies = [GEO_QUERY_BODIES[k] for k in ("bbox", "distance_feature",
                                            "sigmoid")]
    bodies += [{"size": 0, "aggs": GEO_AGG_BODIES[k]}
               for k in ("by_country", "geotile")]
    routes = []
    for body in bodies:
        REQUEST_CACHE.clear()
        j0, t0 = jspmd.SPMD_QUERIES.value, tspmd.SPMD_QUERIES[0]
        _same(pair, body, "/geo5/_search")
        assert tspmd.SPMD_QUERIES[0] - t0 == jspmd.SPMD_QUERIES.value - j0
        routes.append(jspmd.SPMD_QUERIES.value - j0)
    assert routes[0] == 1


def test_errors(nodes):
    for body in ({"query": {"geo_distance": {"distance": "1km", "elev": {
                     "lat": 0, "lon": 0}}}},
                 {"query": {"geo_bounding_box": {"name": {
                     "top": 1, "left": 0, "bottom": 0, "right": 1}}}},
                 {"query": {"geo_distance": {"location": [0, 0]}}},
                 {"query": {"distance_feature": {"field": "location",
                                                 "origin": [0, 0],
                                                 "pivot": "0km"}}}):
        jn, tn = nodes
        want = jn.request("POST", "/geo/_search", body)
        got = tn.request("POST", "/geo/_search", body)
        assert got["_status"] == want["_status"] == 400, (got, want)
        assert got["error"]["type"] == want["error"]["type"]


@pytest.mark.parametrize("name", sorted(GEO_AGG_BODIES))
def test_aggregations(nodes, name):
    aggs = GEO_AGG_BODIES[name]
    _same(nodes, {"size": 0, "aggs": aggs})
    _same(nodes, {"size": 0, "query": {"range": {"elev": {"lt": 1500}}},
                  "aggs": aggs})


def test_grid_keys_equal_the_reference_functions():
    """grid_buckets' numpy forms against the reference's per-doc geohash
    and geotile functions: on the corpus and on 20,000 seeded points
    (tile edges and the poles' clamp included)."""
    rng = np.random.default_rng(11)
    lat = np.concatenate([rng.uniform(-90, 90, 20000),
                          [85.0511, -85.0511, 89.9, -89.9, 0.0, 45.0]])
    lon = np.concatenate([rng.uniform(-180, 180, 20000),
                          [180.0, -180.0, 0.0, 90.0, -90.0, 179.999]])
    cl, co = _dense_points(geo_corpus())
    has = ~np.isnan(cl)
    lat = np.concatenate([lat, cl[has].astype(np.float64)])
    lon = np.concatenate([lon, co[has].astype(np.float64)])
    exists = np.ones(len(lat), bool)
    exists[::7] = False
    for kind, fn, prec in (("geohash_grid", _geohash, 5),
                           ("geohash_grid", _geohash, 1),
                           ("geotile_grid", _geotile, 8),
                           ("geotile_grid", _geotile, 0),
                           ("geotile_grid", _geotile, 12)):
        keys, bucket = grid_buckets(kind, lat, lon, exists, prec)
        raw = [fn(a, o, prec) if e else None
               for a, o, e in zip(lat, lon, exists)]
        uniq = sorted({k for k in raw if k is not None})
        code = {k: i for i, k in enumerate(uniq)}
        assert keys == uniq
        np.testing.assert_array_equal(
            bucket, [code.get(k, -1) for k in raw])


# ------------------------------- the plain versions against the reference

def _geo_seg(rng, d_pad):
    """A reference segment dict with `loc.lat` / `loc.lon` / `feat`
    identity columns."""
    lat = rng.uniform(-89, 89, d_pad).astype(np.float32)
    lon = rng.uniform(-180, 180, d_pad).astype(np.float32)
    feat = (rng.lognormal(3, 2, d_pad) - 2).astype(np.float32)
    exists = rng.random(d_pad) < 0.9

    def col(v):
        return {"doc_ids": jnp.asarray(np.where(exists, np.arange(d_pad),
                                                -1).astype(np.int32)),
                "values_f32": jnp.asarray(v), "exists": jnp.asarray(exists)}
    seg = {"live": jnp.ones(d_pad, bool),
           "numeric": {"loc.lat": col(lat), "loc.lon": col(lon),
                       "feat": col(feat)}}
    return seg, lat, lon, feat, exists


def _ref(kind, static, seg, my):
    plan = JPlan(kind, static=static)
    inputs = [{k: jnp.asarray(np.float32(v)) for k, v in my.items()}]
    s, m = j_eval_plan(plan, seg, inputs, [0])
    return np.asarray(s), np.asarray(m)


def test_geo_plain_versions_against_reference():
    """K25's geo_distance, geo_bbox and distance_feature_geo plain versions
    against the reference's plan kinds: matches exactly off the 4-ulp
    band of the radius, scores to RTOL."""
    rng = np.random.default_rng(25)
    d_pad = 4096
    seg, lat, lon, _feat, exists = _geo_seg(rng, d_pad)
    t = {k: torch.from_numpy(v) for k, v in (("lat", lat), ("lon", lon),
                                             ("exists", exists))}
    lat0 = np.where(exists, lat, 0).astype(np.float32)
    lon0 = np.where(exists, lon, 0).astype(np.float32)
    tz = {"lat": torch.from_numpy(lat0), "lon": torch.from_numpy(lon0)}
    for qlat, qlon, dist in ((52.5, 13.4, 2.5e6), (-33.9, 151.2, 8e6),
                             (0.0, 179.9, 1.2e7)):
        my = {"lat": qlat, "lon": qlon, "dist": dist, "boost": 1.5}
        ws, wm = _ref("geo_distance", ("loc",), seg, my)
        q = [torch.tensor([np.float32(v)]) for v in (qlat, qlon, dist, 1.5)]
        gs, gm = geo.geo_distance_plain(tz["lat"], tz["lon"], t["exists"],
                                        *q)
        d = geo.haversine_plain(tz["lat"], tz["lon"], q[0], q[1])[0].numpy()
        off = np.abs(d - np.float32(dist)) > 4 * np.spacing(np.float32(dist))
        np.testing.assert_array_equal(gm[0].numpy()[off], wm[off])
        my = {"lat": qlat, "lon": qlon, "pivot": 5e4, "boost": 2.0}
        ws, wm = _ref("distance_feature_geo", ("loc",), seg, my)
        q = [torch.tensor([np.float32(v)]) for v in (qlat, qlon, 5e4, 2.0)]
        gs, gm = geo.distance_feature_geo_plain(tz["lat"], tz["lon"],
                                                t["exists"], *q)
        np.testing.assert_array_equal(gm[0].numpy(), wm)
        rel = np.abs(gs[0].numpy() - ws) / np.maximum(np.abs(ws), 1e-30)
        over = np.nonzero(rel > RTOL)[0].tolist()
        assert over == GEO_OVER_CONTRACT.get((qlat, qlon), [])
        assert np.all(rel[over] < 1e-5) and np.all(d[over] > 1.9e7)
    for box in ((60.0, -10.0, 30.0, 40.0), (70.0, 170.0, -30.0, -170.0)):
        top, left, bottom, right = box
        ws, wm = _ref("geo_bbox", ("loc",), seg, {
            "top": top, "left": left, "bottom": bottom, "right": right,
            "boost": 1.0})
        q = [torch.tensor([np.float32(v)]) for v in box + (1.0,)]
        gs, gm = geo.geo_bbox_plain(tz["lat"], tz["lon"], t["exists"], *q)
        np.testing.assert_array_equal(gm[0].numpy(), wm)
        np.testing.assert_array_equal(gs[0].numpy(), ws)


@pytest.mark.parametrize("function", geo.RANK_FUNCTIONS)
def test_rank_feature_plain_against_reference(function):
    """K25's rank_feature plain version against the reference's plan kind:
    matches exactly, scores to RTOL (negative features count as 0)."""
    rng = np.random.default_rng(26)
    seg, _lat, _lon, feat, exists = _geo_seg(rng, 4096)
    feat0 = torch.from_numpy(np.where(exists, feat, 0).astype(np.float32))
    for pivot, scale, expo in ((10.0, 1.0, 1.0), (3.5, 2.0, 0.6),
                               (200.0, 0.5, 1.7)):
        my = {"pivot": pivot, "scaling_factor": scale, "exponent": expo,
              "boost": 1.25}
        ws, wm = _ref("rank_feature", ("feat", function), seg, my)
        q = [torch.tensor([np.float32(v)]) for v in
             (pivot, scale, expo, 1.25)]
        gs, gm = geo.rank_feature_plain(feat0, torch.from_numpy(exists),
                                        function, *q)
        np.testing.assert_array_equal(gm[0].numpy(), wm)
        np.testing.assert_allclose(gs[0].numpy(), ws, rtol=RTOL, atol=0)
