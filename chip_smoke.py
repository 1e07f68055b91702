#!/usr/bin/env python3
"""Smoke test of opensearch_tpu_torch on one NVIDIA GPU.

Run from the repository root, with no arguments, on a machine with one CUDA
card:  python3 chip_smoke.py

Phases, each printing what it finds; any failure exits nonzero:
 1. build the CUDA kernels from opensearch_tpu_torch/ops/csrc (in
    parallel), print the build times and the card's name and power limit;
    make the 1M-passage corpus of the scale phase (set-up);
 2. run every kernel (K1 bm25_candidate, K2 score_text_clause, K3
    masked_topk) on the card at the main path's shapes (Dp = 2^20) and hold
    it against its plain PyTorch version on the same inputs: ids, hits and
    totals exactly, scores within SCORE_ATOL (both sides round every BM25
    operation once: the kernels build with --fmad=false); time the kernel
    (device time, CUDA-graph replay), one wrapper call (host checks and
    launch included), the plain version and the library call (CUDA events,
    median, L2 flushed);
 3. serve BM25 on the card through Node().request: a 5,000-passage index
    in two segments, the parity bodies through `_search` and a B=32
    `_msearch`; every page must equal Node(device="cpu")'s (the plain
    versions), and each kernel must have launched during this run;
 4. scale: one shard of 1,000,000 passages from build_shards_fast served
    through SearchExecutor at B=1 and B=32, sample pages checked against
    the plain versions, image bytes and p50/p99 wall times printed.

`--out DIR` writes the long outputs (nvcc's ptxas report, the profiler's
per-kernel table) under DIR. The card's name and power limit are printed in
phase 1 and again on the
third line from the end; the line before the last is the `kernels` JSON; the
last line is the result: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SCORE_ATOL = 0.0          # kernels and plain versions round identically
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12          # H100 SXM f32, outside the tensor cores
SCALE_DOCS = 1_000_000
SCALE_MATERIALIZE_TERMS = 4096


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 15, warmup: int = 3) -> float:
    """Median milliseconds of one call of fn() on the stream, between CUDA
    events, L2 flushed before each rep. A call whose host work outlasts its
    device work (a wrapper's checks and launch, a plain version's syncs)
    is measured with that host time included."""
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(torch, fn, reps: int = 15) -> float:
    """Median device milliseconds of the kernels fn() launches: fn is
    captured once into a CUDA graph and the graph is replayed between CUDA
    events, L2 flushed before each rep, so no host time is counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(torch, graph.replay, reps=reps, warmup=2)


def max_abs_err(np, got, want) -> float:
    both = np.isfinite(got) & np.isfinite(want)
    if not np.array_equal(np.isfinite(got), np.isfinite(want)):
        raise AssertionError("kernel and plain version disagree on which "
                             "slots are -inf")
    return float(np.max(np.abs(got[both] - want[both]), initial=0.0))


def check_rows(np, got, want, k: int, what: str) -> float:
    from opensearch_tpu_torch.ops.topk import unpack_rows
    gs, gi, gt = unpack_rows(got, k)
    ws, wi, wt = unpack_rows(want, k)
    if not np.array_equal(gt, wt):
        raise AssertionError(f"{what}: totals differ")
    if not np.array_equal(gi, wi):
        bad = np.argwhere(gi != wi)[:5].tolist()
        raise AssertionError(f"{what}: ids differ at {bad}")
    err = max_abs_err(np, gs, ws)
    if err > SCORE_ATOL:
        raise AssertionError(f"{what}: scores differ by {err}")
    return err


def stacked_inputs(torch, plans, min_scores, device):
    """The executor's envelope for a batch of plans: packed, uploaded once,
    unpacked into views."""
    import numpy as np
    from opensearch_tpu_torch.search.executor import (
        pack_leaves, stack_flat_inputs, unflatten_inputs, unpack_leaves)
    stacked, treedef = stack_flat_inputs([p.flatten_inputs([])
                                          for p in plans])
    stacked.append(np.asarray(min_scores, np.float32))
    buf, layout = pack_leaves(stacked, pin=device.type == "cuda")
    leaves = unpack_leaves(buf.to(device), layout)
    return unflatten_inputs(treedef, leaves[:-1]), leaves[-1]


def pick_terms(seg, n_terms: int, rows: int, max_blocks: int = 128):
    """Per row, n_terms distinct terms whose blocks sum to at most
    max_blocks lanes' worth, taking the largest such terms first."""
    per = max_blocks // n_terms
    pool = sorted(((tm.num_blocks, t) for (f, t), tm in seg.term_dict.items()
                   if tm.num_blocks <= per), reverse=True)
    out = []
    for r in range(rows):
        start = (r * n_terms) % max(len(pool) - n_terms, 1)
        out.append(" ".join(t for _, t in pool[start:start + n_terms]))
    return out


def phase_kernels(torch, np, seg, mapper, arrays, meta, dev):
    """K1-K3 against their plain versions at the main path's shapes."""
    from opensearch_tpu_torch.ops import bm25, topk
    from opensearch_tpu_torch.search import dsl
    from opensearch_tpu_torch.search.compile import Compiler, ShardStats
    from opensearch_tpu_torch.search.plan_eval import _eval_plan
    from opensearch_tpu_torch.utils.demo import fast_query_terms

    compiler = Compiler(mapper, ShardStats([seg]))

    def plans_for(texts):
        return [compiler.compile(dsl.parse_query(
            {"match": {"body": t}}), seg, meta) for t in texts]

    d_pad = meta.d_pad
    results = {}
    n_posting_blocks = lambda blk: int((blk["ids"] >= 0).sum().item())

    # K1 at B in {1, 32}, n_terms in {1, 4, 16}, up to 16,384 lanes; then
    # B=32 of the scale cell's own 3-term queries (fewer lanes)
    terms = sorted(t for _, t in seg.term_dict)
    cell = [p for p in plans_for(fast_query_terms(64, terms, seed=600,
                                                  terms_per_query=3))
            if p.inputs["ids"].shape[0] * 128 <= bm25.CANDIDATE_MAX_LANES
            and p.static[1] == 3][:32]
    for rows, n_terms in ((1, 1), (1, 4), (1, 16), (32, 1), (32, 4),
                          (32, 16), (32, 3)):
        if n_terms == 3:
            plans = cell
        else:
            plans = plans_for(pick_terms(seg, n_terms, rows))
            if any(p.static[1] != n_terms for p in plans):
                raise AssertionError("term pick produced duplicate terms")
        bsz = len(plans)
        nodes, ms = stacked_inputs(torch, plans, [-np.inf] * bsz, dev)
        blk = nodes[0]
        qb = blk["ids"].shape[1]
        k = 100

        def kern():
            return bm25.bm25_candidate(arrays, blk, n_terms, False, k, ms)

        def plain():
            return bm25.bm25_candidate_plain(arrays, blk, n_terms, False,
                                             k, ms)
        err = check_rows(np, kern().cpu().numpy(), plain().cpu().numpy(),
                         k, f"K1 B={bsz} terms={n_terms}")
        blocks = n_posting_blocks(blk)
        # doc, tf and norm per posting, live and root per doc
        nbytes = (blocks * 128 * (4 + 4 + 4 + 2)
                  + bsz * qb * 8 + bsz * (2 * k + 1) * 4)
        flops = blocks * 128 * 10
        rec = {"shape": f"B={bsz} QB={qb} lanes={qb * 128} "
                        f"terms={n_terms} k={k}",
               "max_abs_err": err, "ms": graph_ms(torch, kern),
               "call_ms": cuda_ms(torch, kern),
               "plain_ms": cuda_ms(torch, plain, reps=5),
               "library_ms": None,
               "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                               flops / F32_FLOPS) * 1e3,
               "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
               >= flops / F32_FLOPS else "operations"}
        results.setdefault("bm25_candidate", []).append(rec)
        log("K1", json.dumps(rec))

    # K2 and K3 at Dp = 2^20 on dense-path queries (20 terms)
    for bsz in (1, 32):
        texts = fast_query_terms(bsz, sorted(t for _, t in seg.term_dict),
                                 seed=90 + bsz, terms_per_query=20)
        plans = plans_for(texts)
        nodes, ms = stacked_inputs(torch, plans, [-np.inf] * bsz, dev)
        blk = nodes[0]

        def kern2():
            return bm25.score_text_clause(arrays, blk)

        def plain2():
            return bm25.score_text_clause_plain(arrays, blk)
        (ks, kh), (ps, ph) = kern2(), plain2()
        if not torch.equal(kh, ph):
            raise AssertionError(f"K2 B={bsz}: hits differ")
        err = float((ks - ps).abs().max().item())
        if err > SCORE_ATOL:
            raise AssertionError(f"K2 B={bsz}: scores differ by {err}")
        blocks = n_posting_blocks(blk)
        qb = blk["ids"].shape[1]
        nbytes = blocks * 128 * 12 + bsz * qb * 8 + bsz * d_pad * 8
        flops = blocks * 128 * 10
        rec = {"shape": f"B={bsz} QB={qb} Dp={d_pad} blocks={blocks}",
               "max_abs_err": err, "ms": graph_ms(torch, kern2),
               "call_ms": cuda_ms(torch, kern2),
               "plain_ms": cuda_ms(torch, plain2, reps=5),
               "library_ms": None,
               "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                               flops / F32_FLOPS) * 1e3,
               "bound_by": "bytes"}
        results.setdefault("score_text_clause", []).append(rec)
        log("K2", json.dumps(rec))

        scores, matches = _eval_plan(plans[0], arrays, [blk], [0], bsz)
        for k in (10, 100, 1000):
            def kern3():
                return topk.masked_topk(scores, matches, arrays["live"],
                                        arrays["root"], meta.num_docs, ms, k)

            def plain3():
                return topk.masked_topk_plain(scores, matches, arrays["live"],
                                              arrays["root"], meta.num_docs,
                                              ms, k)
            err = check_rows(np, kern3().cpu().numpy(),
                             plain3().cpu().numpy(), k, f"K3 B={bsz} k={k}")
            masked = torch.where(matches, scores, float("-inf"))

            def library():
                return torch.topk(masked, k, dim=1)
            nbytes = bsz * d_pad * 5 + d_pad * 2 + bsz * (2 * k + 1) * 4
            rec = {"shape": f"B={bsz} Dp={d_pad} k={k}",
                   "max_abs_err": err, "ms": graph_ms(torch, kern3),
                   "call_ms": cuda_ms(torch, kern3),
                   "plain_ms": cuda_ms(torch, plain3, reps=5),
                   "library_ms": graph_ms(torch, library),
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "bound_by": "bytes"}
            results.setdefault("masked_topk", []).append(rec)
            log("K3", json.dumps(rec))
    return results


def phase_serving(torch, np):
    """Node() on the card against Node(device='cpu') on the same data."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_common as parity
    from opensearch_tpu_torch.node import Node
    from opensearch_tpu_torch.ops import _build

    gpu, cpu = Node(), Node(device="cpu")
    if gpu.device.type != "cuda":
        raise AssertionError(f"Node() resolved to {gpu.device}")
    for node in (gpu, cpu):
        parity.load_index(node, "passages", n_docs=5000)
    payload = parity.msearch_ndjson("passages", parity.msearch_bodies(32))
    names = sorted(parity.SEARCH_BODIES)
    _build.reset_launches()
    t0 = time.perf_counter()
    got = {n: gpu.request("POST", "/passages/_search",
                          parity.SEARCH_BODIES[n]) for n in names}
    got_m = gpu.request("POST", "/_msearch", payload)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    log(f"serving: {len(names)} _search + one B=32 _msearch on the card in "
        f"{wall * 1e3:.3f} ms; launches {json.dumps(launches)}")
    for n in names:
        if got[n]["_status"] != 200:
            raise AssertionError(f"_search {n}: {got[n]}")
        parity.assert_same_response(
            got[n], cpu.request("POST", "/passages/_search",
                                parity.SEARCH_BODIES[n]), n)
    parity.assert_same_response(got_m, cpu.request("POST", "/_msearch",
                                                   payload), "msearch")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    log(f"serving: {len(names) + 32} pages equal the plain versions' pages")
    return launches


def phase_scale(torch, np, mapper, seg, dev, out_dir=None):
    from opensearch_tpu_torch.search.executor import (SearchExecutor,
                                                      ShardReader,
                                                      _envelope_kernel)
    from opensearch_tpu_torch.search import dsl
    from opensearch_tpu_torch.search.compile import Compiler
    from opensearch_tpu_torch.utils.demo import fast_query_terms

    reader = ShardReader(mapper, dev, index_name="msmarco_synth")
    t0 = time.perf_counter()
    reader.add_segment(seg)
    torch.cuda.synchronize()
    log(f"scale: image of {seg.num_docs} docs uploaded in "
        f"{time.perf_counter() - t0:.3f} s: {reader.device_bytes()} bytes "
        f"(Dp={reader.device[0][1].d_pad}, NBp={reader.device[0][1].nb_pad})")
    ex = SearchExecutor(reader)
    terms = sorted(t for _, t in seg.term_dict)
    texts = []
    for n in (2, 3, 4):
        texts += fast_query_terms(200, terms, seed=500 + n,
                                  terms_per_query=n)
    rng = np.random.default_rng(0)
    rng.shuffle(texts)
    bodies = [{"query": {"match": {"body": t}}} for t in texts]
    stats, segs, device = reader.stats_snapshot()
    comp = Compiler(mapper, stats)
    mix = {}
    for b in bodies:
        kind = _envelope_kernel(comp.compile(dsl.parse_query(b["query"]),
                                             segs[0], device[0][1]))
        mix[kind] = mix.get(kind, 0) + 1
    log(f"scale: kernel class mix over {len(bodies)} queries: "
        f"{json.dumps(mix)}")
    if set(mix) != {"candidate", "dense"}:
        raise AssertionError(f"scale queries must take both kernel classes, "
                             f"got {mix}")
    for b in bodies[:10]:
        ex.search(b)
    torch.cuda.synchronize()
    single = []
    for b in bodies[:300]:
        t = time.perf_counter()
        ex.search(b)
        single.append((time.perf_counter() - t) * 1e3)
    batches = []
    for i in range(0, 32 * 18, 32):
        t = time.perf_counter()
        ex.multi_search(bodies[i:i + 32])
        batches.append((time.perf_counter() - t) * 1e3)

    def pct(xs, p):
        return float(np.percentile(np.asarray(xs), p))
    log(f"scale: B=1 _search wall ms p50 {pct(single, 50):.3f} "
        f"p99 {pct(single, 99):.3f} over {len(single)}; "
        f"B=32 _msearch wall ms p50 {pct(batches, 50):.3f} "
        f"p99 {pct(batches, 99):.3f} over {len(batches)} batches "
        f"({32 * 1e3 / pct(batches, 50):.1f} queries/s at p50)")
    busy = profile_waves(torch, ex, bodies, out_dir)
    # sample pages against the plain versions (the same reader on the CPU)
    cpu_reader = ShardReader(mapper, "cpu", index_name="msmarco_synth")
    cpu_reader.add_segment(seg)
    cpu_ex = SearchExecutor(cpu_reader)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_common as parity
    sample = bodies[:6]
    for b in sample:
        parity.assert_same_response(ex.search(b), cpu_ex.search(b), "scale")
    parity.assert_same_response(ex.multi_search(bodies[:32]),
                                cpu_ex.multi_search(bodies[:32]), "scale32")
    log(f"scale: {len(sample) + 32} sampled pages equal the plain versions'")
    return {"image_bytes": reader.device_bytes(),
            "search_p50_ms": pct(single, 50), "search_p99_ms": pct(single, 99),
            "msearch32_p50_ms": pct(batches, 50),
            "msearch32_p99_ms": pct(batches, 99), **busy}


def profile_waves(torch, ex, bodies, out_dir, waves: int = 6):
    """Device busy share of B=32 _msearch waves: kernel time summed from a
    torch.profiler (CUPTI) trace over the wall time of the traced waves.
    Writes the per-kernel table to <out_dir>/profile_msearch32.txt when an
    output directory was given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(waves):
            ex.multi_search(bodies[32 * i:32 * (i + 1)])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = float(getattr(evt, "self_device_time_total", 0.0) or 0.0)
        per_kernel[evt.key] = per_kernel.get(evt.key, 0.0) + us
    device_ms = sum(per_kernel.values()) / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    if out_dir is not None:
        with open(os.path.join(out_dir, "profile_msearch32.txt"), "w") as f:
            f.write(f"{waves} B=32 waves, wall {wall_ms:.3f} ms, device "
                    f"kernel time {device_ms:.3f} ms\n")
            for key, us in top:
                f.write(f"{us / 1e3:10.3f} ms  {key}\n")
    if device_ms == 0.0:
        log("profile: the trace holds no device time: busy share not "
            "measured")
        return {"msearch32_device_busy": None}
    log(f"profile: {waves} B=32 waves: wall {wall_ms:.3f} ms, device "
        f"kernels {device_ms:.3f} ms, busy share {device_ms / wall_ms:.3f}; "
        f"top: " + "; ".join(f"{k[:48]} {us / 1e3:.3f} ms"
                             for k, us in top[:5]))
    return {"msearch32_device_busy": device_ms / wall_ms}


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None,
                        help="directory for the long outputs (nvcc's ptxas "
                             "report, the profiler's kernel table)")
    out_dir = parser.parse_args(argv).out
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "opensearch_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(opensearch_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from opensearch_tpu_torch.ops import _build
    from opensearch_tpu_torch.ops.device_segment import upload_segment
    from opensearch_tpu_torch.utils.demo import build_shards_fast

    t_all = time.perf_counter()
    # phase 1: build and card
    took = _build.build_all()
    log("build: " + json.dumps({k: round(v, 3) for k, v in took.items()})
        + " s (parallel nvcc, one library per source)")
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "nvcc_log.txt"), "w") as f:
            for name, text in _build.BUILD_LOG.items():
                f.write(f"--- {name}\n{text}\n")
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    mapper, segs, _terms = build_shards_fast(
        SCALE_DOCS, 1, vocab_size=20000, avg_len=60, seed=42,
        materialize_terms=SCALE_MATERIALIZE_TERMS)
    seg = segs[0]
    log(f"corpus: {seg.num_docs} passages, {len(seg.term_dict)} "
        f"materialized terms, {seg.post_docs.shape[0]} posting blocks, "
        f"built in {time.perf_counter() - t0:.3f} s")
    arrays, meta = upload_segment(seg, dev)

    # phase 2: kernels against their plain versions on the card
    results = phase_kernels(torch, np, seg, mapper, arrays, meta, dev)
    del arrays
    # phase 3: the main path, serving on the card
    launches = phase_serving(torch, np)
    # phase 4: scale
    scale = phase_scale(torch, np, mapper, seg, dev, out_dir)
    log("scale: " + json.dumps(scale))

    # one representative shape per kernel for the kernels line: the B=32
    # main-path batch (K1 at 4 terms / 16,384 lanes, K3 at k=100)
    pick = {"bm25_candidate": 4, "score_text_clause": 1, "masked_topk": 4}
    meta_of = {
        "bm25_candidate": ("opensearch_tpu_torch/ops/csrc/bm25_candidate.cu",
                           "opensearch_tpu/search/executor.py:1325"),
        "score_text_clause": (
            "opensearch_tpu_torch/ops/csrc/score_text_clause.cu",
            "opensearch_tpu/ops/bm25.py:135"),
        "masked_topk": ("opensearch_tpu_torch/ops/csrc/masked_topk.cu",
                        "opensearch_tpu/search/executor.py:1453"),
    }
    kernels = []
    for name in _build.KERNELS:
        rec = results[name][pick[name]]
        src, replaces = meta_of[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": max(r["max_abs_err"]
                                           for r in results[name]),
                        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"],
                        "library_ms": rec["library_ms"],
                        "call_ms": rec["call_ms"], "shape": rec["shape"]})
    log(f"total wall {time.perf_counter() - t_all:.3f} s; card: {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
