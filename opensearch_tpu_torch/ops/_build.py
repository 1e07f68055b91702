"""Build and load the hand-written CUDA kernels of `ops/csrc/`.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with a
plain C interface, loaded through ctypes. The build runs at first use, from
the sources alone, into `opensearch_tpu_torch/build/`; all sources compile
in parallel (one nvcc process each). A library's file name carries a digest
of its source and flags, so an edited source rebuilds. A failed build
raises: nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
KERNELS = ("bm25_candidate", "score_text_clause", "masked_topk",
           "pairs_match", "binned_popcount", "binned_reduce", "knn_exact",
           "ivf_probe", "kmeans_step", "maxsim_exact", "maxsim_pq",
           "hybrid_window", "sort_key", "page_merge", "dense_numeric",
           "matrix_moments", "adjacency_counts", "function_score",
           "score_kinds", "blockmax_keep", "row_merge", "nested_join",
           "nested_aggs", "binned_scatter", "geo_scores")
# libraries whose C entries are not only the one of their own name (every
# entry listed): score_kinds.cu and geo_scores.cu have one per kernel and
# none of their name; row_merge.cu holds K21's merge and its key entry;
# nested_aggs.cu K23's nested and reverse_nested entries
LIBRARY_ENTRIES = {"score_kinds": ("terms_set_scores",
                                   "distance_feature_scores",
                                   "boosting_scores", "script_score_wrap"),
                   "row_merge": ("row_merge", "row_value_key"),
                   "nested_aggs": ("nested_agg", "reverse_nested_agg"),
                   "geo_scores": ("geo_distance_scores", "geo_bbox_scores",
                                  "distance_feature_geo_scores",
                                  "rank_feature_scores")}
# --fmad=false: no multiply-add contraction, so each kernel rounds its
# arithmetic exactly like its plain PyTorch version (one rounding per op)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

# launches of each C entry point: a wrapper adds one where it calls the
# entry, and nowhere else (plain-version calls do not count). A library's
# main entry shares its name; masked_topk.cu also holds
# masked_topk_threshold and masked_topk_keyed, knn_exact.cu knn_topk_mark,
# ivf_probe.cu ivf_block_keys and maxsim_pq.cu pq_lut; score_kinds.cu,
# row_merge.cu, nested_aggs.cu and geo_scores.cu hold their
# LIBRARY_ENTRIES. K1's and K2's calls with
# K20's keep mask (the block-max arm) count as bm25_candidate_keep and
# score_text_clause_keep.
LAUNCHES: Dict[str, int] = {name: 0 for name in (
    *(k for k in KERNELS if k not in LIBRARY_ENTRIES),
    "masked_topk_threshold", "knn_topk_mark", "ivf_block_keys", "pq_lut",
    "masked_topk_keyed", "bm25_candidate_keep", "score_text_clause_keep",
    *(e for es in LIBRARY_ENTRIES.values() for e in es))}
# compiler output (ptxas register / shared-memory report) of the last build
# of each library (empty until one ran)
BUILD_LOG: Dict[str, str] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[str, object] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "opensearch_tpu_torch build only where the CUDA "
                           "toolkit is installed")
    return found


def _lib_path(name: str) -> Path:
    # the shared headers of csrc/ count as part of every source
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all() -> Dict[str, float]:
    """Compile every kernel source whose library is missing, all in
    parallel. Returns the build seconds per compiled source."""
    todo = [n for n in KERNELS if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp)
    took: Dict[str, float] = {}
    failures = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        BUILD_LOG[name] = out.decode(errors="replace")
        if proc.returncode != 0:
            failures.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n"
                            f"{out.decode(errors='replace')}")
            continue
        os.replace(tmp, _lib_path(name))
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return took


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building every missing one first."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(_lib_path(name)))
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _LIBS[name] = lib
    return lib


def entry(name: str, argtypes, lib: str = None):
    """The C entry point `name` of library `lib` (by default the one of the
    same name), with its argument types declared once."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(library(lib or name), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return fn


def check(name: str, code: int, lib: str = None) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if code != 0:
        lib = lib or name
        msg = getattr(library(lib), f"{lib}_error_string")(code)
        raise RuntimeError(f"CUDA kernel {name} failed: "
                           f"{msg.decode(errors='replace')} (error {code})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
