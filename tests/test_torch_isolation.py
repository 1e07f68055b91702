"""opensearch_tpu_torch stands alone: every module imports with `jax`
blocked, no module (and not chip_smoke.py) imports opensearch_tpu, and the
Node defaults to the card."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import opensearch_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.join(ROOT, "opensearch_tpu_torch")
_REFERENCE_IMPORT = re.compile(
    r"^\s*(import|from)\s+opensearch_tpu(?!_torch)\b", re.MULTILINE)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        opensearch_tpu_torch.__path__, "opensearch_tpu_torch."))


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "opensearch_tpu_torch.node" in mods
    assert "opensearch_tpu_torch.ops.knn" in mods
    for new in ("ops.maxsim", "ops.hybrid", "search.spmd",
                "searchpipeline.hybrid", "searchpipeline.processors",
                "searchpipeline.service", "indices.query_cache",
                "search.fetch", "search.controller", "ops.sort_key",
                "ops.page", "ops.agg_kernels", "search.aggs.pipeline",
                "script.painless", "ops.scoring", "analysis.porter",
                "common.settings", "cluster.routing", "search.canmatch",
                "parallel.distributed", "ops.spmd"):
        assert f"opensearch_tpu_torch.{new}" in mods
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'opensearch_tpu' or "
            "m.startswith(('opensearch_tpu.', 'jax.'))]\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def test_no_source_imports_the_reference():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG_DIR)
             for f in fs if f.endswith((".py", ".cu", ".cuh"))]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    offenders = [f for f in files
                 if _REFERENCE_IMPORT.search(open(f).read())]
    assert not offenders, offenders


def test_node_defaults_to_the_card():
    from opensearch_tpu_torch.node import Node
    assert Node(device="cpu").device == torch.device("cpu")
    if torch.cuda.is_available():
        assert Node().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        Node()
