"""opensearch_tpu_torch: the PyTorch/CUDA port of opensearch_tpu.

The first slice serves BM25 `_search` / `_msearch` on an NVIDIA H100: the
host layers (mapper, segments, DSL, compiler, executor, REST routes) keep the
JAX package's module paths and names, and the device programs on the path are
CUDA C++ kernels written by hand for `sm_90a` (`ops/csrc/`), each with a
plain PyTorch version of the same function beside its wrapper.

The package imports `torch` and numpy only: never `jax`, and nothing of
`opensearch_tpu`.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device the port runs on: CUDA unless the caller names another.

    `device=None` means the card. Without CUDA this raises rather than
    running somewhere else; callers that want the plain versions on the
    CPU (the tests) pass `device="cpu"`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "opensearch_tpu_torch needs a CUDA device; none is available. "
            "Pass device='cpu' to run the plain PyTorch versions.")
    return dev
