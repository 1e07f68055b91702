"""Search-pipeline processors (the subset of
opensearch_tpu.searchpipeline.processors the port serves): the
neural-search NormalizationProcessor. Each processor validates its config
when the pipeline is put, so a bad config is a 400 on the CRUD call.
Request and response processor types are not ported yet: naming one is the
reference's 400 for an unknown type."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from opensearch_tpu_torch.common.errors import IllegalArgumentError


NORMALIZATION_TECHNIQUES = ("min_max", "l2")
COMBINATION_TECHNIQUES = ("arithmetic_mean", "geometric_mean",
                          "harmonic_mean")


class NormalizationProcessor:
    """The hybrid score merge spec: a normalization technique and a
    weighted combination technique (neural-search NormalizationProcessor).
    The merge runs in searchpipeline/hybrid.py at reduce time."""
    type_name = "normalization-processor"

    def __init__(self, config: Dict[str, Any]):
        norm = config.get("normalization") or {}
        comb = config.get("combination") or {}
        self.normalization = str(norm.get("technique", "min_max"))
        if self.normalization not in NORMALIZATION_TECHNIQUES:
            raise IllegalArgumentError(
                f"provided [normalization] technique "
                f"[{self.normalization}] is not supported, must be one of "
                f"{list(NORMALIZATION_TECHNIQUES)}")
        self.combination = str(comb.get("technique", "arithmetic_mean"))
        if self.combination not in COMBINATION_TECHNIQUES:
            raise IllegalArgumentError(
                f"provided [combination] technique [{self.combination}] "
                f"is not supported, must be one of "
                f"{list(COMBINATION_TECHNIQUES)}")
        params = comb.get("parameters") or {}
        self.weights: Optional[List[float]] = None
        if params.get("weights") is not None:
            ws = params["weights"]
            if not isinstance(ws, (list, tuple)) or not ws:
                raise IllegalArgumentError(
                    "[normalization-processor] combination [weights] must "
                    "be a non-empty array of numbers")
            try:
                self.weights = [float(w) for w in ws]
            except (TypeError, ValueError):
                raise IllegalArgumentError(
                    "[normalization-processor] combination [weights] must "
                    "be numbers")
            if any(w < 0 for w in self.weights):
                raise IllegalArgumentError(
                    "[normalization-processor] combination [weights] must "
                    "be non-negative")

    def spec(self) -> dict:
        return {"normalization": self.normalization,
                "combination": self.combination,
                "weights": self.weights}


# the processor types of each list a pipeline body may hold (no request
# or response processor type is ported yet)
PROCESSORS = {
    "request_processors": {},
    "response_processors": {},
    "phase_results_processors": {
        NormalizationProcessor.type_name: NormalizationProcessor},
}


def build_processors(kind: str, specs: Any) -> List[NormalizationProcessor]:
    """Parse one processor list of a pipeline body: single-key {type:
    config} objects; an unknown type is a 400."""
    registry = PROCESSORS[kind]
    if specs is None:
        return []
    if not isinstance(specs, list):
        raise IllegalArgumentError(f"[{kind}] must be an array")
    out: List[NormalizationProcessor] = []
    for spec in specs:
        if not isinstance(spec, dict) or len(spec) != 1:
            raise IllegalArgumentError(
                f"[{kind}] entries must be single-key processor objects")
        type_name, config = next(iter(spec.items()))
        cls = registry.get(type_name)
        if cls is None:
            raise IllegalArgumentError(
                f"Invalid processor type [{type_name}] in [{kind}]")
        out.append(cls(config if isinstance(config, dict) else {}))
    return out
