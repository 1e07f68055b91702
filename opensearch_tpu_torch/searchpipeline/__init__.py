"""Search pipelines (the subset of opensearch_tpu.searchpipeline the port
serves): named pipelines resolved per request from the `search_pipeline`
parameter, an inline definition or the index's
`index.search.default_pipeline`, holding the neural-search
`normalization-processor` that merges a `hybrid` query's sub-query scores
at reduce time (hybrid.py). Other processor types are not ported yet."""

from opensearch_tpu_torch.searchpipeline.service import (  # noqa: F401
    SearchPipeline, SearchPipelineService)
