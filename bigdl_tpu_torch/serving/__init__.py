"""Serving tier: paged continuous-batching generation."""

from bigdl_tpu_torch.serving.batcher import bucket_sizes_for
from bigdl_tpu_torch.serving.engine import (
    GenerationEngine,
    GenerationStream,
    PagedDecodeKernels,
    static_generate,
)
from bigdl_tpu_torch.serving.errors import (
    DeadlineExceeded,
    Overloaded,
    ServingError,
    StreamCancelled,
)
from bigdl_tpu_torch.serving.metrics import ServingMetrics
from bigdl_tpu_torch.serving.paging import PagePool, page_bytes, pages_per_lane

__all__ = ["DeadlineExceeded", "GenerationEngine", "GenerationStream",
           "Overloaded", "PagePool", "PagedDecodeKernels", "ServingError",
           "ServingMetrics", "StreamCancelled", "bucket_sizes_for",
           "page_bytes", "pages_per_lane", "static_generate"]
