"""Serving tier: paged continuous-batching generation, greedy or sampled,
plain or speculative, grammar-constrained or free, scheduled synchronously
or async, with a prefix cache, a host KV tier and prefill/decode
disaggregation."""

from bigdl_tpu_torch.serving.batcher import bucket_sizes_for
from bigdl_tpu_torch.serving.disagg import (
    DisaggregatedEngine,
    PageBlockMover,
    PrefillWorker,
)
from bigdl_tpu_torch.serving.engine import (
    GenerationEngine,
    GenerationStream,
    PagedDecodeKernels,
    SpeculativeKernels,
    static_generate,
)
from bigdl_tpu_torch.serving.errors import (
    DeadlineExceeded,
    GrammarViolation,
    Overloaded,
    ServingError,
    StreamCancelled,
)
from bigdl_tpu_torch.serving.kv_tiers import HostCopier, HostPageStore
from bigdl_tpu_torch.serving.metrics import ServingMetrics
from bigdl_tpu_torch.serving.paging import PagePool, page_bytes, pages_per_lane
from bigdl_tpu_torch.serving.prefix_cache import PrefixCache

__all__ = ["DeadlineExceeded", "DisaggregatedEngine", "GenerationEngine",
           "GenerationStream", "GrammarViolation", "HostCopier",
           "HostPageStore", "Overloaded", "PageBlockMover", "PagePool",
           "PagedDecodeKernels", "PrefillWorker", "PrefixCache",
           "ServingError", "ServingMetrics", "SpeculativeKernels",
           "StreamCancelled", "bucket_sizes_for", "page_bytes",
           "pages_per_lane", "static_generate"]
