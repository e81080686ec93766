"""Serving tier: request serving (``InferenceService`` over a
``DynamicBatcher``, the multi-model ``ModelRouter``) and continuous-batching
generation over paged or dense KV lanes, greedy or sampled, plain or
speculative, grammar-constrained or free, scheduled synchronously or
async, with a prefix cache, a host KV tier, prefill/decode disaggregation
and hot reload, from a checkpoint directory too (``watch_checkpoints``)."""

from bigdl_tpu_torch.serving.batcher import DynamicBatcher, bucket_sizes_for
from bigdl_tpu_torch.serving.disagg import (
    DisaggregatedEngine,
    PageBlockMover,
    PrefillWorker,
)
from bigdl_tpu_torch.serving.engine import (
    DecodeKernels,
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
    UnknownModel,
)
from bigdl_tpu_torch.serving.hot_reload import (
    CheckpointWatcher,
    watch_checkpoints,
)
from bigdl_tpu_torch.serving.kv_tiers import HostCopier, HostPageStore
from bigdl_tpu_torch.serving.metrics import ServingMetrics
from bigdl_tpu_torch.serving.paging import PagePool, page_bytes, pages_per_lane
from bigdl_tpu_torch.serving.prefix_cache import PrefixCache
from bigdl_tpu_torch.serving.router import ModelRouter
from bigdl_tpu_torch.serving.service import (
    InferenceService,
    require_matching_signature,
    tree_signature,
)

__all__ = ["CheckpointWatcher", "DeadlineExceeded", "DecodeKernels", "DisaggregatedEngine",
           "DynamicBatcher", "GenerationEngine", "GenerationStream",
           "GrammarViolation", "HostCopier", "HostPageStore",
           "InferenceService", "ModelRouter", "Overloaded",
           "PageBlockMover", "PagePool", "PagedDecodeKernels",
           "PrefillWorker", "PrefixCache", "ServingError",
           "ServingMetrics", "SpeculativeKernels", "StreamCancelled",
           "UnknownModel", "bucket_sizes_for", "page_bytes",
           "pages_per_lane", "require_matching_signature",
           "static_generate", "tree_signature", "watch_checkpoints"]
