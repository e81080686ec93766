"""TensorBoard summaries (``bigdl_tpu/visualization``)."""

from bigdl_tpu_torch.visualization.events import EventWriter, read_events
from bigdl_tpu_torch.visualization.summary import (
    Summary,
    TrainSummary,
    ValidationSummary,
)

__all__ = ["EventWriter", "Summary", "TrainSummary", "ValidationSummary",
           "read_events"]
