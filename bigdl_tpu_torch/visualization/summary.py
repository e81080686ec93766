"""Training and validation summaries in TensorBoard's event format
(``bigdl_tpu/visualization/summary.py``): ``add_scalar``,
``add_histogram``, and ``read_scalar`` to read a tag's series back.
``TrainSummary`` writes under ``<log_dir>/<app_name>/train``, with
optional triggers (``set_summary_trigger("Parameters", trigger)`` adds
weight histograms on the iterations the trigger fires);
``ValidationSummary`` under ``<app_name>/validation``. Either package
reads the other's files."""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

from bigdl_tpu_torch.visualization.events import (
    EventWriter,
    encode_event,
    encode_histogram_summary,
    encode_scalar_summary,
    read_events,
)


class Summary:
    def __init__(self, log_dir: str, app_name: str, tag_suffix: str = ""):
        self.log_dir = os.path.join(log_dir, app_name + tag_suffix)
        self._writer = EventWriter(self.log_dir)

    def add_scalar(self, tag: str, value: float, step: int) -> "Summary":
        self._writer.write_event(encode_event(
            step, summary=encode_scalar_summary(tag, float(value))))
        return self

    def add_histogram(self, tag: str, values, step: int) -> "Summary":
        self._writer.write_event(encode_event(
            step, summary=encode_histogram_summary(tag, values)))
        return self

    def read_scalar(self, tag: str) -> List[Tuple[int, float]]:
        """The (step, value) series of ``tag``."""
        out = []
        for name in sorted(os.listdir(self.log_dir)):
            if "tfevents" not in name:
                continue
            for _, step, scalars in read_events(
                    os.path.join(self.log_dir, name)):
                out.extend((step, v) for t, v in scalars if t == tag)
        return out

    def close(self) -> None:
        self._writer.close()


class TrainSummary(Summary):
    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "/train")
        self.triggers: Dict[str, object] = {}

    def set_summary_trigger(self, name: str, trigger) -> "TrainSummary":
        self.triggers[name] = trigger
        return self


class ValidationSummary(Summary):
    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "/validation")
