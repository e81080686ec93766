"""``MiniBatch`` (``bigdl_tpu/dataset/sample.py``): stacked numpy features
and labels on the host."""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class MiniBatch:
    input: Any
    target: Any = None

    def size(self) -> int:
        return self.input.shape[0]
