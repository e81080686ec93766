"""Bucket sizes for padded shapes (``bigdl_tpu/serving/batcher.py``)."""

from __future__ import annotations

from typing import List


def bucket_sizes_for(max_batch_size: int) -> List[int]:
    """Powers of two up to ``max_batch_size`` (which is always included
    as the top bucket, power of two or not)."""
    if max_batch_size < 1:
        raise ValueError("max_batch_size must be >= 1")
    sizes, b = [], 1
    while b < max_batch_size:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch_size)
    return sizes
