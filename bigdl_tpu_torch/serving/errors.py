"""Typed serving failures (``bigdl_tpu/serving/errors.py``).

Admission-time failures (:class:`Overloaded`) raise on the caller's
thread before a queue slot is taken; in-flight failures
(:class:`DeadlineExceeded`, :class:`StreamCancelled`) end the request's
stream.
"""

from __future__ import annotations


class ServingError(RuntimeError):
    """Base class for serving-tier failures."""


class Overloaded(ServingError):
    """The request queue is at its bound; the request was rejected without
    being enqueued (backpressure, not buffering)."""

    def __init__(self, queue_depth: int, max_queue: int,
                 model: "str | None" = None):
        where = f"model '{model}'" if model else "serving queue"
        super().__init__(
            f"{where} full ({queue_depth}/{max_queue}); request rejected")
        self.queue_depth = queue_depth
        self.max_queue = max_queue
        self.model = model


class StreamCancelled(ServingError):
    """The generation stream was cancelled by its consumer; the slot was
    retired at the next step boundary. Tokens produced before the cancel
    stay readable on the stream."""


class DeadlineExceeded(ServingError):
    """The request's deadline expired before it finished."""

    def __init__(self, waited_s: float, deadline_s: float):
        super().__init__(
            f"request deadline {deadline_s * 1e3:.1f} ms exceeded after "
            f"waiting {waited_s * 1e3:.1f} ms")
        self.waited_s = waited_s
        self.deadline_s = deadline_s
