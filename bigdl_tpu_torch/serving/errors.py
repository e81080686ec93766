"""Typed serving failures (``bigdl_tpu/serving/errors.py``).

Admission-time failures (:class:`Overloaded`, :class:`UnknownModel`)
raise on the caller's thread before a queue slot is taken; in-flight failures
(:class:`DeadlineExceeded`, :class:`StreamCancelled`,
:class:`GrammarViolation`) end the request's stream.
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


class UnknownModel(ServingError):
    """A router request named a model no backend is registered under."""

    def __init__(self, name: str, available):
        avail = ", ".join(sorted(available)) or "<none>"
        super().__init__(
            f"no model '{name}' registered (available: {avail})")
        self.name = name
        self.available = sorted(available)


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


class GrammarViolation(ServingError):
    """A grammar-constrained stream reached a terminal it cannot parse
    from: the token budget ran out in a non-accepting automaton state, or
    the state has no legal continuation and no legal EOS (stuck). Every
    emitted stream must parse, so the stream fails with this error rather
    than deliver text outside the grammar. Tokens produced before the
    violation stay on the stream; ``state`` is the automaton state the
    stream ended in."""

    def __init__(self, why: str, *, state: int, tokens_out: int,
                 grammar_key: "str | None" = None):
        what = f" for grammar '{grammar_key}'" if grammar_key else ""
        super().__init__(
            f"constrained stream cannot complete a parse{what}: {why} "
            f"(automaton state {state}, {tokens_out} tokens emitted)")
        self.why = why
        self.state = state
        self.tokens_out = tokens_out
        self.grammar_key = grammar_key
