"""GenerationEngine — continuous-batching generation over a paged KV cache
or dense K/V lanes (``bigdl_tpu/serving/engine.py``).

The unit of scheduling is ONE decode step. A loop thread admits pending
prompts into free slots between steps, advances one prompt chunk per
prefilling slot (chunked prefill interleaves with neighbours' decode
steps), runs one decode step over every decoding slot, and retires
finished sequences (EOS, max-tokens, deadline, cancel) mid-flight. The KV
cache is a shared pool of fixed-size pages per layer; the host-side
:class:`~bigdl_tpu_torch.serving.paging.PagePool` reserves a request's
full page budget at admission and frees it at retirement.

Invariants kept from the JAX engine:

- the decode step always runs at ``max_slots`` rows; idle slots' page-map
  rows and bucket-padding rows point at the trash page, so their writes
  never land in a page a sequence owns;
- a prefilling slot's page-map row stays on the trash page until its FINAL
  chunk has run (interleaved decode steps write a pad row for every slot);
  the chunk calls take the page row as an explicit argument instead;
- the loop thread is named ``bigdl-serving-engine`` and ``close()`` joins
  it; an engine dropped without ``close()`` is collected and its loop
  exits, failing any stranded stream.

:func:`static_generate` is the run-to-completion baseline over the same
kernels. Greedy output is schedule-invariant, so the engine's streams
equal static_generate's token for token.

The int8 serving tier: ``quantize="int8"`` serves a
``quantize_for_serving`` copy of the model (every GEMM and the lm head as
an ``s8 x s8 -> s32`` product), quantized once at construction;
``cache_dtype=torch.int8`` stores the KV pages int8 with per-token fp32
scale pools, and the decode step's attention runs kernel B3-int8. The
metrics report ``quantized_gemms``, ``kv_cache_dtype`` and
``kv_bytes_in_use`` (scale pools included).

Sampling: ``submit(temperature=, top_k=, top_p=, seed=)`` samples inside
the step from a per-request threefry key; the key defaults to a pure
function of the engine's ``seed`` and the prompt, so sampled streams, like
greedy ones, are the same across runs, admission orders and schedulers
(``static_generate(sampling=...)``).

Speculative decoding: ``speculate=(draft_model, k)`` pairs the target with
a cheap draft of the same vocabulary. Each iteration runs k+1 draft decode
steps (the +1 pre-writes the bonus row of the draft's cache, so a full
acceptance leaves no hole) and ONE target verify forward over all k
candidates; the two models' lanes sit side by side in the one page pool,
tagged ``"target"`` and ``"draft"``. Greedy speculative output is the
plain engine's token for token.

Prefix caching: ``prefix_cache=True`` publishes every retiring
sequence's full prompt pages to a radix index
(:class:`~bigdl_tpu_torch.serving.prefix_cache.PrefixCache`); an admission
whose prompt starts with a cached page-aligned prefix attaches those pages
by reference and prefills only its tail, so the prompt calls the prefix
covered never run. Cached pages hold the bits a fresh prefill writes:
output with the cache on is the output with it off. Under page pressure
the admission evicts unreferenced cached pages (LRU leaves) before it
waits; ``cache_aware_admission=True`` lets a later request that fits pass
a page-blocked head, at most four times in a row.

KV tiers: ``host_pages=N`` (with the prefix cache, without speculation)
puts a host-memory store of N pages under the device pool
(:class:`~bigdl_tpu_torch.serving.kv_tiers.HostPageStore`): evicted prefix
pages are copied to pinned host memory without blocking, filed once a
CUDA event says the copy landed, and copied back when a later prompt
needs them. ``submit(priority=)``: a page-blocked head may swap out active
streams of strictly lower priority through the same tier; they resume
where they stopped, bit for bit.

Prefill/decode disaggregation: ``role="prefill"`` runs only prompt
calls and hands each prompt's finished pages to a consumer (the gathered
block, the page manifest, the first token and the key after its split);
``role="decode"`` runs only decode steps and admits such payloads through
``submit_prefilled``, adopting the pages into its own pool. The front
door is ``serving.disagg.DisaggregatedEngine``; its streams are the
monolithic engine's token for token.

Grammar-constrained decoding: ``submit(grammar=automaton)`` samples every
token of a stream under the automaton's current-state mask (an additive
``(S, V)`` row per slot, 0 legal / -1e9 illegal, added to the logits
before the sampler), advances the state on the host per emitted token,
and fails a stream that cannot parse with ``GrammarViolation``. A step
with no constrained slot passes no mask at all.

Observability: every scheduler iteration lands one row in
``engine.timeline`` (:class:`~bigdl_tpu_torch.obs.timeline.StepTimeline`:
host time against time inside the kernel-call regions, the prefill /
decode / verify split, queue depth, occupancy); ``tracer=obs.Tracer()``
gives every request a span tree (queue wait, page reservation, prompt
chunks, counted decode steps or verify rounds, outcome) on its stream;
``profile_dir`` records a ``torch.profiler`` trace of the first
``profile_iters`` iterations. The engine fires the fault sites of
:data:`~bigdl_tpu_torch.faults.SITES` (``engine.decode``,
``engine.prefill``, ``engine.prefix_attach``, ``engine.page_handoff``,
``engine.draft``, ``engine.verify``, ``kv.offload``, ``kv.restore``), and
``stall_timeout`` arms a watchdog around every iteration: a step that
makes no progress for that long fails every stream with
:class:`~bigdl_tpu_torch.faults.StallError` and the engine refuses new
submits.

Async scheduling: ``async_scheduling=True`` lands step N's tokens,
dispatches step N+1 at once, and does the host work of step N (delivery,
retirement, admission, prompt chunks, the host tier's copy poll) while
N+1 runs on the device. Every input of a step goes up from a pinned
staging ring without blocking, and the step's tokens come back into a
pinned buffer behind a CUDA event, so nothing between the step's first
kernel and its ticket waits for the device. Decisions lag one step: a
slot that finishes rides the step already in flight, whose token for it
is discarded. The streams are the synchronous engine's, bit for bit. A
speculative engine keeps the synchronous path (the verify round's accept
count is a host decision the next round's first draft step needs).

Dense lanes: ``page_size=0``, ``kernels=DecodeKernels(model)`` or a model
without the paged API gives the JAX package's baseline engine: one
``(max_slots, H, max_len, D)`` K/V lane per slot and layer
(``Transformer.init_cache``), a whole prompt per call (``max_prompt_len``
defaults to ``max_len // 2``), greedy, with B2 on every prompt call and
every decode step on a card. It refuses, in the JAX engine's words,
sampling, grammars, int8 lanes, roles, the host tier, the prefix cache
and speculation; int8 weights on float lanes are served. Its greedy
streams are the paged engine's.

Hot reload: ``reload(params)`` swaps in a float parameter tree between
iterations (re-quantized for a ``quantize="int8"`` engine) and, with the
prefix cache, drops the pages the old weights wrote.

Tensor parallelism comes with a later slice.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import os
import queue as _queue
import threading
import time
import uuid
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch import faults
from bigdl_tpu_torch.core.device import DeviceLike, module_device
from bigdl_tpu_torch.core.rng import request_seed, threefry_key_data
from bigdl_tpu_torch.faults import StallError, Watchdog
from bigdl_tpu_torch.nn.quantized import (
    count_quantized_gemms,
    quantize_for_serving,
    quantize_tree_for_serving,
)
from bigdl_tpu_torch.obs.timeline import StepTimeline
from bigdl_tpu_torch.obs.trace import submit_trace
from bigdl_tpu_torch.ops.sampling import (
    EXTRA_STREAM,
    biased_logits,
    check_temperature,
    draft_sample,
    greedy_tokens,
    position_sample,
    sample_tokens,
    speculative_sample,
)
from bigdl_tpu_torch.serving.batcher import bucket_sizes_for
from bigdl_tpu_torch.serving.errors import (
    DeadlineExceeded,
    GrammarViolation,
    Overloaded,
    StreamCancelled,
)
from bigdl_tpu_torch.serving.kv_tiers import HostCopier, HostPageStore
from bigdl_tpu_torch.serving.metrics import ServingMetrics
from bigdl_tpu_torch.serving.paging import (
    PagePool,
    page_bytes,
    pages_per_lane,
)
from bigdl_tpu_torch.serving.prefix_cache import PrefixCache
from bigdl_tpu_torch.serving.service import (
    apply_staged,
    require_matching_signature,
    stage,
)

log = logging.getLogger("bigdl_tpu_torch.serving")

_SENTINEL = object()

# the modules that engines given a caller's kernels serve in place, each
# with those engines: a reload copies into the module, so it is refused
# while another live engine serves the same one (whose steps would read
# a mix of old and new layers)
_SERVED_IN_PLACE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _serving_model(model, quantize: Optional[str], kernels):
    """The model the kernels run: the engine's own copy of ``model`` (a
    reload writes its tensors and no one else's), ``model`` itself when
    the caller built the kernels over it, or for ``quantize="int8"`` its
    ``quantize_for_serving`` copy."""
    if quantize not in (None, "int8"):
        raise ValueError(f"quantize must be None or 'int8', "
                         f"got {quantize!r}")
    if quantize is None:
        return model if kernels is not None else copy.deepcopy(model)
    if kernels is not None:
        raise ValueError(
            "quantize='int8' builds its kernels over the quantized copy of "
            "the model; pass kernels=None, or pass kernels built over "
            "nn.quantized.quantize_for_serving(model) with quantize=None")
    return quantize_for_serving(model)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def _masked(bias) -> dict:
    """The kernel call's ``bias`` keyword: none at all for an unmasked
    call, so a kernel set that takes no mask keeps serving unconstrained
    traffic."""
    return {} if bias is None else {"bias": bias}


class _HostStage:
    """The pinned staging ring every host input of a kernel call goes up
    through: token ids, positions, page maps, the sampler's per-slot
    filter rows and uniforms, and grammar mask rows.

    Each kernel call runs inside :meth:`call`, which takes the next slot
    of the ring and yields ``put``: ``put(array)`` writes the numpy array
    into the slot's pinned buffer and copies it to the device with
    ``non_blocking=True``, returning the device tensor. Leaving the call
    records the slot's CUDA event; a slot is written again only after
    that event has completed. A copy from pageable memory would make the
    host wait for every kernel queued before it; these never do, as long
    as the ring is deeper than the calls one scheduler iteration makes.
    On the CPU ``put`` returns the array as a tensor (the computation
    runs before the call returns)."""

    _ALIGN = 64

    def __init__(self, device: torch.device, slot_bytes: int, depth: int):
        self.device = device
        self.cuda = device.type == "cuda"
        self.slot_bytes = int(slot_bytes)
        self._i = -1
        self._off = 0
        if self.cuda:
            # pin_memory raises where pinned memory is unavailable: a CUDA
            # engine never falls back to pageable copies
            self._bufs = [torch.empty(self.slot_bytes, dtype=torch.uint8,
                                      pin_memory=True)
                          for _ in range(depth)]
            self._events = [torch.cuda.Event() for _ in range(depth)]
            self._used = [False] * depth

    @contextlib.contextmanager
    def call(self):
        """Around one kernel call: takes the next slot (waiting for its
        last copies if they have not run) and yields ``put``."""
        if not self.cuda:
            yield _cpu_put
            return
        self._i = (self._i + 1) % len(self._bufs)
        if self._used[self._i]:
            self._events[self._i].synchronize()
        self._off = 0
        try:
            yield self._put
        finally:
            self._events[self._i].record(
                torch.cuda.current_stream(self.device))
            self._used[self._i] = True

    def upload(self, a) -> torch.Tensor:
        """One array through a slot of its own."""
        with self.call() as put:
            return put(a)

    def _put(self, a) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        off = -(-self._off // self._ALIGN) * self._ALIGN
        if off + a.nbytes > self.slot_bytes:
            raise ValueError(
                f"staging slot of {self.slot_bytes} bytes cannot hold "
                f"{off + a.nbytes} bytes of step inputs")
        host = self._bufs[self._i][off:off + a.nbytes].view(
            torch.from_numpy(a).dtype).view(a.shape)
        host.numpy()[...] = a
        self._off = off + a.nbytes
        return host.to(self.device, non_blocking=True)


def _cpu_put(a) -> torch.Tensor:
    # a snapshot, as the card's staged copy is
    return torch.from_numpy(np.array(a, copy=True))


def _stage_bytes(max_slots: int, pages_per_slot: int, vocab: Optional[int],
                 prompt_width: int) -> int:
    """Bytes one kernel call's inputs take in the staging ring, alignment
    included: a decode step's tokens, positions, page map, five filter
    rows and mask rows, or a prompt call's page row, tokens, filter row
    and mask row, whichever is larger (every element 4 bytes)."""
    rows = max_slots * (2 + pages_per_slot + 5) + max_slots * (vocab or 0)
    prompt = pages_per_slot + prompt_width + 5 + (vocab or 0)
    return 4 * max(rows, prompt) + 8 * _HostStage._ALIGN


class _Kernels:
    """What every kernel set shares: the target ``model`` and its device.

    Every method that takes ``upload`` moves its host inputs to the
    device through it: a function from a numpy array to a device tensor
    (the engine passes its pinned staging ring's ``put``). Without one,
    host inputs are copied the plain way, which on a card waits for the
    kernels queued before the copy."""

    def __init__(self, model):
        self.model = model
        self.device = next(model.parameters()).device

    def _ids(self, a, upload=None) -> torch.Tensor:
        """Host ids (numpy or lists) copied to the model's device as int32;
        a device tensor (a draft step's tokens, a staged input) stays
        where it is."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device, torch.int32)
        a = np.asarray(a, np.int32)
        if upload is not None:
            return upload(a)
        return torch.as_tensor(a, device=self.device)


class DecodeKernels(_Kernels):
    """The greedy ``(prefill, decode)`` pair over a dense model
    (``init_cache`` / ``prefill`` / ``decode_step``: a K/V lane per slot,
    no pages). The argmax runs on the device, so only the int32 tokens
    come back. Every prompt call and every decode step attends through
    kernel B2 on a card, under the validity bias."""

    @torch.inference_mode()
    def prefill(self, cache, slot: int, tokens, length: int, upload=None):
        """One padded prompt into ``slot``'s lanes -> ``(first token
        (device int32 scalar), cache)``."""
        logits, cache = self.model.prefill(cache, int(slot),
                                           self._ids(tokens, upload),
                                           int(length))
        return greedy_tokens(logits), cache

    @torch.inference_mode()
    def decode(self, cache, tokens, positions, upload=None):
        """One decode step for every slot -> ``(next token per slot (S,)
        device int32, cache)``."""
        logits, cache = self.model.decode_step(
            cache, self._ids(tokens, upload), self._ids(positions, upload))
        return greedy_tokens(logits), cache


class _PagedKernels(_Kernels):
    """What both paged kernel sets share: the non-final prompt chunk."""

    @torch.inference_mode()
    def chunk(self, cache, pages, tokens, start: int, length: int,
              trash: int, upload=None):
        """Non-final prompt chunk: K/V writes only. -> cache."""
        return self.model.prefill_paged(
            cache, self._ids(pages, upload), self._ids(tokens, upload),
            int(start), int(length), int(trash), need_logits=False)


class PagedDecodeKernels(_PagedKernels):
    """The ``(prefill, chunk, decode)`` triple over a paged model
    (``init_paged_cache`` / ``prefill_paged`` / ``decode_step_paged``).
    Host inputs (numpy or lists) are copied to the model's device; only
    the int32 next-token vector comes back. Token selection runs on the
    device: greedy argmax, or sampling from per-slot ``temperature`` /
    ``top_k`` / ``top_p`` under per-slot threefry keys, split once per call
    (``ops.sampling.sample_tokens``). ``bias`` (the grammar mask: ``(1,
    V)`` for ``prefill``, ``(S, V)`` for ``decode``), optional, is added
    to the fp32 logits before the sampler; the model's attention never
    sees it. The keys split on the host, so a step's new keys are host
    words as soon as the call returns."""

    @torch.inference_mode()
    def prefill(self, cache, pages, tokens, start: int, length: int,
                trash: int, temperature: float = 0.0, top_k: int = 0,
                top_p: float = 1.0, key=None, bias=None, upload=None):
        """Final (or only) chunk of one prompt: writes its K/V rows and
        samples the first generated token under ``key`` (2,). Returns
        ``(token (device int32 scalar), new key (1, 2), cache)``."""
        key = np.zeros(2, np.uint32) if key is None else key
        logits, cache = self.model.prefill_paged(
            cache, self._ids(pages, upload), self._ids(tokens, upload),
            int(start), int(length), int(trash))
        toks, new_key = sample_tokens(
            logits[None], [temperature], [top_k], [top_p],
            np.asarray(key, np.uint32).reshape(1, 2), bias, upload)
        return toks[0], new_key, cache

    @torch.inference_mode()
    def decode(self, cache, tokens, positions, page_map, temps, top_ks,
               top_ps, keys, bias=None, upload=None):
        """One decode step for every slot with its sampling parameters and
        key (host arrays (S,) and (S, 2)) -> ``(next token per slot (S,)
        device int32, new keys (S, 2) host words, cache)``. With
        ``upload`` nothing in the call waits for the device."""
        logits, cache = self.model.decode_step_paged(
            cache, self._ids(tokens, upload), self._ids(positions, upload),
            self._ids(page_map, upload))
        toks, new_keys = sample_tokens(logits, temps, top_ks, top_ps, keys,
                                       bias, upload)
        return toks, new_keys, cache


class SpeculativeKernels(_PagedKernels):
    """The kernel set of draft-verified (speculative) generation over two
    paged models with one vocabulary: the ``draft_model`` proposes
    candidates with ordinary decode steps and the ``model`` (the target)
    scores them all in ONE verify forward
    (``Transformer.decode_verify_paged``), whose logits feed the rejection
    sampler (``ops.sampling.speculative_sample``).

    - ``prefill`` / ``chunk``: the target's prompt path, the first token
      drawn with the position-keyed draw (EXTRA_STREAM, output position 0)
      instead of a key split, so a stream is a pure function of its
      request whatever the acceptance history;
    - ``draft_write``: a prompt chunk through the draft (K/V writes only);
    - ``draft``: one draft decode step for every slot, sampled into
      ``(tokens, dists)``; tokens stay on the device, to feed the next
      draft step without a host round trip;
    - ``verify``: the target's step over ``[last token, d_1..d_k]`` plus
      the rejection sampler -> ``(n_accepted, tokens, cache)``.

    Keys are each slot's constant request key; draws fold in the stream
    and the output position. ``bias``, optional, is the grammar mask
    added to the fp32 logits before the sampler: ``(1, V)`` for
    ``prefill``, ``(S, V)`` for ``draft`` (the proposals stay legal) and
    ``(S, k+1, V)`` for ``verify`` (a masked token has target probability
    0, so an illegal proposal is always rejected)."""

    def __init__(self, model, draft_model):
        if not hasattr(draft_model, "decode_step_paged"):
            raise ValueError(
                "speculative decoding needs a PAGED draft model "
                "(decode_step_paged — see nn.Transformer)")
        if getattr(model, "vocab_size", None) != getattr(
                draft_model, "vocab_size", None):
            raise ValueError(
                f"draft and target models must share one vocabulary, got "
                f"{getattr(draft_model, 'vocab_size', None)} vs "
                f"{getattr(model, 'vocab_size', None)}")
        super().__init__(model)
        self.draft_model = draft_model

    @torch.inference_mode()
    def prefill(self, cache, pages, tokens, start: int, length: int,
                trash: int, temperature: float = 0.0, top_k: int = 0,
                top_p: float = 1.0, key=None, bias=None, upload=None):
        """Final (or only) chunk of one prompt through the target; the
        first token is the EXTRA_STREAM draw at output position 0 of
        ``key``. -> ``(token (device int32 scalar), cache)``."""
        key = np.zeros(2, np.uint32) if key is None else key
        logits, cache = self.model.prefill_paged(
            cache, self._ids(pages, upload), self._ids(tokens, upload),
            int(start), int(length), int(trash))
        tok, _ = position_sample(
            logits[None], [temperature], [top_k], [top_p],
            np.asarray(key, np.uint32).reshape(1, 2), EXTRA_STREAM, [0],
            bias)
        return tok[0], cache

    @torch.inference_mode()
    def draft_write(self, dcache, pages, tokens, start: int, length: int,
                    trash: int, upload=None):
        """A prompt chunk through the draft, final or not (the draft never
        samples during prefill). -> draft cache."""
        return self.draft_model.prefill_paged(
            dcache, self._ids(pages, upload), self._ids(tokens, upload),
            int(start), int(length), int(trash), need_logits=False)

    @torch.inference_mode()
    def draft(self, dcache, tokens, positions, page_map, temps, top_ks,
              top_ps, keys, out_pos, bias=None):
        """One draft decode step for every slot (``tokens`` a host array or
        the previous draft step's device tensor) -> ``(tokens (S,) device
        int32, dists (S, V), draft cache)``."""
        logits, dcache = self.draft_model.decode_step_paged(
            dcache, self._ids(tokens), self._ids(positions),
            self._ids(page_map))
        toks, dists = draft_sample(logits, temps, top_ks, top_ps, keys,
                                   out_pos, bias)
        return toks, dists, dcache

    @torch.inference_mode()
    def verify(self, cache, last_tokens, draft_tokens, positions, page_map,
               trash: int, temps, top_ks, top_ps, keys, out_base,
               draft_dists, bias=None):
        """The target's verify forward and the rejection sampler.
        ``draft_tokens`` / ``draft_dists`` are the k draft steps' outputs.
        -> ``(n_accepted (S,), tokens (S, k+1), cache)`` on the device."""
        d_tokens = torch.stack([self._ids(t) for t in draft_tokens], dim=1)
        tokens = torch.cat([self._ids(last_tokens)[:, None], d_tokens],
                           dim=1)
        logits, cache = self.model.decode_verify_paged(
            cache, tokens, self._ids(positions), self._ids(page_map),
            int(trash))
        if bias is not None:
            logits = biased_logits(logits, bias)
        n_acc, out = speculative_sample(
            logits, d_tokens, torch.stack(list(draft_dists), dim=1), temps,
            top_ks, top_ps, keys, out_base)
        return n_acc, out, cache


class GenerationStream:
    """Iterator-future for one generation request: iterate for tokens as
    they arrive (then the terminal error, if any), or block on
    :meth:`result`. :meth:`cancel` retires the request at the next step
    boundary (the stream then ends with :class:`StreamCancelled`).
    :meth:`add_done_callback` runs a function once the stream finishes
    (at once if it has). ``t_first`` / ``t_done`` are the monotonic times
    of the first token and the finish; ``ttft_s`` is submit to first
    token. ``trace`` is the request's
    :class:`~bigdl_tpu_torch.obs.trace.RequestTrace` when the engine has a
    tracer, else None."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tokens: List[int] = []
        self._q: "_queue.SimpleQueue" = _queue.SimpleQueue()
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        self._cancelled = False
        self._callbacks: List[Callable[["GenerationStream"], None]] = []
        self.t_submit = time.monotonic()
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None
        # the request's trace (obs.RequestTrace); riding the stream, it
        # needs no signature of its own anywhere the stream is passed
        self.trace = None

    def _push(self, token: int, now: Optional[float] = None) -> None:
        with self._lock:
            if self.t_first is None:
                self.t_first = time.monotonic() if now is None else now
            self._tokens.append(token)
        self._q.put(token)

    def _finish(self, error: Optional[BaseException] = None,
                now: Optional[float] = None) -> None:
        with self._lock:
            if self._done.is_set():
                return
            self._error = error
            self.t_done = time.monotonic() if now is None else now
            callbacks = list(self._callbacks)
            self._done.set()
        self._q.put(_SENTINEL)
        for cb in callbacks:
            try:
                cb(self)
            except Exception:
                log.exception("GenerationStream done-callback failed")

    def add_done_callback(
            self, fn: Callable[["GenerationStream"], None]) -> None:
        """Call ``fn(stream)`` once the stream is done (now, if it is)."""
        with self._lock:
            if not self._done.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def _raise_error(self):
        # a fresh copy per raise (constructor bypassed, attributes kept):
        # the stored error may be raised again on other threads, and a
        # raise mutates the raised object's __traceback__
        err = self._error
        fresh = type(err).__new__(type(err), *err.args)
        fresh.__dict__.update(err.__dict__)
        fresh.__cause__ = err.__cause__
        raise fresh

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                if self._error is not None:
                    self._raise_error()
                return
            yield item

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the stream finishes; the full token list (raises
        the stream's terminal error instead)."""
        if not self._done.wait(timeout):
            raise TimeoutError("generation stream did not finish in time")
        if self._error is not None:
            self._raise_error()
        return list(self._tokens)

    def cancel(self) -> None:
        self._cancelled = True

    @property
    def tokens(self) -> List[int]:
        with self._lock:
            return list(self._tokens)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    @property
    def ttft_s(self) -> Optional[float]:
        """Submit to first token, seconds (None before the first token)."""
        return None if self.t_first is None else self.t_first - self.t_submit


class _GenRequest:
    __slots__ = ("prompt", "max_new_tokens", "deadline", "stream",
                 "temperature", "top_k", "top_p", "seed", "tag", "handoff",
                 "priority", "grammar")

    def __init__(self, prompt: List[int], max_new_tokens: int,
                 deadline: Optional[float], stream: GenerationStream,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: Optional[int] = None,
                 tag: Any = None, handoff: Optional[dict] = None,
                 priority: int = 0, grammar=None):
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.deadline = deadline
        self.stream = stream
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.seed = seed
        self.tag = tag            # opaque caller context, rides a swap
        self.handoff = handoff    # a handoff or swap-in payload
        self.priority = int(priority)
        self.grammar = grammar    # a compiled TokenAutomaton, or None

    @property
    def sampled(self) -> bool:
        return self.temperature > 0.0


class _SlotState:
    """Host bookkeeping for one occupied slot: admitted in phase
    "prefill", flipped to "decode" once the final prompt chunk has run."""

    __slots__ = ("req", "last_token", "position", "generated", "phase",
                 "pages", "page_row", "prefill_pos", "draft_pages",
                 "dpage_row", "cache_version", "t_last", "grammar_state",
                 "grammar_error", "t_admit")

    def __init__(self, req: _GenRequest, pages: List[int], page_row,
                 pad_id: int, draft_pages: Optional[List[int]] = None,
                 dpage_row=None, t_admit: Optional[float] = None):
        self.req = req
        self.t_admit = time.monotonic() if t_admit is None else t_admit
        self.last_token = pad_id
        self.position = 0          # cache row the NEXT token writes
        self.generated = 0
        self.phase = "prefill"
        self.pages: Optional[List[int]] = pages
        self.page_row = page_row   # (ppn,) int32 map row
        self.prefill_pos = 0       # next prompt index to prefill
        self.draft_pages = draft_pages   # the draft's lane (speculative)
        self.dpage_row = dpage_row
        self.cache_version = 0     # prefix-index version at admission
        self.t_last = 0.0          # when its last token was pushed
        self.grammar_state: Optional[int] = None   # automaton state
        self.grammar_error: Optional[GrammarViolation] = None


class _StepTicket:
    """One in-flight async decode step: what the landing needs.
    ``parts`` pins the ``(slot, _SlotState)`` pairs the step computed for:
    at the landing, a participant whose slot no longer maps to the same
    state (retired, swapped out, re-admitted) is skipped, and its token is
    the discarded rider token of the one-step lag. ``positions`` are the
    dispatched (clamped) positions, ``keys`` every slot's key after the
    step's split (host words), ``toks`` the tokens (a pinned host buffer
    the device fills behind ``event`` on a card; the step's own tensor on
    the CPU)."""

    __slots__ = ("parts", "positions", "toks", "keys", "event")

    def __init__(self, parts: List[Tuple[int, "_SlotState"]],
                 positions: np.ndarray, toks: torch.Tensor,
                 keys: np.ndarray, event):
        self.parts = parts
        self.positions = positions
        self.toks = toks
        self.keys = keys
        self.event = event

    def land(self) -> np.ndarray:
        """Wait for the step's tokens (the only device wait of an async
        iteration) and return them as host int32 (S,)."""
        if self.event is not None:
            self.event.synchronize()
        return self.toks.numpy().copy()


class _Core:
    """State shared between the engine facade and the loop thread:
    request bookkeeping only, so the loop can fail every stream and exit
    even after the facade (model, cache) has been collected."""

    __slots__ = ("lock", "wake", "pending", "active", "free", "closed",
                 "drain", "staged")

    def __init__(self, max_slots: int):
        self.lock = threading.RLock()
        # the idle loop blocks on this; submit, close and the engine's
        # collection each put one token. ``SimpleQueue.put`` takes no
        # Python-level lock, so the collection's finalizer, which the
        # garbage collector may run on any thread at any allocation (one
        # made while that thread holds some lock included), can wake the
        # loop without acquiring a lock there
        self.wake: "_queue.SimpleQueue[None]" = _queue.SimpleQueue()
        self.pending: "deque[_GenRequest]" = deque()
        self.active: Dict[int, _SlotState] = {}
        self.free: List[int] = list(range(max_slots))
        self.closed = False
        self.drain = True
        # a reload's new weights, staged on the device: the loop copies
        # them in at the top of its next iteration
        self.staged: Optional[Tuple[Dict[str, torch.Tensor], Any]] = None


def _fail_streams(core: _Core, error: BaseException,
                  engine: "Optional[GenerationEngine]" = None) -> None:
    """Fail every pending/active stream; with the engine still alive,
    return the active slots' pages to the pool and drain the prefix index
    and the host tier, so every gauge reaches zero. Called only from the
    loop thread or after it has exited."""
    with core.lock:
        reqs = list(core.pending) + [s.req for s in core.active.values()]
        states = list(core.active.items())
        core.pending.clear()
        core.free.extend(core.active.keys())
        core.active.clear()
    if engine is not None:
        for slot, st in states:
            engine._release_lanes(slot, st)
        for cache in (engine._prefix, engine._dprefix):
            if cache is not None:
                cache.clear()
        if engine._host is not None:
            # copies in flight drop (their pages were evicted cleanly)
            engine._pending_offloads.clear()
            engine._copier.reset()
            engine._host.clear()
        engine._report_pages()
    for r in reqs:
        _fail_request(r, error)


def _fail_request(req: _GenRequest, error: BaseException) -> None:
    req.stream._finish(error)
    tr = req.stream.trace
    if tr is not None and not tr.done:
        tr.finish(outcome="failed", error=type(error).__name__)


def _engine_loop(engine_ref: "weakref.ref[GenerationEngine]",
                 core: _Core) -> None:
    """Loop thread body. Holds only a weak ref to the engine while idle,
    so an engine whose owner forgot ``close()`` is collectable (an engine
    with a stall watchdog must be closed: the watchdog holds it)."""
    try:
        _engine_loop_body(engine_ref, core)
    finally:
        # the loop retires the watchdog: close() leaves it to a loop
        # still stuck in a step past its join timeout
        engine = engine_ref()
        if engine is not None and engine._watchdog is not None:
            engine._watchdog.close(timeout=0)


def _engine_loop_body(engine_ref: "weakref.ref[GenerationEngine]",
                      core: _Core) -> None:
    while True:
        with core.lock:
            idle = (not core.pending and not core.active and not core.closed
                    and core.staged is None)
        if idle and engine_ref() is not None:
            core.wake.get()   # submit, close and GC each put a token
            continue
        with core.lock:
            if core.closed:
                if not core.drain:
                    _fail_streams(core, RuntimeError(
                        "generation engine closed before request ran"),
                        engine_ref())
                    return
                if not core.pending and not core.active:
                    return
        engine = engine_ref()
        if engine is None:
            _fail_streams(core, RuntimeError(
                "generation engine was garbage-collected with requests in "
                "flight"))
            return
        if engine._failed is not None:
            # the watchdog fired while a step was stuck and has failed the
            # streams; the loop thread, the only one that may touch slots
            # and pages, reconciles them now and stops
            _fail_streams(core, engine._failed, engine)
            return
        wd = engine._watchdog
        if wd is not None:
            wd.arm("decode step")
        try:
            # a reload's weights and its prefix flush land between
            # iterations, before any admission probes the index
            engine._apply_reload()
            engine._maybe_flush_prefix()
            with core.lock:
                work = bool(core.pending or core.active)
            if work:
                engine._step()
        except Exception as e:
            # a broken step cannot be retried (the cache may be half
            # written): fail every stream loudly and stop the loop
            engine._failed = e
            log.exception("generation engine step failed; engine stopped")
            _fail_streams(core, e, engine)
            return
        finally:
            if wd is not None:
                wd.disarm()
        del engine


def _notify_core(core: _Core) -> None:
    """``weakref.finalize`` hook: wake the idle loop when the engine is
    collected, so it observes the dead weakref and exits. Takes no lock:
    see ``_Core.wake``."""
    core.wake.put(None)


class GenerationEngine:
    """Continuous-batching generation over a paged language model
    (``nn.layers.attention.Transformer``).

    ``submit(prompt, max_new_tokens=..., deadline=..., temperature=...,
    top_k=..., top_p=..., seed=..., grammar=...)`` returns a
    :class:`GenerationStream`.
    ``warmup()`` runs every kernel shape once (and, on a card, builds the
    CUDA kernels) before traffic. ``device`` defaults to ``"cuda"`` and
    must be where the model's parameters are. ``quantize="int8"`` serves
    an int8 copy of ``model`` (and of the draft); without it the engine
    serves its own copy, unless ``kernels`` are given (they run the model
    they were built over), so the caller's models are untouched; ``cache_dtype=torch.int8`` keeps int8 KV pages with
    per-token fp32 scales. ``seed`` is the engine's base seed for the
    requests that name none. ``speculate=(draft_model, k)`` serves
    draft-verified: k candidates per round from ``draft_model``, one
    verify forward of ``model``. ``prefix_cache=True`` shares full prompt
    pages across requests through a radix index, and
    ``cache_aware_admission=True`` lets a later request that fits pass a
    page-blocked head (at most 4 times in a row). ``host_pages=N`` backs
    the device pool with N pages of host memory (needs the prefix cache;
    excludes speculation): evicted prefix pages offload there and come
    back on a later hit, and a page-blocked request may swap out active
    streams of strictly lower ``priority``. ``role="prefill"`` /
    ``"decode"`` split the engine for disaggregation (see
    ``serving.disagg.DisaggregatedEngine``; excludes speculation, and
    the decode role takes neither the prefix cache nor the host tier).
    ``submit(grammar=...)`` constrains a stream to a grammar.
    ``metrics`` is the sink the engine reports to (a fresh
    :class:`ServingMetrics` by default).

    ``tracer`` (an ``obs.Tracer``) gives every request a trace on its
    stream (None, the default, costs one ``is None`` test a request and an
    attribute load a step); ``timeline_capacity`` bounds the always-on
    ``engine.timeline``; ``profile_dir`` records a ``torch.profiler``
    trace of the first ``profile_iters`` iterations there
    (``export_chrome_trace``). ``stall_timeout`` (seconds) watches every
    iteration: one that makes no progress for that long fails every
    stream with ``StallError`` and stops the engine (such an engine must
    be closed). ``async_scheduling=True`` overlaps the host's work with
    the decode step in flight (not for a speculative engine, which keeps
    the synchronous path); the streams are the same.
    """

    def __init__(self, model, *, device: DeviceLike = None,
                 max_slots: int = 8, max_len: int = 256,
                 max_prompt_len: Optional[int] = None,
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 max_queue: int = 64,
                 cache_dtype: torch.dtype = torch.float32,
                 kernels=None,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 quantize: Optional[str] = None, seed: int = 0,
                 speculate: Optional[tuple] = None,
                 prefix_cache: bool = False,
                 cache_aware_admission: bool = False,
                 host_pages: Optional[int] = None,
                 role: str = "both",
                 metrics: Optional[ServingMetrics] = None,
                 stall_timeout: Optional[float] = None,
                 tracer=None,
                 timeline_capacity: int = 512,
                 profile_dir: Optional[str] = None,
                 profile_iters: int = 10,
                 async_scheduling: bool = False):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        if max_len < 2:
            raise ValueError("max_len must be >= 2 (prompt + 1 token)")
        if role not in ("both", "prefill", "decode"):
            raise ValueError(
                f"role must be 'both', 'prefill' or 'decode', got {role!r}")
        self.device = module_device(model, device)
        self.speculative = speculate is not None
        self.draft_model, self.spec_k = _speculate_knob(speculate)
        self.prefix_caching = bool(prefix_cache)
        self.cache_aware_admission = bool(cache_aware_admission)
        # paged unless the kernels or the model say dense: given kernels
        # pick by their chunk step; otherwise paged whenever the model
        # speaks the paged API and page_size is set (the dense lanes are
        # the JAX package's baseline, kept for bit-identity and for
        # models with a plain cache)
        self.paged = (hasattr(kernels, "chunk") if kernels is not None
                      else bool(page_size)
                      and hasattr(model, "decode_step_paged"))
        if not self.paged:
            _check_dense_knobs(self.speculative, cache_dtype, role,
                               host_pages, self.prefix_caching)
        # prefill/decode disaggregation: role="prefill" runs only the
        # prompt calls, and a prompt's final chunk hands the finished
        # pages to ``_handoff_cb`` (set by DisaggregatedEngine or
        # PrefillWorker) instead of decoding; role="decode" runs only the
        # decode step and admits through ``submit_prefilled``, scattering
        # the pages into its own pool. role="both" is the monolithic
        # engine
        self.role = role
        self._handoff_cb: Optional[Callable[[dict], None]] = None
        if role != "both":
            if self.speculative:
                raise ValueError(
                    "role='prefill'/'decode' excludes speculative decoding "
                    "(draft-lane pages do not cross the handoff yet)")
            if role == "decode" and self.prefix_caching:
                raise ValueError(
                    "the prefix index lives with the prefill role (pages "
                    "are published where prompts are written); pass "
                    "prefix_cache=True to the prefill engine instead")
        if host_pages is not None:
            if self.speculative:
                raise ValueError(
                    "host_pages excludes speculative decoding (draft-"
                    "lane pages do not offload yet)")
            if role == "decode":
                raise ValueError(
                    "the host tier lives with the prefix index "
                    "(prefill/both roles: pages offload where prompts "
                    "are written); pass host_pages to the prefill "
                    "engine instead")
            if not self.prefix_caching:
                raise ValueError(
                    "host_pages needs prefix_cache=True — the host tier "
                    "is indexed by the same (version, prefix) radix keys "
                    "the device prefix index files pages under")
        if kernels is not None and hasattr(kernels, "verify") \
                != self.speculative:
            # half of either is a silent wrong-mode engine
            raise ValueError(
                "speculate=(draft_model, k) and SpeculativeKernels go "
                "together: pass both or neither")
        model = _serving_model(model, quantize, kernels)
        self.quantize = quantize
        # reload() sets it; the loop clears the prefix index and the host
        # tier before its next admission
        self._prefix_flush = False
        if self.speculative:
            module_device(self.draft_model, device)
            self.draft_model = _serving_model(self.draft_model, quantize,
                                              kernels)
        self.model = model
        self.max_slots = int(max_slots)
        self.max_len = int(max_len)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.pad_id = int(pad_id)
        self.max_queue = int(max_queue)
        self.seed = int(seed)
        self.metrics = metrics if metrics is not None else ServingMetrics()
        # chunked prefill lifts the paged engine's prompt-length wall;
        # dense lanes take a prompt in one call
        self.max_prompt_len = int(max_prompt_len or (
            max_len - 1 if self.paged else max(1, max_len // 2)))
        if not 1 <= self.max_prompt_len < self.max_len:
            raise ValueError(
                f"max_prompt_len {self.max_prompt_len} must be in "
                f"[1, max_len) = [1, {self.max_len})")
        self.cache_dtype_name = _dtype_name(cache_dtype)
        # a speculative slot reserves a target lane and a draft lane
        self._lanes = 2 if self.speculative else 1
        self._pool: Optional[PagePool] = None
        self._bias: Optional[np.ndarray] = None
        self._keys = np.zeros((self.max_slots, 2), np.uint32)
        vocab = getattr(model, "vocab_size", None)
        if self.paged:
            self._init_paged(model, kernels, page_size, num_pages,
                             prefill_chunk, cache_dtype, vocab)
        else:
            self.prompt_buckets = bucket_sizes_for(self.max_prompt_len)
            self.kernels = kernels or DecodeKernels(model)
            self._cache = model.init_cache(self.max_slots, self.max_len,
                                           cache_dtype)
            self._stage = _HostStage(
                self.device,
                _stage_bytes(self.max_slots, 0, None,
                             self.prompt_buckets[-1]),
                depth=self.max_slots + 3)
        self.metrics.set_quantized_gemms(
            count_quantized_gemms(self.kernels.model))
        # the grammar keys this engine has served: a submit whose key is
        # here reused the compiled automaton (grammar_compile_cache_hits)
        self._grammars: set = set()
        # the prefix index, one per lane: the draft's pages hold other K/V
        # for the same tokens and are never shared across lanes
        self._prefix: Optional[PrefixCache] = None
        self._dprefix: Optional[PrefixCache] = None
        if self.prefix_caching:
            self._prefix = PrefixCache(self._pool, name="target")
            if self.speculative:
                self._dprefix = PrefixCache(self._pool, name="draft")
        # True after an eviction scan freed nothing; cleared whenever pages
        # release or publish, so a page-blocked head does not re-walk the
        # index every iteration
        self._evict_stale = False
        self._bypass_limit = 4
        self._head_bypasses = 0      # consecutive bypasses of the head
        self.admission_bypasses = 0
        # the host tier: device -> host copies in flight (at most
        # _offload_inflight_cap prefix pages; the staging ring holds that
        # many blocks), polled at the top of every iteration
        self._host: Optional[HostPageStore] = None
        self._mover: Optional[PageBlockMover] = None
        self._copier: Optional[HostCopier] = None
        self._pending_offloads: List[dict] = []
        self._offload_inflight_cap = 2
        self._swap_seq = 0
        # the namespace of this engine's exported pages: an adopting pool
        # dedups on (source, page, generation), so two engines' page ids
        # never alias
        self.handoff_source = f"{role}-{uuid.uuid4().hex[:12]}"
        if host_pages is not None or role != "both":
            # the prefill role gathers handed-off pages; the decode role
            # uploads a host block (the PrefillWorker path) and scatters.
            # Imported here: disagg.py imports this module at its top
            from bigdl_tpu_torch.serving.disagg import PageBlockMover

            self._mover = PageBlockMover()
        ppn = self._pool.pages_per_slot if self.paged else 0
        if host_pages is not None:
            self._host = HostPageStore(int(host_pages),
                                       page_bytes=self._kv_page_bytes)
            self._copier = HostCopier(self._cache,
                                      slots=self._offload_inflight_cap,
                                      slot_pages=ppn)
        elif role == "decode":
            self._copier = HostCopier(self._cache, slots=0, slot_pages=ppn)
        self._report_pages()
        # the observability plane: an optional per-request tracer, the
        # always-on step timeline, an optional profiler bracket
        self.tracer = tracer
        self.timeline = StepTimeline(timeline_capacity)
        self._profile_dir = profile_dir
        self._profile_iters = int(profile_iters)
        self._profile_state = 0   # 0 armed or off, 1 recording, 2 done
        self._profile_count = 0
        self._profiler = None
        self._failed: Optional[BaseException] = None
        self._core = _Core(self.max_slots)
        self._watchdog: Optional[Watchdog] = None
        if stall_timeout is not None:
            self._watchdog = Watchdog(f"engine@{id(self):x}", stall_timeout,
                                      self._on_stall)
        # async scheduling: the live per-slot dispatch inputs (arming and
        # landing write them; a dispatch stages a copy), the rows armed
        # since the last dispatch (a landing must not fold a stale ticket
        # over them), the ticket in flight, and the pinned buffer its
        # tokens land in
        self.async_scheduling = bool(async_scheduling)
        self._async = self.async_scheduling and not self.speculative
        self._inflight: Optional[_StepTicket] = None
        self._step_tokens = np.zeros((self.max_slots,), np.int32)
        self._step_positions = np.zeros((self.max_slots,), np.int32)
        self._armed_dirty: set = set()
        self._land_event = None
        self._land_tokens: Optional[torch.Tensor] = None
        if self._async and self.device.type == "cuda":
            self._land_tokens = torch.empty((self.max_slots,),
                                            dtype=torch.int32,
                                            pin_memory=True)
            self._land_event = torch.cuda.Event()
        if kernels is not None:
            _SERVED_IN_PLACE.setdefault(self.kernels.model,
                                        weakref.WeakSet()).add(self)
        weakref.finalize(self, _notify_core, self._core)
        self._thread = threading.Thread(
            target=_engine_loop, args=(weakref.ref(self), self._core),
            name="bigdl-serving-engine", daemon=True)
        self._thread.start()

    def _init_paged(self, model, kernels, page_size, num_pages,
                    prefill_chunk, cache_dtype, vocab) -> None:
        """The paged engine's pool, kernels, pages and per-slot step
        inputs."""
        self.page_size = int(page_size)
        self.prefill_chunk = int(prefill_chunk
                                 or min(64, self.max_prompt_len))
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.prompt_buckets = bucket_sizes_for(
            min(self.max_prompt_len, self.prefill_chunk))
        ppn = pages_per_lane(self.max_len, self.page_size)
        self.num_pages = int(num_pages
                             or self.max_slots * ppn * self._lanes)
        self._pool = PagePool(self.num_pages, self.page_size, self.max_len)
        if kernels is None:
            kernels = (SpeculativeKernels(model, self.draft_model)
                       if self.speculative else PagedDecodeKernels(model))
        self.kernels = kernels
        self._cache = model.init_paged_cache(self.num_pages + 1,
                                             self.page_size, cache_dtype)
        # what one reserved page costs across all layers, scale pools
        # included: the kv_bytes_in_use gauge
        self._kv_page_bytes = _lane_page_bytes(model, self.page_size,
                                               cache_dtype)
        # the decode step's inputs; rows change on admission/retirement.
        # A plain engine's keys evolve by one split per step; a
        # speculative engine's stay each slot's request key (its draws
        # fold in the output position)
        self._page_map = np.full((self.max_slots, ppn), self._pool.trash,
                                 np.int32)
        self._temps = np.zeros((self.max_slots,), np.float32)
        self._top_ks = np.zeros((self.max_slots,), np.int32)
        self._top_ps = np.ones((self.max_slots,), np.float32)
        # grammar-constrained decoding: one additive mask row per slot,
        # all-zero (a no-op) for unconstrained and idle slots. A step
        # with no constrained slot passes no bias at all
        if vocab:
            self._bias = np.zeros((self.max_slots, int(vocab)), np.float32)
        # every kernel call's host inputs go up through this ring; one
        # iteration makes at most a prompt call per slot and a decode step
        # (or k+1 draft steps), so a slot is refilled only after its
        # copies have run
        self._stage = _HostStage(
            self.device,
            _stage_bytes(self.max_slots, ppn, vocab,
                         max(self.prefill_chunk, self.prompt_buckets[-1])),
            depth=self.max_slots + self.spec_k + 3)
        if self.speculative:
            self._dcache = self.draft_model.init_paged_cache(
                self.num_pages + 1, self.page_size, cache_dtype)
            self._dpage_map = np.full((self.max_slots, ppn),
                                      self._pool.trash, np.int32)
            self._kv_dpage_bytes = _lane_page_bytes(
                self.draft_model, self.page_size, cache_dtype)

    # ------------------------------------------------------ submission ----

    def submit(self, prompt: Sequence[int], *,
               max_new_tokens: Optional[int] = None,
               deadline: Optional[float] = None,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0,
               seed: Optional[int] = None,
               tag: Any = None,
               priority: int = 0,
               grammar=None) -> GenerationStream:
        """Enqueue one prompt (token ids). ``max_new_tokens`` caps the
        generation (default: whatever fits in ``max_len``); ``deadline``
        is seconds from now. Raises :class:`Overloaded` when the pending
        queue is full. ``tag`` is opaque caller context that rides the
        request (a swap's payload included). ``priority`` matters on a
        host-tier engine only: a page-blocked head may swap out active
        streams of strictly lower priority; equal priorities never
        displace each other.

        ``temperature > 0`` samples inside the step, optionally filtered
        by ``top_k`` / nucleus ``top_p``; ``temperature=0`` (default) is
        greedy argmax. The stream's key defaults to a pure function of
        the engine's seed and the prompt, so sampled output is the same
        across runs and admission orders; ``seed`` gives byte-identical
        prompts distinct streams.

        ``grammar`` is a compiled
        :class:`~bigdl_tpu_torch.grammar.TokenAutomaton` over this model's
        vocabulary and ``eos_id``: every token of the stream is then
        sampled under the automaton's current-state mask (greedy is the
        argmax over the legal tokens), the state advances on the host per
        emitted token, and a stream that cannot reach a parse (its budget
        runs out mid-grammar, or a stuck state) fails with
        :class:`GrammarViolation`. Monolithic (role='both') engines only."""
        if self.role == "decode":
            raise RuntimeError(
                "a decode-role engine admits only prefilled requests "
                "(pages already materialized) — use submit_prefilled()")
        temperature = float(temperature)
        check_temperature(temperature)
        if temperature > 0.0 and not self.paged:
            raise ValueError(
                "sampling (temperature > 0) needs the paged engine — the "
                "dense DecodeKernels path is the greedy baseline")
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) > self.max_prompt_len:
            raise ValueError(f"prompt length {len(prompt)} exceeds "
                             f"max_prompt_len {self.max_prompt_len}")
        if grammar is not None:
            self._check_grammar(grammar)
        room = self.max_len - len(prompt)
        mnt = room if max_new_tokens is None else min(int(max_new_tokens),
                                                      room)
        if mnt < 1:
            raise ValueError("no room to generate even one token")
        if self.paged:
            # a prefill-role engine reserves prompt pages only: the
            # generation budget is the decode pool's
            need = self._lanes * self._pool.pages_for(
                len(prompt) if self.role == "prefill"
                else min(len(prompt) + mnt - 1, self.max_len))
            if need > self.num_pages:
                # a reservation the pool can never satisfy would block the
                # FIFO head forever: reject it on the caller's thread
                raise ValueError(
                    f"request needs {need} KV pages but the pool holds "
                    f"{self.num_pages}; shrink the prompt/max_new_tokens "
                    f"or grow num_pages")
        stream = GenerationStream()
        # the trace attaches before the request can reach the loop thread
        # (admission reads stream.trace); tracer=None costs this test only
        stream.trace = submit_trace(self.tracer, "generate",
                                    prompt_len=len(prompt),
                                    max_new_tokens=mnt,
                                    sampled=temperature > 0.0)
        req = _GenRequest(prompt, mnt,
                          None if deadline is None
                          else stream.t_submit + float(deadline), stream,
                          temperature=temperature, top_k=int(top_k),
                          top_p=float(top_p),
                          seed=None if seed is None else int(seed),
                          tag=tag, priority=int(priority), grammar=grammar)
        self._enqueue(req, grammar)
        return stream

    def _check_grammar(self, grammar) -> None:
        if not self.paged:
            raise ValueError(
                "grammar-constrained decoding needs the paged engine "
                "(the mask rides the in-step sampler)")
        if self._bias is None:
            raise ValueError(
                "grammar-constrained decoding needs a model exposing "
                "vocab_size (the per-slot mask is (S, vocab))")
        if self.role != "both":
            raise ValueError(
                "grammar-constrained decoding does not cross the "
                "prefill/decode handoff yet — submit to a monolithic "
                "(role='both') engine")
        if not hasattr(grammar, "bias_row"):
            raise TypeError(
                "grammar must be a compiled TokenAutomaton — build one "
                "with grammar.compile_grammar(regex_grammar(...) or "
                "json_schema_grammar(...), vocab, eos_id)")
        if grammar.vocab_size != self._bias.shape[1]:
            raise ValueError(
                f"grammar compiled over a {grammar.vocab_size}-token "
                f"vocabulary, model has {self._bias.shape[1]}")
        if grammar.eos_id != self.eos_id:
            raise ValueError(
                f"grammar compiled with eos_id={grammar.eos_id}, engine "
                f"has eos_id={self.eos_id} — the EOS mask column is how a "
                f"constrained stream terminates")

    def _enqueue(self, req: _GenRequest, grammar=None) -> None:
        core = self._core
        tr = req.stream.trace if req.handoff is None else None
        try:
            with core.lock:
                if self._failed is not None:
                    raise RuntimeError(
                        "generation engine stopped after a step failure"
                    ) from self._failed
                if core.closed:
                    raise RuntimeError("generation engine is closed")
                if len(core.pending) >= self.max_queue:
                    self.metrics.record_rejected()
                    raise Overloaded(len(core.pending), self.max_queue)
                if tr is not None:
                    # before the enqueue: once the loop thread sees the
                    # request it may run and finish the trace
                    tr.event("submit", queue_depth=len(core.pending) + 1)
                if grammar is not None:
                    # a key this engine has served: the compiled automaton
                    # was reused rather than built again
                    if grammar.key in self._grammars:
                        self.metrics.record_grammar_cache_hit()
                    else:
                        self._grammars.add(grammar.key)
                core.pending.append(req)
                depth = len(core.pending)
                core.wake.put(None)
        except BaseException:
            if tr is not None:
                tr.finish(outcome="rejected")
            raise
        self.metrics.set_queue_depth(depth)

    def submit_prefilled(self, payload: dict, *,
                         stream: Optional[GenerationStream] = None
                         ) -> GenerationStream:
        """Enqueue a request whose prompt a prefill-role engine already
        ran (decode-role engines only). ``payload`` is what that engine's
        handoff produced: the prompt, the first token, the key after the
        first token's split, the sampling parameters, the page manifest
        and the gathered KV block (device tensors, or host tensors on the
        PrefillWorker path). Admission adopts the prompt pages into this
        pool (a shared prefix page dedups to one local copy), scatters
        the block, pushes the first token and decodes on: the stream is
        the monolithic engine's, token for token.

        ``payload["deadline"]`` is absolute ``time.monotonic()`` time.
        ``stream`` continues an existing consumer-facing stream (the
        front door's); without it a fresh one is returned."""
        if self.role != "decode":
            raise RuntimeError(
                "submit_prefilled() needs a role='decode' engine — "
                "monolithic engines prefill their own prompts")
        prompt = [int(t) for t in np.asarray(payload["prompt"]).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt in handoff payload")
        mnt = int(payload["max_new_tokens"])
        if mnt < 1:
            raise ValueError("handoff payload has no generation budget")
        need = self._pool.pages_for(min(len(prompt) + mnt - 1, self.max_len))
        if need > self.num_pages:
            raise ValueError(
                f"request needs {need} KV pages but the decode pool holds "
                f"{self.num_pages}; shrink the prompt/max_new_tokens or "
                f"grow num_pages")
        stream = stream or GenerationStream()
        deadline = payload.get("deadline")
        req = _GenRequest(prompt, mnt,
                          None if deadline is None else float(deadline),
                          stream,
                          temperature=float(payload.get("temperature", 0.0)),
                          top_k=int(payload.get("top_k", 0)),
                          top_p=float(payload.get("top_p", 1.0)),
                          handoff=payload,
                          priority=int(payload.get("priority", 0)))
        self._enqueue(req)
        return stream

    def generate(self, prompt: Sequence[int], *,
                 timeout: Optional[float] = None, **knobs) -> List[int]:
        """Blocking convenience: ``submit(prompt, **knobs).result(timeout)``."""
        return self.submit(prompt, **knobs).result(timeout)

    def _on_stall(self, err: StallError) -> None:
        """Watchdog callback (on the watchdog's thread): the loop is stuck
        in a step past the deadline. Mark the engine failed, so submits
        are refused, and finish every pending and active stream with the
        diagnostic, so their consumers unblock. Slots and pages are left
        to the loop thread, the only one that may touch them: it
        reconciles them when the stuck step returns."""
        core = self._core
        with core.lock:
            if self._failed is not None:
                return
            self._failed = err
            reqs = list(core.pending)
            streams = [st.req.stream for st in core.active.values()]
            core.pending.clear()
            core.wake.put(None)
        log.error("generation engine stalled: %s", err)
        for r in reqs:
            r.stream._finish(err)
        for s in streams:
            s._finish(err)

    # ------------------------------------------------- loop internals ----
    # Everything below runs on the loop thread only (except warmup, which
    # the caller runs before traffic).

    def _step(self) -> None:
        """One scheduler iteration: reap the host copies that have landed,
        admit pending prompts into free slots (evicting cached prefixes,
        then bypassing or swapping, before the FIFO wait), advance one
        chunk per prefilling slot, then one decode step (or one
        speculative round) over every decoding slot. The iteration lands
        one row in the step timeline and in the metrics' step keys.

        With ``async_scheduling`` (and no speculation) the iteration runs
        :meth:`_step_async` instead."""
        if self._async:
            return self._step_async()
        t_iter = time.monotonic()
        self._profile_tick()
        core = self._core
        if self._pending_offloads:
            # a non-blocking poll: a copy still in flight waits for the
            # next iteration, never a decode step
            self._drain_offloads()
        decode_s = verify_s = 0.0
        prefill_s = self._admit_and_prefill()
        with core.lock:
            active = sorted((s, st) for s, st in core.active.items()
                            if st.phase == "decode")
        if active:
            t0 = time.monotonic()
            if self.speculative:
                self._speculative_round(active)
                verify_s = time.monotonic() - t0
            else:
                self._decode_once(active)
                decode_s = time.monotonic() - t0
        device_s = prefill_s + decode_s + verify_s
        host_s = max(0.0, time.monotonic() - t_iter - device_s)
        self._record_iteration(host_s, prefill_s, decode_s, verify_s)
        self.metrics.record_engine_step(host_s, device_s)

    def _record_iteration(self, host_s: float, prefill_s: float,
                          decode_s: float, verify_s: float = 0.0,
                          step_gap_s: float = 0.0,
                          overlapped_s: float = 0.0) -> None:
        core = self._core
        with core.lock:
            depth = len(core.pending)
            n_active = len(core.active)
        self.timeline.record(
            host_s=host_s, prefill_s=prefill_s, decode_s=decode_s,
            verify_s=verify_s, step_gap_s=step_gap_s,
            host_overlapped_s=overlapped_s, active=n_active,
            queue_depth=depth, occupancy=n_active / self.max_slots,
            pages_in_use=self._pool.in_use if self.paged else 0)

    def _step_async(self) -> None:
        """One async scheduler iteration:

        1. land the in-flight step's tokens (the loop's only device
           wait), fold them into the live dispatch inputs, and advance the
           grammar automata on them, so the next dispatch's masks follow;
        2. dispatch the next decode step at once, before any bookkeeping;
        3. while it runs: deliver the landed tokens, retire, poll the host
           tier's copies, admit, run prompt chunks.

        Decisions lag one step: a slot whose landed token ends it (EOS,
        its budget, its deadline, a cancel) already rides the step
        dispatched at 2. Its token there is discarded at the next landing
        (the participant no longer maps to the same slot state), and its
        K/V write lands in its own, perhaps by then recycled, pages at a
        clamped position: stream order puts that write before any later
        owner's prompt writes, and causal masking hides what those do not
        overwrite. Decode is independent per row (per-slot lanes, per-slot
        keys), so riders cannot perturb a live row: the streams are the
        synchronous engine's, bit for bit."""
        t_iter = time.monotonic()
        self._profile_tick()
        core = self._core
        decode_s = 0.0
        ticket = self._inflight
        toks = None
        t_land_end = None
        if ticket is not None:
            self._inflight = None
            t0 = time.monotonic()
            toks = ticket.land()
            t_land_end = time.monotonic()
            decode_s = t_land_end - t0
            with core.lock:
                live = {slot for slot, st in ticket.parts
                        if core.active.get(slot) is st}
            # fold the landed rows into the live dispatch inputs, except
            # rows armed since the ticket left (a slot retired and
            # re-admitted while its last step was in flight keeps its
            # fresh arming)
            for slot, st in ticket.parts:
                if slot in self._armed_dirty:
                    continue
                self._step_tokens[slot] = toks[slot]
                self._step_positions[slot] = ticket.positions[slot] + 1
                if ticket.keys is not None:
                    self._keys[slot] = ticket.keys[slot]
                if slot in live:
                    # the mask of the next step follows this token; a
                    # retired rider's automaton is left alone
                    self._grammar_step(slot, st, int(toks[slot]))
        with core.lock:
            active = sorted((s, st) for s, st in core.active.items()
                            if st.phase == "decode")
        step_gap_s = 0.0
        t_disp = None
        if active:
            t0 = time.monotonic()
            self._dispatch_decode(active)
            t_disp = time.monotonic()
            if t_land_end is not None:
                # host time between landing step N and dispatching N+1: a
                # lower bound on the device's idle time between them
                step_gap_s = t0 - t_land_end
        self._armed_dirty.clear()
        # the overlap window: everything below runs while the step just
        # dispatched is in flight
        if ticket is not None:
            self._process_landed(ticket, toks)
        if self._pending_offloads:
            self._drain_offloads()
        prefill_s = self._admit_and_prefill()
        t_end = time.monotonic()
        overlapped_s = 0.0
        if t_disp is not None:
            # the iteration's host work under the in-flight step (prompt
            # calls' own waits are not host work)
            overlapped_s = max(0.0, t_end - t_disp - prefill_s)
        device_s = prefill_s + decode_s
        host_s = max(0.0, t_end - t_iter - device_s)
        self._record_iteration(host_s, prefill_s, decode_s,
                               step_gap_s=step_gap_s,
                               overlapped_s=overlapped_s)
        self.metrics.record_engine_step(host_s, device_s,
                                        overlapped=overlapped_s > 0)

    def _dispatch_decode(self, active: List[Tuple[int, _SlotState]]) -> None:
        """Launch one decode step without waiting for it (async path).
        Every input goes up through the staging ring, a copy taken now, so
        the live arrays may change for the next step as soon as this
        returns; the tokens come back into a pinned buffer behind an
        event. Positions clamp at the lane end for rider rows, whose
        writes stay in their own lane."""
        faults.fire("engine.decode", engine=self)
        tokens = np.zeros((self.max_slots,), np.int32)
        positions = np.zeros((self.max_slots,), np.int32)
        for slot, _st in active:
            tokens[slot] = self._step_tokens[slot]
            positions[slot] = min(int(self._step_positions[slot]),
                                  self.max_len - 1)
        keys = None
        with self._stage.call() as put:
            if self.paged:
                toks_dev, keys, self._cache = self.kernels.decode(
                    self._cache, tokens, positions, self._page_map,
                    self._temps, self._top_ks, self._top_ps, self._keys,
                    upload=put, **_masked(self._step_bias(active, put)))
            else:
                toks_dev, self._cache = self.kernels.decode(
                    self._cache, tokens, positions, upload=put)
        event = None
        if self._land_tokens is not None:
            self._land_tokens.copy_(toks_dev, non_blocking=True)
            self._land_event.record(torch.cuda.current_stream(self.device))
            toks_dev, event = self._land_tokens, self._land_event
        self._inflight = _StepTicket(list(active), positions, toks_dev,
                                     keys, event)

    def _arm_async_slot(self, slot: int, st: _SlotState) -> None:
        """Arm a slot's live dispatch inputs (async path) wherever it gets
        its first decodable token: a dense admission, the final prompt
        chunk, a handoff or swap-resume admission. The dispatch reads only these rows (the
        slot state is updated by the landing one step late); marking the
        row dirty keeps an in-flight ticket's landing from folding stale
        output over it."""
        if not self._async:
            return
        self._step_tokens[slot] = st.last_token
        self._step_positions[slot] = st.position
        self._armed_dirty.add(slot)

    def _process_landed(self, ticket: _StepTicket, toks: np.ndarray) -> None:
        """Deliver a landed async step: push tokens, tick traces, record
        ITL, retire: the synchronous step's tail, one step late.
        Participants whose slot no longer maps to the same state are
        skipped: their token is discarded, their stream untouched."""
        core = self._core
        with core.lock:
            live = [(slot, st) for slot, st in ticket.parts
                    if core.active.get(slot) is st]
        now = time.monotonic()
        self.metrics.record_decode_step(len(ticket.parts), self.max_slots)
        sampled = 0
        retired = []
        for slot, st in live:
            tok = int(toks[slot])
            st.last_token = tok
            st.position += 1
            st.generated += 1
            sampled += st.req.sampled
            tr = st.req.stream.trace
            if tr is not None:
                tr.tick("decode")
            if st.t_last:
                self.metrics.record_itl(now - st.t_last)
            st.t_last = now
            st.req.stream._push(tok, now)
            # the automaton advanced at the fold-in (the mask had to be
            # live before the dispatch): only its verdict is read here
            why = self._grammar_why(st, self._retire_why(st, st.req, now))
            if why is not None:
                retired.append((slot, st, why))
        if sampled:
            self.metrics.record_sampled(sampled)
        for slot, st, why in retired:
            self._release_slot(slot, st)
            self._finish_slot(st, why, now)

    def _profile_tick(self) -> None:
        """The optional ``torch.profiler`` bracket: with ``profile_dir``
        set, start recording at the first iteration and stop after
        ``profile_iters``, writing a Chrome trace there. A profiler
        failure disables the bracket, never serving."""
        if self._profile_dir is None or self._profile_state == 2:
            return
        try:
            if self._profile_state == 0:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                self._profiler = torch.profiler.profile(activities=acts)
                self._profiler.start()
                self._profile_state = 1
                return
            self._profile_count += 1
            if self._profile_count >= self._profile_iters:
                self._stop_profile()
        except Exception:
            log.exception("engine profiler bracket failed; disabled")
            self._profile_state = 2

    def _stop_profile(self) -> None:
        prof, self._profiler = self._profiler, None
        self._profile_state = 2
        prof.stop()
        os.makedirs(self._profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            self._profile_dir, f"engine-{os.getpid()}-{id(self):x}"
                               f".pt.trace.json"))

    def _pages_needed(self, req: _GenRequest) -> int:
        # pages per lane: rows written = prompt + generated - 1 (the last
        # token is returned but never written back). A prefill-role slot
        # writes prompt rows only: the adopting decode pool reserves the
        # generation's pages
        if self.role == "prefill":
            return self._pool.pages_for(len(req.prompt))
        return self._pool.pages_for(
            min(len(req.prompt) + req.max_new_tokens - 1, self.max_len))

    def _admit_and_prefill(self) -> float:
        """Admission, then one chunk per prefilling slot; returns the
        prompt calls' wall time. A head the pool cannot cover first evicts
        unreferenced cached pages; failing that, a later request that fits
        may pass it (cache-aware admission, at most ``_bypass_limit``
        times in a row), or a host-tier engine swaps out active streams of
        lower priority; only then does the head wait (a delay, never a
        reorder). In an async iteration this runs in the overlap
        window."""
        core = self._core
        if not self.paged:
            return self._admit_dense_all()
        while True:
            swap_head = None
            swap_need = 0
            with core.lock:
                if not core.pending or not core.free:
                    break
                take = 0
                need_alloc, probes = self._admit_need(core.pending[0])
                if not self._pool.can_reserve(need_alloc) and \
                        not self._evict_for(need_alloc, probes):
                    bypass = self._pick_bypass()
                    if bypass is None:
                        swap_head = core.pending[0]
                        swap_need = need_alloc
                    else:
                        take = bypass
                if swap_head is None:
                    if take == 0:
                        self._head_bypasses = 0
                        req = core.pending.popleft()
                    else:
                        self._head_bypasses += 1
                        self.admission_bypasses += 1
                        req = core.pending[take]
                        del core.pending[take]
                    depth = len(core.pending)
            if swap_head is not None:
                if self._swap_out_for(swap_head, swap_need):
                    continue
                break
            self.metrics.set_queue_depth(depth)
            if req.handoff is not None:
                self._admit_prefilled(req)
            else:
                self._admit_paged(req)
        with core.lock:
            prefilling = sorted((s, st) for s, st in core.active.items()
                                if st.phase == "prefill")
        if not prefilling:
            return 0.0
        t0 = time.monotonic()
        for slot, st in prefilling:
            self._prefill_chunk_once(slot, st)
        return time.monotonic() - t0

    def _admit_dense_all(self) -> float:
        """The dense engine's admission: FIFO into free slots, each prompt
        run whole at once (no pages, no chunks). Returns the prompt calls'
        wall time."""
        core = self._core
        t0 = time.monotonic()
        while True:
            with core.lock:
                if not core.pending or not core.free:
                    break
                req = core.pending.popleft()
                depth = len(core.pending)
            self.metrics.set_queue_depth(depth)
            self._admit_dense(req)
        return time.monotonic() - t0

    def _admit_dense(self, req: _GenRequest) -> None:
        """Prefill ``req``'s bucket-padded prompt into the lowest free
        slot's lanes and push its first token; the slot decodes from the
        next step on."""
        now = time.monotonic()
        why = self._retire_why(None, req, now)
        if why is not None:
            self._finish_request(req, why, now)
            return
        core = self._core
        slot = None
        try:
            faults.fire("engine.prefill", engine=self)
            with core.lock:
                core.free.sort()
                slot = core.free.pop(0)
            tr = req.stream.trace
            sp = None
            if tr is not None:
                tr.span("queue_wait", tr.t0)
                sp = tr.begin_span("prefill_chunk", slot=slot)
            n = len(req.prompt)
            bucket = next(b for b in self.prompt_buckets if b >= n)
            padded = np.full((bucket,), self.pad_id, np.int32)
            padded[:n] = req.prompt
            with self._stage.call() as put:
                tok_dev, self._cache = self.kernels.prefill(
                    self._cache, slot, padded, n, upload=put)
            tok = int(tok_dev.item())
        except Exception as e:
            # the request is off the queue and not yet active, out of
            # reach of the loop's failure sweep: it fails here, with the
            # error the sweep gives every other stream
            if slot is not None:
                with core.lock:
                    core.free.append(slot)
            _fail_request(req, e)
            raise
        now = time.monotonic()
        self.metrics.record_prefill(n, bucket, now - req.stream.t_submit)
        if tr is not None:
            tr.end_span(sp, tokens=n, final=True)
            tr.event("first_token")
        req.stream._push(tok, now)
        st = _SlotState(req, None, None, self.pad_id, t_admit=now)
        st.phase = "decode"
        st.last_token = tok
        st.position = n
        st.generated = 1
        st.t_last = now
        why = self._retire_why(st, req, now)
        if why is None:
            with core.lock:
                core.active[slot] = st
            self._arm_async_slot(slot, st)
        else:
            with core.lock:
                core.free.append(slot)
            self._finish_slot(st, why, now)

    # ----------------------------------------------------- prefix cache ----

    def _prefix_probe(self, req: _GenRequest):
        """``(cached token count, [(pages, nodes) per lane])`` for
        ``req``'s prompt. A speculative engine clamps to the depth both
        lanes hit: the chunk skip is shared."""
        n_tok, pages, nodes = self._prefix.lookup(req.prompt)
        if self._dprefix is None:
            return n_tok, [(pages, nodes)]
        dn_tok, dpages, dnodes = self._dprefix.lookup(req.prompt)
        k = min(n_tok, dn_tok) // self.page_size
        return k * self.page_size, [(pages[:k], nodes[:k]),
                                    (dpages[:k], dnodes[:k])]

    def _admit_need(self, req: _GenRequest):
        """Pages the pool must allocate to admit ``req`` (attached cached
        pages are shared, not allocated), and the probe whose chains the
        eviction must not touch."""
        need = self._lanes * self._pages_needed(req)
        if self._prefix is None or req.handoff is not None:
            return need, None
        cached_len, probes = self._prefix_probe(req)
        return need - self._lanes * (cached_len // self.page_size), probes

    def _evict_for(self, need_alloc: int, probes) -> bool:
        """Evict LRU unreferenced cached pages, lane by lane, never the
        chains the admission matched, until the pool covers
        ``need_alloc``. True when it now does."""
        if self._prefix is None or self._evict_stale:
            return False
        protect = set()
        for pr in probes or ():
            protect.update(pr[1])
        shortfall = need_alloc - self._pool.free_pages
        freed = 0
        # target-lane victims offload to the host tier (the hook gathers
        # each page before evict() releases it)
        on_evict = self._offload_page if self._host is not None else None
        for cache in (self._prefix, self._dprefix):
            if cache is None or shortfall <= freed:
                break
            freed += cache.evict(shortfall - freed, frozenset(protect),
                                 on_evict=on_evict)
            on_evict = None
        if freed == 0:
            self._evict_stale = True
        return self._pool.can_reserve(need_alloc)

    def _pick_bypass(self) -> Optional[int]:
        """The index into ``pending`` of a later request to admit while
        the page-blocked head waits, or None. A candidate must fit as the
        pool stands; the longest cached prefix wins, then FIFO order. At
        most ``_bypass_limit`` bypasses in a row. Caller holds the core
        lock."""
        if (not self.cache_aware_admission
                or self._head_bypasses >= self._bypass_limit):
            return None
        best: Optional[Tuple[int, int]] = None   # (cached_len, index)
        pending = self._core.pending
        for j in range(1, len(pending)):
            need, _ = self._admit_need(pending[j])
            if not self._pool.can_reserve(need):
                continue
            cached = 0
            if self._prefix is not None:
                cached, _ = self._prefix_probe(pending[j])
            if best is None or cached > best[0]:
                best = (cached, j)
        return None if best is None else best[1]

    def _chunk_invocations(self, n_tokens: int) -> int:
        """Prompt calls (non-final chunks and the final prefill) a prompt
        tail of ``n_tokens`` costs."""
        if n_tokens <= 0:
            return 0
        return (n_tokens - 1) // self.prefill_chunk + 1

    # -------------------------------------------------------- host tier ----

    def _queue_copy(self, entry: dict) -> None:
        """Append a device -> host copy and start every queued copy the
        staging ring has room for, in order."""
        self._pending_offloads.append(entry)
        self._start_copies()

    def _start_copies(self) -> None:
        for entry in self._pending_offloads:
            if entry["copy"] is not None:
                continue
            block = (entry["block"] if entry["kind"] == "prefix"
                     else entry["payload"]["block"])
            entry["copy"] = self._copier.start(block)
            if entry["copy"] is None:
                return          # the ring is full: later copies wait too

    def _offload_page(self, prefix: Tuple[int, ...], page: int) -> None:
        """Prefix-eviction hook: gather the victim page and start its copy
        to host memory, before evict() releases it, so the gather reads
        the page before its next owner writes it (one stream). At most
        ``_offload_inflight_cap`` copies are in flight; past the cap the
        page just evicts, counted as a drop, as it does when the
        ``kv.offload`` site faults (only this entry is lost)."""
        if len(self._pending_offloads) >= self._offload_inflight_cap:
            self._drain_offloads()   # non-blocking: reap what landed
        if len(self._pending_offloads) >= self._offload_inflight_cap:
            self._host.record_drop()
            self.metrics.record_offload_dropped()
            return
        try:
            faults.fire("kv.offload", engine=self, kind="prefix")
        except Exception as exc:
            log.debug("kv.offload copy faulted; entry dropped: %s", exc)
            self._host.record_drop()
            self.metrics.record_offload_dropped()
            return
        self._queue_copy({
            "kind": "prefix", "key": tuple(prefix),
            "version": self._prefix.version, "copy": None,
            "block": self._mover.gather(self._cache, [page])})

    def _drain_offloads(self, wait: bool = False) -> None:
        """File the device -> host copies that have landed, in order: a
        prefix page into the host store, a swapped-out stream's block into
        its payload. Non-blocking unless ``wait`` (tests and drains):
        nothing is taken before its CUDA event has completed."""
        drained = False
        while self._pending_offloads:
            entry = self._pending_offloads[0]
            if entry["copy"] is None:
                self._start_copies()
            if not wait and not self._copier.ready(entry["copy"]):
                break
            self._pending_offloads.pop(0)
            rows = self._copier.take(entry["copy"], wait=wait)
            drained = True
            if entry["kind"] == "prefix":
                self._host.put_prefix(
                    entry["version"], entry["key"],
                    {name: tuple(t[0] for t in leaves)
                     for name, leaves in rows.items()})
                self.metrics.record_offload(1)
            else:
                entry["payload"]["block"] = rows
            self._start_copies()
        if drained:
            self._report_pages()

    def _restore_prefix(self, req: _GenRequest, cached_len: int
                        ) -> Tuple[List[int], int]:
        """Extend a device prefix hit from the host tier: the consecutive
        page-aligned chunks past it whose pages were offloaded come back
        into fresh pages (one batched copy and scatter) and republish, so
        the attach sees them as never evicted. Returns ``(restored pages,
        new cached_len)``; the restored pages replace tail allocations one
        for one. A fault at the ``kv.restore`` site degrades the entries
        to a miss: they leave the host store and the request prefills
        them."""
        host = self._host
        ps = self.page_size
        prompt = req.prompt
        version = self._prefix.version
        start_k = cached_len // ps
        hits: List[Tuple[int, ...]] = []
        for k in range(start_k, (len(prompt) - 1) // ps):
            key = tuple(prompt[:(k + 1) * ps])
            if not host.has_prefix(version, key):
                break
            hits.append(key)
        if not hits:
            return [], cached_len
        try:
            faults.fire("kv.restore", engine=self, kind="prefix")
        except Exception:
            for key in hits:
                host.drop_prefix(version, key)
            self._report_pages()
            return [], cached_len
        pages = self._pool.alloc(len(hits), owner="target")
        rows = [host.take_prefix(version, key) for key in hits]
        block = {name: tuple(torch.stack([r[name][j] for r in rows])
                             for j in range(len(leaves)))
                 for name, leaves in rows[0].items()}
        self._mover.scatter(self._cache, self._copier.upload(block), pages)
        end = (start_k + len(hits)) * ps
        pub_row = np.full((self._pool.pages_per_slot,), self._pool.trash,
                          np.int32)
        pub_row[start_k:start_k + len(pages)] = pages
        self._prefix.publish(prompt[:end], pub_row)
        self._evict_stale = False
        self.metrics.record_restore(len(pages))
        self._report_pages()
        return pages, end

    def _swap_out_for(self, head: _GenRequest, need_alloc: int) -> bool:
        """The head is page-blocked and neither eviction nor a bypass
        helped: swap out the lowest-priority, longest-idle active decode
        streams of strictly lower priority until its reservation fits.
        False leaves the FIFO wait in place."""
        if self._host is None:
            return False
        core = self._core
        swapped = False
        while not self._pool.can_reserve(need_alloc):
            with core.lock:
                victims = [
                    (st.req.priority, st.t_last, slot, st)
                    for slot, st in core.active.items()
                    if st.phase == "decode" and st.pages
                    and st.req.grammar is None
                    and st.req.priority < head.priority
                    and st.generated < st.req.max_new_tokens
                    and st.position < self.max_len]
            if not victims:
                return swapped and self._pool.can_reserve(need_alloc)
            victims.sort(key=lambda v: (v[0], v[1]))
            _, _, slot, st = victims[0]
            if not self._swap_out_slot(slot, st):
                return False
            swapped = True
        return True

    def _swap_out_slot(self, slot: int, st: _SlotState) -> bool:
        """Park one active decode stream in the host tier: gather its
        pages, queue their copy to host memory, export the pages, free the
        slot and re-queue a resume request whose payload carries the
        pages' rows, the key, the position, the generated count and the
        admission time. A fault at the ``kv.offload`` site aborts before
        anything moves (False): the stream stays resident."""
        try:
            faults.fire("kv.offload", engine=self, kind="swap")
        except Exception:
            self._host.record_drop()
            self.metrics.record_offload_dropped()
            return False
        req = st.req
        self._swap_seq += 1
        swap_id = self._swap_seq
        ps = self.page_size
        plen = len(req.prompt)
        meta = [(int(p), self._pool.generation(p), int((i + 1) * ps <= plen))
                for i, p in enumerate(st.pages)]
        payload = {
            "first_token": int(st.last_token),
            "key": self._keys[slot].copy(),
            "page_meta": meta,
            "source": self.handoff_source,
            "block": self._mover.gather(self._cache, st.pages),
            "swap": True,
            "swap_id": swap_id,
            "position": int(st.position),
            "generated": int(st.generated),
            "t_admit": float(st.t_admit),
        }
        self._queue_copy({"kind": "swap", "payload": payload, "copy": None})
        core = self._core
        with core.lock:
            core.active.pop(slot, None)
            core.free.append(slot)
        # the gather above read the rows; the pages free for the head. No
        # publish: nothing enters the index off a parked stream
        self._pool.export_pages(st.pages or ())
        st.pages = None
        self._disarm_slot(slot)
        self._host.park_stream(swap_id, len(meta))
        self.metrics.record_swap_out()
        resume = _GenRequest(req.prompt, req.max_new_tokens, req.deadline,
                             req.stream, temperature=req.temperature,
                             top_k=req.top_k, top_p=req.top_p,
                             seed=req.seed, tag=req.tag, handoff=payload,
                             priority=req.priority)
        with core.lock:
            # the FIFO tail: the resumed stream waits its turn like any
            # arrival
            core.pending.append(resume)
        self._report_pages()
        return True

    def _admit_prefilled(self, req: _GenRequest) -> None:
        """Admit a request whose prompt's KV rows arrive as a block and a
        page manifest instead of running its prompt here: a decode-role
        handoff, or a parked stream's resume. Adopt the pages (a shared
        prefix page dedups to one local copy), upload the block if it is
        host memory, scatter it, and arm the slot as a monolithic final
        chunk would: the same last token, position, sampling parameters
        and key (the key after the first token's split), so the stream
        goes on as the monolithic engine's. A handoff pushes its first
        token; a resume continues mid-stream and pushes nothing (its
        consumer holds every token already). A failure between adopt and
        scatter fails this stream only, and its pages release: a fault at
        ``kv.restore`` (kind ``swap``, a resume) or ``engine.page_handoff``
        (stage ``adopt``) lands there."""
        payload = req.handoff
        swap = bool(payload.get("swap"))
        if swap:
            # the parked booking ends when the resume admission runs,
            # whatever its outcome
            self._host.unpark_stream(int(payload["swap_id"]))
            self.metrics.record_swap_in()
            self._report_pages()
        now = time.monotonic()
        why = self._retire_why(None, req, now)
        if why is not None:
            self._finish_request(req, why, now)
            return
        core = self._core
        with core.lock:
            core.free.sort()
            slot = core.free.pop(0)
        meta = np.asarray(payload["page_meta"]).reshape(-1, 3)
        need = self._pages_needed(req)
        k_p = len(meta)
        pages: List[int] = []
        try:
            if swap:
                faults.fire("kv.restore", engine=self, kind="swap")
            faults.fire("engine.page_handoff", engine=self, stage="adopt")
            pages = self._pool.adopt_pages(
                [(int(m[0]), int(m[1]), bool(m[2])) for m in meta],
                source=str(payload["source"]), owner="target")
            pages = pages + self._pool.alloc(need - k_p, owner="target")
            row = np.full((self._pool.pages_per_slot,), self._pool.trash,
                          np.int32)
            row[:len(pages)] = pages
            ready = payload.get("ready")
            if ready is not None:
                # the gather ran on the prefill role's stream: wait for it
                # on ours (both roles use the device's default stream
                # today, where this costs nothing; a role given a stream
                # of its own must not read the block before it is written)
                torch.cuda.current_stream(self.device).wait_event(ready)
            self._mover.scatter(self._cache,
                                self._copier.upload(payload["block"]),
                                pages[:k_p])
        except Exception as e:
            self._pool.release(pages)
            with core.lock:
                core.free.append(slot)
            self._report_pages()
            self.metrics.record_failed()
            req.stream._finish(e, time.monotonic())
            return
        self._temps[slot] = req.temperature
        self._top_ks[slot] = req.top_k
        self._top_ps[slot] = req.top_p
        self._keys[slot] = np.asarray(payload["key"], np.uint32)
        self._page_map[slot] = row
        now = time.monotonic()
        # a resume keeps its first admission's time (the queue wait)
        st = _SlotState(req, pages, row, self.pad_id,
                        t_admit=float(payload["t_admit"]) if swap else now)
        st.phase = "decode"
        st.last_token = int(payload["first_token"])
        st.position = (int(payload["position"]) if swap
                       else len(req.prompt))
        st.generated = int(payload["generated"]) if swap else 1
        st.prefill_pos = len(req.prompt)
        st.t_last = now
        with core.lock:
            core.active[slot] = st
        self._arm_async_slot(slot, st)
        self._report_pages()
        if not swap:
            req.stream._push(st.last_token, now)
        why = self._retire_why(st, req, now)
        if why is not None:
            self._release_slot(slot, st)
            self._finish_slot(st, why, now)

    def _request_key(self, req: _GenRequest) -> np.ndarray:
        seed = req.seed
        if seed is None:
            seed = request_seed(
                self.seed, np.asarray(req.prompt, np.int32).tobytes(),
                len(req.prompt))
        return threefry_key_data(seed)

    def _admit_paged(self, req: _GenRequest) -> None:
        """Reserve a slot and the request's page budget (both lanes of a
        speculative slot). With the prefix cache the cached prefix's pages
        come first in the row, attached by reference (and, with the host
        tier, restored ones right after them); only the rest is allocated
        and the prompt prefills from ``cached_len``. Every write the
        request makes lands past the attached prefix, in its own pages:
        hits are page-aligned and leave a tail. The slot's decode page-map
        row and its sampling parameters and key stay parked (trash page,
        greedy, zero key) until its final prompt chunk has run:
        interleaved decode steps write a pad row for every slot,
        prefilling ones included, and split every slot's key."""
        now = time.monotonic()
        why = self._retire_why(None, req, now)
        if why is not None:
            self._finish_request(req, why, now)
            return
        if req.grammar is not None:
            self.metrics.record_constrained_stream()
        core = self._core
        with core.lock:
            core.free.sort()
            slot = core.free.pop(0)
        need = self._pages_needed(req)
        tr = req.stream.trace
        reserve_sp = None
        if tr is not None:
            tr.span("queue_wait", tr.t0)
            reserve_sp = tr.begin_span("page_reserve")
        cached_len = hit_k = 0
        shared: List[int] = []
        dshared: List[int] = []
        restored: List[int] = []
        if self._prefix is not None:
            cached_len, probes = self._prefix_probe(req)
            assert cached_len % self.page_size == 0 \
                and cached_len < len(req.prompt), \
                "prefix attach must be page-aligned with a live tail"
            hit_k = cached_len // self.page_size
            if hit_k:
                shared = list(probes[0][0])
                self._pool.share(shared)
                if self._dprefix is not None:
                    dshared = list(probes[1][0])
                    self._pool.share(dshared)
            if self._host is not None:
                restored, cached_len = self._restore_prefix(req, cached_len)
                hit_k = cached_len // self.page_size
            skipped = (self._chunk_invocations(len(req.prompt))
                       - self._chunk_invocations(len(req.prompt)
                                                 - cached_len))
            for cache in (self._prefix, self._dprefix):
                if cache is not None:
                    cache.record_probe(hit_k > 0, cached_len)
            self.metrics.record_prefix_probe(hit_k > 0,
                                             skipped * self._lanes)

        def lane(owner, attached):
            pages = attached + self._pool.alloc(need - hit_k, owner=owner)
            row = np.full((self._pool.pages_per_slot,), self._pool.trash,
                          np.int32)
            row[:len(pages)] = pages
            return pages, row

        pages, row = lane("target", shared + restored)
        draft_pages, drow = lane("draft", dshared) if self.speculative \
            else (None, None)
        if tr is not None:
            tr.end_span(reserve_sp, pages=need * self._lanes, slot=slot,
                        prefix_pages=hit_k * self._lanes)
        st = _SlotState(req, pages, row, self.pad_id, draft_pages, drow,
                        t_admit=now)
        st.prefill_pos = st.position = cached_len
        if self._prefix is not None:
            # the index version the prompt is prefilled under
            st.cache_version = self._prefix.version
        with core.lock:
            core.active[slot] = st
        self._report_pages()
        if self._prefix is not None:
            # between the attach (references taken) and the first prompt
            # call: the loop's failure path must release every reference
            faults.fire("engine.prefix_attach", engine=self)

    def _prefill_chunk_once(self, slot: int, st: _SlotState) -> None:
        """Advance one prompt chunk of a prefilling slot. Non-final chunks
        are exactly ``prefill_chunk`` tokens; the final chunk is
        bucket-padded, arms the slot's sampling parameters and key, and
        yields the first generated token."""
        req = st.req
        now = time.monotonic()
        why = self._retire_why(None, req, now)
        if why is not None:
            self._release_slot(slot, st)
            self._finish_slot(st, why, now)
            return
        faults.fire("engine.prefill", engine=self)
        prompt = req.prompt
        start = st.prefill_pos
        remaining = len(prompt) - start
        tr = req.stream.trace
        if remaining > self.prefill_chunk:
            sp = tr.begin_span("prefill_chunk") if tr is not None else None
            piece = prompt[start:start + self.prefill_chunk]
            with self._stage.call() as put:
                self._cache = self.kernels.chunk(
                    self._cache, st.page_row, piece, start,
                    self.prefill_chunk, self._pool.trash, upload=put)
                if self.speculative:
                    # the draft needs the prompt in its own cache to
                    # propose
                    self._dcache = self.kernels.draft_write(
                        self._dcache, st.dpage_row, piece, start,
                        self.prefill_chunk, self._pool.trash, upload=put)
            st.prefill_pos += self.prefill_chunk
            st.position = st.prefill_pos
            self.metrics.record_chunk(self.prefill_chunk, self.prefill_chunk)
            if tr is not None:
                tr.end_span(sp, tokens=self.prefill_chunk, final=False)
            return
        final_sp = tr.begin_span("prefill_chunk") if tr is not None else None
        bucket = next(b for b in self.prompt_buckets if b >= remaining)
        padded = np.full((bucket,), self.pad_id, np.int32)
        padded[:remaining] = prompt[start:]
        self._temps[slot] = req.temperature
        self._top_ks[slot] = req.top_k
        self._top_ps[slot] = req.top_p
        # a constrained slot's mask row at the automaton's start state,
        # armed before the first token is sampled
        if req.grammar is not None:
            self._grammar_arm(slot, st)
        # the request's key, fresh here: token i draws from split i (or,
        # speculative, from output position i) whatever decode traffic
        # ran during the prefill
        key = self._request_key(req)
        sampling = (self._temps[slot], self._top_ks[slot],
                    self._top_ps[slot], key)
        with self._stage.call() as put:
            bias1 = (None if req.grammar is None
                     else put(self._bias[slot:slot + 1]))
            if self.speculative:
                tok_dev, self._cache = self.kernels.prefill(
                    self._cache, st.page_row, padded, start, remaining,
                    self._pool.trash, *sampling, upload=put,
                    **_masked(bias1))
                self._dcache = self.kernels.draft_write(
                    self._dcache, st.dpage_row, padded, start, remaining,
                    self._pool.trash, upload=put)
                self._keys[slot] = key
                self._dpage_map[slot] = st.dpage_row
            else:
                tok_dev, new_key, self._cache = self.kernels.prefill(
                    self._cache, st.page_row, padded, start, remaining,
                    self._pool.trash, *sampling, upload=put,
                    **_masked(bias1))
                self._keys[slot] = new_key[0]
        tok = int(tok_dev.item())
        self._page_map[slot] = st.page_row   # K/V written: go live
        now = time.monotonic()
        self.metrics.record_prefill(remaining, bucket,
                                    now - req.stream.t_submit)
        if req.sampled:
            self.metrics.record_sampled(1)
        if tr is not None:
            tr.end_span(final_sp, tokens=remaining, final=True)
            tr.event("first_token")
        req.stream._push(tok, now)
        st.phase = "decode"
        st.last_token = tok
        st.position = len(prompt)
        st.generated = 1
        st.t_last = now
        self._grammar_step(slot, st, tok)
        self._arm_async_slot(slot, st)
        why = self._grammar_why(st, self._retire_why(st, req, now))
        if why is not None:
            self._release_slot(slot, st)
            self._finish_slot(st, why, now)
            return
        if self.role == "prefill":
            # the whole prompt is written and the request wants more
            # tokens: hand its pages to the decode role. The callback
            # gathers the block on this thread while the pages are still
            # this slot's; only after it returns do they export and the
            # slot free. A failure there (the ``engine.page_handoff``
            # site, stage ``export``, included) fails this stream only
            try:
                faults.fire("engine.page_handoff", engine=self,
                            stage="export")
                cb = self._handoff_cb
                if cb is None:
                    raise RuntimeError(
                        "prefill-role engine has no handoff consumer "
                        "(set by DisaggregatedEngine / PrefillWorker)")
                cb(self._handoff_payload(slot, st, tok))
            except Exception as e:
                self._abort_handoff(slot, st, e)
                return
            self._handoff_slot(slot, st)
            self._finish_slot(st, "done", now)

    def _handoff_payload(self, slot: int, st: _SlotState, tok: int) -> dict:
        """What a decode-role engine needs to go on with ``st``'s stream:
        the first token, the key after its split (token i draws from
        split i whichever engine holds the slot), the sampling
        parameters, and the page manifest: ``(page id, write generation,
        shareable)`` per prompt page under this engine's
        ``handoff_source`` (full prompt pages are shareable; the partial
        last page takes decode writes and is always copied fresh). The
        handoff consumer gathers the block while the pages are still
        owned."""
        req = st.req
        ps = self.page_size
        plen = len(req.prompt)
        meta = np.asarray(
            [(int(p), self._pool.generation(p), int((i + 1) * ps <= plen))
             for i, p in enumerate(st.pages)], np.int64).reshape(-1, 3)
        return {
            "prompt": np.asarray(req.prompt, np.int32),
            "first_token": int(tok),
            "key": self._keys[slot].copy(),
            "plen": plen,
            "max_new_tokens": int(req.max_new_tokens),
            "temperature": float(req.temperature),
            "top_k": int(req.top_k),
            "top_p": float(req.top_p),
            "deadline": req.deadline,
            "page_row": st.page_row.copy(),
            "page_meta": meta,
            "source": self.handoff_source,
            "tag": req.tag,
            "priority": int(req.priority),
        }

    def _disarm_slot(self, slot: int) -> None:
        """Park a freed slot's map row on the trash page and reset its
        sampling row, key and mask row."""
        self._page_map[slot] = self._pool.trash
        self._temps[slot] = 0.0
        self._top_ks[slot] = 0
        self._top_ps[slot] = 1.0
        self._keys[slot] = 0
        if self._bias is not None:
            self._bias[slot] = 0.0
        self._evict_stale = False

    def _handoff_slot(self, slot: int, st: _SlotState) -> None:
        """Retire a prefill-role slot whose pages were handed off: publish
        its full prompt pages to the prefix index (which lives with this
        role), export the request's references and free the slot."""
        core = self._core
        with core.lock:
            core.active.pop(slot, None)
            core.free.append(slot)
        if (self._prefix is not None and st.pages
                and st.cache_version == self._prefix.version):
            self._prefix.publish(st.req.prompt, st.page_row)
            self._evict_stale = False
            self._dedup_after_publish()
        self._pool.export_pages(st.pages or ())
        st.pages = None
        self._disarm_slot(slot)
        self._report_pages()

    def _abort_handoff(self, slot: int, st: _SlotState,
                       err: BaseException) -> None:
        """A handoff failed before its pages left this pool: release them
        (no publish), free the slot and fail this stream with ``err``. The
        gather only read the cache, so the engine serves on."""
        core = self._core
        with core.lock:
            core.active.pop(slot, None)
            core.free.append(slot)
        self._pool.release(st.pages or ())
        st.pages = None
        self._disarm_slot(slot)
        self._report_pages()
        self.metrics.record_failed()
        st.req.stream._finish(err, time.monotonic())
        tr = st.req.stream.trace
        if tr is not None:
            tr.finish(outcome="failed", tokens=st.generated)

    def _step_inputs(self, active) -> Tuple[np.ndarray, ...]:
        """Each active slot's last token, its position and its tokens so
        far; zeros for the other slots."""
        tokens, positions, generated = (
            np.zeros((self.max_slots,), np.int32) for _ in range(3))
        for slot, st in active:
            tokens[slot] = st.last_token
            positions[slot] = st.position
            generated[slot] = st.generated
        return tokens, positions, generated

    def _step_bias(self, active, put) -> Optional[torch.Tensor]:
        """Every slot's mask row on the device (through ``put``) when some
        active slot is constrained; otherwise None, and the step adds no
        launch and no upload (a zero row would be a bitwise no-op
        anyway)."""
        if self._bias is None or all(st.req.grammar is None
                                     for _, st in active):
            return None
        return put(self._bias)

    def _decode_once(self, active: List[Tuple[int, _SlotState]]) -> None:
        # an armed exception here is a step failure (every stream fails,
        # the loop stops); armed latency is a slow or hung device for the
        # stall watchdog
        faults.fire("engine.decode", engine=self)
        tokens, positions, _ = self._step_inputs(active)
        with self._stage.call() as put:
            if self.paged:
                toks_dev, self._keys, self._cache = self.kernels.decode(
                    self._cache, tokens, positions, self._page_map,
                    self._temps, self._top_ks, self._top_ps, self._keys,
                    upload=put, **_masked(self._step_bias(active, put)))
            else:
                toks_dev, self._cache = self.kernels.decode(
                    self._cache, tokens, positions, upload=put)
        toks = toks_dev.cpu().numpy()
        now = time.monotonic()
        self.metrics.record_decode_step(len(active), self.max_slots)
        sampled = 0
        retired = []
        for slot, st in active:
            tok = int(toks[slot])
            st.last_token = tok
            st.position += 1
            st.generated += 1
            tr = st.req.stream.trace
            if tr is not None:
                tr.tick("decode")
            if st.t_last:
                # the gap since this stream's previous token
                self.metrics.record_itl(now - st.t_last)
            st.t_last = now
            sampled += st.req.sampled
            st.req.stream._push(tok, now)
            self._grammar_step(slot, st, tok)
            why = self._grammar_why(st, self._retire_why(st, st.req, now))
            if why is not None:
                retired.append((slot, st, why))
        if sampled:
            self.metrics.record_sampled(sampled)
        for slot, st, why in retired:
            self._release_slot(slot, st)
            self._finish_slot(st, why, now)

    def _speculative_round(self,
                           active: List[Tuple[int, _SlotState]]) -> None:
        """One speculative round over every decoding slot: k+1 draft decode
        steps, each fed the previous one's tokens on the device (the +1
        pre-writes the bonus token's row of the draft cache, so a full
        acceptance leaves no hole), then ONE target verify forward scoring
        all k candidates, then the host's accept and rollback bookkeeping.
        Rollback is by position only: rejected candidates' rows sit past
        the slot's position, masked, until a later round overwrites
        them.

        Under a grammar, draft step i and verify row i share one mask: the
        automaton state after the first i proposals, walked on a scratch
        copy of each constrained slot's state (the draft's tokens come to
        the host for it). The slot's own state advances only on emitted
        tokens, so a rejected proposal never moves it; the accepted prefix
        is the draft prefix, so the residual pick at the first rejection
        is masked by its true predecessor state."""
        faults.fire("engine.draft", engine=self)
        k = self.spec_k
        tokens, positions, out_base = self._step_inputs(active)
        sampling = (self._temps, self._top_ks, self._top_ps, self._keys)
        gslots = [(slot, st) for slot, st in active
                  if st.req.grammar is not None]
        scratch = {slot: st.grammar_state for slot, st in gslots}
        d_tokens, d_dists, biases = [], [], []
        cur = tokens
        for i in range(k + 1):
            bias_i = None
            if gslots:
                rows = self._bias.copy()
                for slot, st in gslots:
                    rows[slot] = st.req.grammar.bias_row(scratch[slot])
                bias_i = self._stage.upload(rows)
                biases.append(bias_i)
            # positions clamp at the lane end: a slot about to retire at
            # max_len keeps its shapes (its proposals there are rejected
            # or cut by the room cap below)
            pos_i = np.minimum(positions + i, self.max_len - 1)
            cur, dist, self._dcache = self.kernels.draft(
                self._dcache, cur, pos_i, self._dpage_map, *sampling,
                out_base + i, **_masked(bias_i))
            if gslots:
                proposed = cur.cpu().numpy()
                for slot, st in gslots:
                    scratch[slot] = st.req.grammar.advance(
                        scratch[slot], int(proposed[slot]))
            if i < k:
                d_tokens.append(cur)
                d_dists.append(dist)
        faults.fire("engine.verify", engine=self)
        n_dev, out_dev, self._cache = self.kernels.verify(
            self._cache, tokens, d_tokens, positions, self._page_map,
            self._pool.trash, *sampling, out_base, d_dists,
            **_masked(torch.stack(biases, dim=1) if gslots else None))
        n_acc = n_dev.cpu().numpy()
        outs = out_dev.cpu().numpy()
        now = time.monotonic()
        self.metrics.record_decode_step(len(active), self.max_slots)
        accepted = pushed_total = sampled = 0
        retired = []
        for slot, st in active:
            room = min(st.req.max_new_tokens - st.generated,
                       self.max_len - st.position)
            emit = min(int(n_acc[slot]) + 1, room)
            pushed = 0
            for j in range(emit):
                tok = int(outs[slot, j])
                st.req.stream._push(tok, now)
                pushed += 1
                if self.eos_id is not None and tok == self.eos_id:
                    break
                # the slot's own state advances per emitted token; a
                # stuck verdict stops the emission
                self._grammar_step(slot, st, tok)
                if st.grammar_error is not None:
                    break
            accepted += min(int(n_acc[slot]), pushed)
            pushed_total += pushed
            tr = st.req.stream.trace
            if tr is not None:
                tr.tick("verify_round")
            if st.t_last:
                # the round's gap spread over the tokens it pushed
                self.metrics.record_itl((now - st.t_last) / pushed, pushed)
            st.t_last = now
            st.last_token = int(outs[slot, pushed - 1])
            st.position += pushed
            st.generated += pushed
            sampled += pushed if st.req.sampled else 0
            why = self._grammar_why(st, self._retire_why(st, st.req, now))
            if why is not None:
                retired.append((slot, st, why))
        self.metrics.record_verify_step(k * len(active), accepted,
                                        pushed_total - len(active))
        if sampled:
            self.metrics.record_sampled(sampled)
        for slot, st, why in retired:
            self._release_slot(slot, st)
            self._finish_slot(st, why, now)

    def _release_lanes(self, slot: int, st: _SlotState) -> None:
        """Return a slot's pages (both lanes) to the pool, park its map
        rows on the trash page so the next step can neither read nor
        clobber a page the next owner gets, and disarm its sampling row.
        A dense slot has no pages: its lanes are rewritten by the next
        prefill."""
        st.grammar_state = None
        if not self.paged:
            return
        self._pool.release(st.pages or ())
        st.pages = None
        if self.speculative:
            self._pool.release(st.draft_pages or ())
            st.draft_pages = None
            self._dpage_map[slot] = self._pool.trash
        self._disarm_slot(slot)    # released pages: a re-scan is live

    def _release_slot(self, slot: int, st: _SlotState) -> None:
        """Free the slot and its lanes. With the prefix cache, a sequence
        whose whole prompt is written first publishes its full prompt
        pages: the index takes its references before the request drops
        its own, so the pages never reach the free heap in between."""
        core = self._core
        with core.lock:
            core.active.pop(slot, None)
            core.free.append(slot)
        if (self._prefix is not None and st.pages
                and st.phase == "decode"
                and st.cache_version == self._prefix.version):
            self._prefix.publish(st.req.prompt, st.page_row)
            if self._dprefix is not None:
                self._dprefix.publish(st.req.prompt, st.dpage_row)
            self._dedup_after_publish()
        self._release_lanes(slot, st)
        self._report_pages()

    def _dedup_after_publish(self) -> None:
        """Repoint every decoding slot whose full prompt pages now have
        cached twins (concurrent same-prefix requests that all missed and
        wrote their own copies) at the cached pages, and release its
        duplicates. A full prompt page is a pure function of its
        page-aligned prefix, and a decoding slot writes only past its
        prompt, so its tokens do not change."""
        core = self._core
        with core.lock:
            slots = [(s, st) for s, st in core.active.items()
                     if st.phase == "decode" and st.pages]
        for slot, st in slots:
            if st.cache_version != self._prefix.version:
                continue
            n_full = len(st.req.prompt) // self.page_size
            if not n_full:
                continue
            canon = self._prefix.match_pages(st.req.prompt, n_full)
            self._dedup_row(self._prefix, st.pages, st.page_row,
                            self._page_map[slot], canon)
            if self._dprefix is not None and st.draft_pages:
                dcanon = self._dprefix.match_pages(st.req.prompt, n_full)
                self._dedup_row(self._dprefix, st.draft_pages,
                                st.dpage_row, self._dpage_map[slot],
                                dcanon)

    def _dedup_row(self, cache: PrefixCache, pages: List[int], row,
                   map_row, canon: List[int]) -> None:
        swapped = 0
        for i, page in enumerate(canon):
            if i >= len(pages) or pages[i] == page:
                continue
            # the cached page's reference before the duplicate's release;
            # both the slot's row (read at publish) and the live page-map
            # row (read by the decode kernel) repoint, or the step would
            # read a released duplicate its next owner overwrites
            self._pool.share([page])
            self._pool.release([pages[i]])
            pages[i] = page
            row[i] = page
            map_row[i] = page
            swapped += 1
        if swapped:
            cache.deduped_pages += swapped
            self._evict_stale = False

    def _retire_why(self, st: Optional[_SlotState], req: _GenRequest,
                    now: float) -> Optional[str]:
        """Retirement disposition, or None to keep going: cancel wins, a
        normally-completed sequence beats a deadline that expired on the
        same step."""
        if req.stream.cancelled:
            return "cancelled"
        if st is not None:
            if self.eos_id is not None and st.last_token == self.eos_id:
                return "done"
            if st.generated >= req.max_new_tokens:
                return "done"
            if st.position >= self.max_len:
                return "done"
        if req.deadline is not None and now > req.deadline:
            return "expired"
        return None

    # ------------------------------------------------------- grammar ----

    def _grammar_arm(self, slot: int, st: _SlotState) -> None:
        """Arm a constrained slot's mask row at the automaton's start
        state, before its first token is sampled."""
        g = st.req.grammar
        st.grammar_state = g.start_state
        self._bias[slot] = g.bias_row(st.grammar_state)
        self.metrics.record_masked_frac(g.masked_frac(st.grammar_state))

    def _grammar_step(self, slot: int, st: _SlotState, tok: int) -> None:
        """Advance a constrained slot's automaton on one emitted token and
        arm its mask row for the next step. A verdict (a stuck state, or
        a token the mask should have excluded) goes to
        ``st.grammar_error`` for :meth:`_grammar_why`; nothing raises in
        the loop."""
        g = st.req.grammar
        if g is None or st.grammar_error is not None:
            return
        if self.eos_id is not None and tok == self.eos_id:
            # EOS is legal only in accepting states: sampling it is the
            # parse
            return
        state = g.advance(st.grammar_state, tok)
        st.grammar_state = state
        if state < 0:
            st.grammar_error = GrammarViolation(
                f"token {tok} is not legal from the previous state",
                state=state, tokens_out=st.generated, grammar_key=g.key)
            return
        if not g.has_continuation(state) and not g.is_accepting(state):
            st.grammar_error = GrammarViolation(
                "stuck state: no legal continuation and no legal EOS "
                "over this vocabulary", state=state,
                tokens_out=st.generated, grammar_key=g.key)
            return
        self._bias[slot] = g.bias_row(state)
        self.metrics.record_masked_frac(g.masked_frac(state))

    def _grammar_why(self, st: _SlotState,
                     why: Optional[str]) -> Optional[str]:
        """Fold the grammar's verdict into the retirement disposition: a
        recorded violation fails the stream; a budget or length ``done``
        in a non-accepting state is a violation; with no EOS id, an
        accepting state with nothing legal left is ``done``. Cancel and
        expiry pass through."""
        g = st.req.grammar
        if g is None:
            return why
        if st.grammar_error is not None:
            return "grammar"
        if why == "done" and not g.is_accepting(st.grammar_state):
            st.grammar_error = GrammarViolation(
                "token budget exhausted before the grammar could "
                "complete", state=st.grammar_state,
                tokens_out=st.generated, grammar_key=g.key)
            return "grammar"
        if (why is None and self.eos_id is None
                and g.is_accepting(st.grammar_state)
                and not g.has_continuation(st.grammar_state)):
            return "done"
        return why

    def _finish_slot(self, st: _SlotState, why: str, now: float) -> None:
        if why == "grammar":
            self.metrics.record_failed()
            st.req.stream._finish(st.grammar_error, now)
            tr = st.req.stream.trace
            if tr is not None:
                tr.finish(outcome="grammar_violation", tokens=st.generated)
            return
        self._finish_request(st.req, why, now,
                             queue_wait=st.t_admit - st.req.stream.t_submit,
                             generated=st.generated)

    def _finish_request(self, req: _GenRequest, why: str,
                        now: Optional[float] = None, *,
                        queue_wait: Optional[float] = None,
                        generated: int = 0) -> None:
        """End ``req``'s stream with disposition ``why``; a served stream
        records its latency, its queue wait (submit to admission) and its
        token rate."""
        stream = req.stream
        now = time.monotonic() if now is None else now
        dur = now - stream.t_submit
        if why == "expired":
            self.metrics.record_expired()
            stream._finish(DeadlineExceeded(
                dur, req.deadline - stream.t_submit), now)
        elif why == "cancelled":
            stream._finish(StreamCancelled(
                "generation stream cancelled by its consumer"), now)
        else:
            self.metrics.record_served(dur, queue_wait or 0.0)
            self.metrics.record_stream(generated, dur)
            stream._finish(None, now)
        tr = stream.trace
        if tr is not None:
            tr.finish(outcome=why, tokens=generated)

    def _report_pages(self) -> None:
        """Page occupancy, the prefix index's and the host tier's pages,
        and the bytes the reserved pages cost: each lane priced at its own
        model's per-page cost. A dense engine has none of these."""
        if not self.paged:
            return
        self.metrics.set_pages(self._pool.in_use, self._pool.num_pages)
        if self._prefix is not None:
            self.metrics.set_shared_pages(self.shared_pages)
        if self._host is not None:
            self.metrics.set_host_pages(self._host.pages,
                                        self._host.bytes_used)
        in_bytes = self._pool.in_use_by("target") * self._kv_page_bytes
        if self.speculative:
            in_bytes += self._pool.in_use_by("draft") * self._kv_dpage_bytes
        self.metrics.set_kv_cache(in_bytes, self.cache_dtype_name)

    # -------------------------------------------------------- lifecycle ----

    def warmup(self) -> None:
        """Run every kernel shape of this engine's role once before
        traffic: the decode step (or the draft and verify steps) greedy,
        sampled and, with a vocabulary, under a zero grammar mask; the
        chunk step (when prompts can be chunked), every prompt bucket and
        a sampled first token; the handoff's gather (prefill role) or its
        upload and scatter (decode role); and the host tier's page copies
        both ways. A prefill-role engine never runs the decode step, a
        decode-role engine never a prompt call. On a card the kernels
        load on their first launch, the sampler's included, so traffic
        pays none of it. Every write goes to the trash page. Must run
        before the first submit."""
        core = self._core
        with core.lock:
            if core.pending or core.active:
                raise RuntimeError("warmup() must run before traffic")
        if not self.paged:
            self._warmup_dense()
            return
        trash = self._pool.trash
        trash_row = np.full((self._pool.pages_per_slot,), trash, np.int32)
        zeros = np.zeros((self.max_slots,), np.int32)
        ones = np.ones((self.max_slots,), np.float32)
        kernels = self.kernels
        passes = [(self._temps, False), (ones, False)]  # greedy, sampled
        if self._bias is not None and self.role == "both":
            passes.append((self._temps, True))          # under a mask
        for temps, masked in passes if self.role != "prefill" else ():
            sampling = (temps, self._top_ks, self._top_ps, self._keys)
            with self._stage.call() as put:
                bias = put(self._bias) if masked else None
                if self.speculative:
                    tok, dist, self._dcache = kernels.draft(
                        self._dcache, zeros, zeros, self._dpage_map,
                        *sampling, zeros, **_masked(bias))
                    _, _, self._cache = kernels.verify(
                        self._cache, zeros, [tok] * self.spec_k, zeros,
                        self._page_map, trash, *sampling, zeros,
                        [dist] * self.spec_k,
                        **_masked(None if bias is None else torch.stack(
                            [bias] * (self.spec_k + 1), dim=1)))
                else:
                    toks, _, self._cache = kernels.decode(
                        self._cache, zeros, zeros, self._page_map,
                        *sampling, upload=put, **_masked(bias))
                    if self._land_tokens is not None:
                        self._land_tokens.copy_(toks, non_blocking=True)
        chunks = [(self.prefill_chunk, 0.0, False)] \
            if self.max_prompt_len > self.prefill_chunk else []
        finals = [(b, 0.0, True) for b in self.prompt_buckets]
        prompts = chunks + finals + [(self.prompt_buckets[0], 1.0, True)]
        for width, temperature, final in (prompts if self.role != "decode"
                                          else ()):
            pad = np.full((width,), self.pad_id, np.int32)
            with self._stage.call() as put:
                if final:
                    self._cache = kernels.prefill(
                        self._cache, trash_row, pad, 0, width, trash,
                        temperature, upload=put)[-1]
                else:
                    self._cache = kernels.chunk(self._cache, trash_row, pad,
                                                0, width, trash, upload=put)
                if self.speculative:
                    self._dcache = kernels.draft_write(
                        self._dcache, trash_row, pad, 0, width, trash,
                        upload=put)
        if self.role == "prefill":
            # the handoff's gather, off the trash page
            self._mover.gather(self._cache, [trash])
        elif self.role == "decode":
            # the PrefillWorker path's upload of a host block and the
            # adoption's scatter, trash page to trash page
            rows = {name: tuple(torch.zeros((1,) + leaf.shape[1:],
                                            dtype=leaf.dtype)
                                for leaf in leaves)
                    for name, leaves in self._cache.items()}
            self._mover.scatter(self._cache, self._copier.upload(rows),
                                [trash])
        if self._host is not None:
            # the host tier's gather, copies and scatter, trash page to
            # trash page
            ticket = self._copier.start(self._mover.gather(self._cache,
                                                           [trash]))
            rows = self._copier.take(ticket, wait=True)
            self._mover.scatter(self._cache, self._copier.upload(rows),
                                [trash])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _warmup_dense(self) -> None:
        """The dense engine's warmup: one decode step and a prompt call
        per bucket, into slot 0 (rows a real admission overwrites or
        masks)."""
        zeros = np.zeros((self.max_slots,), np.int32)
        with self._stage.call() as put:
            toks, self._cache = self.kernels.decode(self._cache, zeros,
                                                    zeros, upload=put)
            if self._land_tokens is not None:
                self._land_tokens.copy_(toks, non_blocking=True)
        for bucket in self.prompt_buckets:
            with self._stage.call() as put:
                _, self._cache = self.kernels.prefill(
                    self._cache, 0, np.full((bucket,), self.pad_id, np.int32),
                    bucket, upload=put)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reload(self, params, state: Any = None) -> None:
        """Swap the serving weights between steps. ``params`` is the
        float parameter tree in the weight bridge's layout (a nested dict
        keyed by module path, numpy or torch leaves, as
        ``interop.load_jax_params`` takes); a ``quantize="int8"`` engine
        quantizes it on the way in. The tree must match the serving
        model's leaf paths, shapes and dtypes, or this raises
        ``ValueError`` naming the signature and the old weights keep
        serving. The new tensors are built here, on the device
        (``service.stage``), and the loop copies them into the model it
        serves at the top of its next iteration on its own stream: after
        any step in flight, before the next one, so no step sees a mix of
        old and new layers. That model is the engine's own copy, unless
        the caller passed ``kernels``: then it is theirs, and a reload is
        refused while another live engine serves it too. Nothing is
        warmed up or built again. With the prefix cache, the loop also
        drops every cached page (the old weights wrote them) and the host
        tier before its next admission. ``state`` is accepted for
        symmetry with the service and must be empty: decoding keeps no
        module state."""
        if state:
            raise ValueError(
                "GenerationEngine.reload takes params only: incremental "
                "decode runs stateless (no BN-style buffers)")
        model = self.kernels.model
        if any(e is not self and not e._core.closed
               for e in _SERVED_IN_PLACE.get(model, ())):
            raise ValueError(
                "reload writes the served model in place, and another live "
                "engine serves the same model through the kernels given to "
                "both; give each engine kernels of its own")
        if self.quantize == "int8":
            params = quantize_tree_for_serving(model, params)
        require_matching_signature("params", dict(model.named_parameters()),
                                   params)
        staged = stage(params, self.device)
        core = self._core
        with core.lock:
            core.staged = staged
            if self._prefix is not None:
                self._prefix_flush = True
            core.wake.put(None)
        self.metrics.record_reload()

    def _apply_reload(self) -> None:
        """Copy a staged reload into the served model's parameters (loop
        thread, between iterations)."""
        core = self._core
        with core.lock:
            staged, core.staged = core.staged, None
        if staged is not None:
            apply_staged(dict(self.kernels.model.named_parameters()), staged,
                         self.device)

    def _maybe_flush_prefix(self) -> None:
        """Apply a reload's prefix flush on the loop thread, the only one
        that may touch the pool: cached pages hold K/V the old weights
        wrote, so the index (both lanes) drops them before any admission
        can probe it, and the host tier drops its entries and the copies
        in flight, keyed by the old index version."""
        with self._core.lock:
            if not self._prefix_flush:
                return
            self._prefix_flush = False
        self._prefix.clear()
        if self._dprefix is not None:
            self._dprefix.clear()
        if self._host is not None:
            self._pending_offloads.clear()
            self._copier.reset()
            self._host.clear()
        self._evict_stale = False
        self._report_pages()

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop admitting; with ``drain`` (default) the loop keeps stepping
        until every pending and in-flight stream finishes, otherwise they
        fail with ``RuntimeError``. Joins the loop thread."""
        core = self._core
        with core.lock:
            core.closed = True
            core.drain = drain
            core.wake.put(None)
        self._thread.join(timeout)
        if self._profile_state == 1:
            # a profile bracket wider than the traffic: close it rather
            # than leave the profiler recording
            try:
                self._stop_profile()
            except Exception:
                log.exception("stopping the engine profiler failed")
        if self._watchdog is not None and not self._thread.is_alive():
            self._watchdog.close()
        if not self._thread.is_alive():
            # a request that raced the close flag in must fail rather than
            # strand its consumer (never while the loop still runs)
            _fail_streams(core, RuntimeError(
                "generation engine closed before request ran"), self)

    def __enter__(self) -> "GenerationEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --------------------------------------------------------- queries ----

    @property
    def failed(self) -> Optional[BaseException]:
        with self._core.lock:
            return self._failed

    @property
    def pending_requests(self) -> int:
        with self._core.lock:
            return len(self._core.pending)

    @property
    def free_slots(self) -> List[int]:
        with self._core.lock:
            return sorted(self._core.free)

    @property
    def pages_in_use(self) -> int:
        return self._pool.in_use if self.paged else 0

    @property
    def free_pages(self) -> int:
        return self._pool.free_pages if self.paged else 0

    @property
    def active_slots(self) -> int:
        with self._core.lock:
            return len(self._core.active)

    @property
    def shared_pages(self) -> int:
        """Pages the prefix index(es) hold references for (0 without
        the prefix cache)."""
        return sum(c.pages for c in (self._prefix, self._dprefix)
                   if c is not None)

    @property
    def host_pages_in_use(self) -> int:
        """Pages resident in the host tier: offloaded prefix pages and
        parked streams' pages (0 without ``host_pages``)."""
        return self._host.pages if self._host is not None else 0

    @property
    def host_store(self) -> Optional[HostPageStore]:
        """The host tier (None without ``host_pages``)."""
        return self._host


def _check_dense_knobs(speculative: bool, cache_dtype, role: str,
                       host_pages, prefix_caching: bool) -> None:
    """The dense engine's refusals, in the JAX engine's order and words."""
    if speculative:
        raise ValueError(
            "speculative decoding needs the paged engine (the draft "
            "and target caches live side by side in one PagePool)")
    if cache_dtype == torch.int8:
        raise ValueError(
            "cache_dtype='int8' needs the paged engine (int8 KV lives "
            "in the page pools with per-token scale pools; the dense "
            "slot-lane path is the float baseline, kept bitwise "
            "untouched)")
    if role != "both":
        raise ValueError(
            "role='prefill'/'decode' needs the paged engine — the "
            "handoff moves physical KV pages between pools")
    if host_pages is not None:
        raise ValueError(
            "host_pages needs the paged engine (the host tier "
            "stores physical KV pages; the dense slot-lane path "
            "has none)")
    if prefix_caching:
        raise ValueError(
            "prefix_cache=True needs the paged engine (shared "
            "prefixes live in refcounted KV pages; the dense "
            "slot-lane path has no pages to share)")


def _speculate_knob(speculate) -> Tuple[object, int]:
    """``(draft_model, k)`` from the ``speculate`` knob, or ``(None, 0)``."""
    if speculate is None:
        return None, 0
    try:
        draft_model, k = speculate
    except (TypeError, ValueError):
        raise ValueError("speculate must be a (draft_model, k) pair")
    if int(k) < 1:
        raise ValueError("speculate k must be >= 1")
    return draft_model, int(k)


def _lane_page_bytes(model, page_size: int, cache_dtype) -> int:
    """What one page of ``model``'s lane costs across all its layers."""
    return model.num_hidden_layers * page_bytes(
        page_size, model.num_heads, model.hidden_size // model.num_heads,
        cache_dtype)


def static_generate(model, requests, *, max_slots: int, max_len: int,
                    device: DeviceLike = None, eos_id: Optional[int] = None,
                    pad_id: int = 0, cache_dtype: torch.dtype = torch.float32,
                    kernels=None,
                    prompt_buckets: Optional[Sequence[int]] = None,
                    page_size: int = 16, num_pages: Optional[int] = None,
                    prefill_chunk: Optional[int] = None,
                    quantize: Optional[str] = None, seed: int = 0,
                    sampling: Optional[Sequence[dict]] = None,
                    speculate: Optional[tuple] = None):
    """Run-to-completion static batching over the same kernels the
    engine uses: admit ``max_slots`` requests, decode until every one of
    them finishes, only then admit the next group. ``requests`` is a
    sequence of ``(prompt, max_new_tokens)``; returns ``(token lists,
    decode steps (or verify rounds) executed)``. The kernels are paged
    unless ``kernels`` is a dense :class:`DecodeKernels`, ``page_size``
    is 0 or the model has no paged API; then the run is greedy over
    dense lanes, with prompt buckets up to the longest prompt by
    default. ``quantize``,
    ``cache_dtype``, ``seed`` and ``speculate`` are the engine's knobs;
    ``sampling`` is an optional per-request list of dicts
    (``temperature`` / ``top_k`` / ``top_p`` / ``seed`` / ``grammar``).
    Seeds derive as the engine's do and grammar masks arm as the engine's
    do, so the engine and a static run emit the same streams, greedy or
    sampled, plain or speculative, constrained or not. A constrained
    stream that cannot parse raises :class:`GrammarViolation`."""
    module_device(model, device)
    draft_model, spec_k = _speculate_knob(speculate)
    if kernels is not None and hasattr(kernels, "verify") != (
            speculate is not None):
        raise ValueError(
            "speculate=(draft_model, k) and SpeculativeKernels go "
            "together: pass both or neither")
    paged = (hasattr(kernels, "chunk") if kernels is not None
             else bool(page_size) and hasattr(model, "decode_step_paged"))
    if not paged and cache_dtype == torch.int8:
        # the engine's refusal: the dense lanes have no scale pools, so an
        # int8 cache there would truncate K/V to zeros without an error
        raise ValueError(
            "cache_dtype='int8' needs the paged kernels (int8 KV lives in "
            "the page pools with per-token scale pools)")
    model = _serving_model(model, quantize, kernels)
    if speculate is not None:
        module_device(draft_model, device)
        draft_model = _serving_model(draft_model, quantize, kernels)
        kernels = kernels or SpeculativeKernels(model, draft_model)
    requests = [([int(t) for t in p], int(m)) for p, m in requests]
    if not paged:
        if sampling is not None:
            raise ValueError("sampling needs PagedDecodeKernels")
        return _static_generate_dense(
            model, requests, kernels or DecodeKernels(model),
            max_slots=max_slots, max_len=max_len, eos_id=eos_id,
            pad_id=pad_id, cache_dtype=cache_dtype,
            prompt_buckets=prompt_buckets)
    kernels = kernels or PagedDecodeKernels(model)
    run = _static_generate_spec if speculate is not None \
        else _static_generate_paged
    return run(model, requests, kernels, max_slots=max_slots,
               max_len=max_len, eos_id=eos_id, pad_id=pad_id,
               cache_dtype=cache_dtype, prompt_buckets=prompt_buckets,
               page_size=page_size, num_pages=num_pages,
               prefill_chunk=prefill_chunk, seed=seed, sampling=sampling,
               draft_model=draft_model, spec_k=spec_k)


def _static_generate_dense(model, requests, kernels, *, max_slots, max_len,
                           eos_id, pad_id, cache_dtype, prompt_buckets):
    """Greedy body of :func:`static_generate` over dense lanes: each group
    of ``max_slots`` prompts into slots 0.., then decode steps over every
    slot until each is done."""
    buckets = list(prompt_buckets
                   or bucket_sizes_for(max(len(p) for p, _ in requests)))
    cache = model.init_cache(max_slots, max_len, cache_dtype)
    outputs: List[Optional[List[int]]] = [None] * len(requests)
    total_steps = 0
    for base in range(0, len(requests), max_slots):
        states = []
        for slot, (prompt, mnt) in enumerate(requests[base:base + max_slots]):
            n = len(prompt)
            padded = np.full((next(b for b in buckets if b >= n),), pad_id,
                             np.int32)
            padded[:n] = prompt
            tok, cache = kernels.prefill(cache, slot, padded, n)
            tok = int(tok.item())
            target = min(mnt, max_len - n)
            states.append({"tokens": [tok], "last": tok, "pos": n,
                           "target": target,
                           "done": (eos_id is not None and tok == eos_id)
                           or target <= 1})
        while not all(s["done"] for s in states):
            tokens = np.zeros((max_slots,), np.int32)
            positions = np.zeros((max_slots,), np.int32)
            for slot, s in enumerate(states):
                tokens[slot] = s["last"]
                positions[slot] = s["pos"]
            toks_dev, cache = kernels.decode(cache, tokens, positions)
            toks = toks_dev.cpu().numpy()
            total_steps += 1
            for slot, s in enumerate(states):
                if s["done"]:
                    continue
                s["last"] = int(toks[slot])
                s["tokens"].append(s["last"])
                s["pos"] += 1
                s["done"] = _finished(s, eos_id, max_len)
        for i, s in enumerate(states):
            outputs[base + i] = s["tokens"]
    return outputs, total_steps


def _static_grammar_step(g, state, tok, eos_id, n_out):
    """``static_generate``'s per-token automaton advance: the engine's
    ``_grammar_step``, raising :class:`GrammarViolation` where the engine
    fails a stream."""
    if g is None or (eos_id is not None and tok == eos_id):
        return state
    state = g.advance(state, tok)
    if state < 0:
        raise GrammarViolation(
            f"token {tok} is not legal from the previous state",
            state=state, tokens_out=n_out, grammar_key=g.key)
    if not g.has_continuation(state) and not g.is_accepting(state):
        raise GrammarViolation(
            "stuck state: no legal continuation and no legal EOS over "
            "this vocabulary", state=state, tokens_out=n_out,
            grammar_key=g.key)
    return state


def _static_grammar_finish(g, state, tok, eos_id, n_out):
    """A static stream that stops on its budget or length must stop in an
    accepting state (one that stops on EOS always does)."""
    if g is None or (eos_id is not None and tok == eos_id):
        return
    if not g.is_accepting(state):
        raise GrammarViolation(
            "token budget exhausted before the grammar could complete",
            state=state, tokens_out=n_out, grammar_key=g.key)


class _StaticGroup:
    """The page pool, maps and per-slot sampling and mask rows of a static
    run, and the admission of one group's prompts into them."""

    def __init__(self, model, kernels, *, max_slots, max_len, pad_id,
                 cache_dtype, prompt_buckets, page_size, num_pages,
                 prefill_chunk, seed, sampling, draft_model, requests):
        self.lanes = 1 if draft_model is None else 2
        self.kernels, self.pad_id, self.max_len = kernels, pad_id, max_len
        self.seed, self.sampling = seed, sampling
        self.chunk = int(prefill_chunk or min(64, max_len - 1))
        longest = max(len(p) for p, _ in requests)
        self.buckets = list(prompt_buckets
                            or bucket_sizes_for(min(longest, self.chunk)))
        self.num_pages = int(num_pages or max_slots * self.lanes
                             * pages_per_lane(max_len, page_size))
        self.pool = PagePool(self.num_pages, page_size, max_len)
        self.cache = model.init_paged_cache(self.num_pages + 1, page_size,
                                            cache_dtype)
        self.dcache = None if draft_model is None else \
            draft_model.init_paged_cache(self.num_pages + 1, page_size,
                                         cache_dtype)
        shape = (max_slots, self.pool.pages_per_slot)
        self.page_map = np.full(shape, self.pool.trash, np.int32)
        self.dpage_map = np.full(shape, self.pool.trash, np.int32)
        self.temps = np.zeros((max_slots,), np.float32)
        self.top_ks = np.zeros((max_slots,), np.int32)
        self.top_ps = np.ones((max_slots,), np.float32)
        self.keys = np.zeros((max_slots, 2), np.uint32)
        vocab = getattr(model, "vocab_size", None)
        self.bias = (np.zeros((max_slots, int(vocab)), np.float32)
                     if vocab else None)
        self.stage = _HostStage(
            kernels.device,
            _stage_bytes(max_slots, self.pool.pages_per_slot, vocab,
                         max(self.chunk, self.buckets[-1])),
            depth=max_slots + 3 + (0 if draft_model is None else 8))
        self.constrained = False    # some slot of the group has a grammar

    def params(self):
        return self.temps, self.top_ks, self.top_ps, self.keys

    def step_bias(self, rows=None) -> Optional[torch.Tensor]:
        """The group's mask rows on the device, or None when no slot of
        the group is constrained (as the engine passes no bias then)."""
        if not self.constrained:
            return None
        return self.stage.upload(self.bias if rows is None else rows)

    def admit(self, slot: int, index: int, prompt: List[int], target: int):
        """Reserve the lanes of request ``index`` in ``slot``, arm its
        sampling and mask rows and run its prompt. -> (first token,
        pages, grammar)."""
        n = len(prompt)
        spec = dict(self.sampling[index] or {}) if self.sampling else {}
        req_seed = spec.get("seed")
        if req_seed is None:
            req_seed = request_seed(
                self.seed, np.asarray(prompt, np.int32).tobytes(), n)
        self.temps[slot] = float(spec.get("temperature", 0.0))
        self.top_ks[slot] = int(spec.get("top_k", 0))
        self.top_ps[slot] = float(spec.get("top_p", 1.0))
        key = threefry_key_data(req_seed)
        g = spec.get("grammar")
        bias1 = None
        if g is not None:
            if self.bias is None:
                raise ValueError("sampling['grammar'] needs a model "
                                 "exposing vocab_size")
            self.constrained = True
            self.bias[slot] = g.bias_row(g.start_state)
            bias1 = self.stage.upload(self.bias[slot:slot + 1])
        need = self.pool.pages_for(min(n + target - 1, self.max_len))
        if not self.pool.can_reserve(self.lanes * need):
            raise ValueError(
                f"num_pages={self.num_pages} cannot hold a static group "
                f"(needs {self.lanes * need} more pages) — grow the pool "
                f"or shrink max_slots")
        pages = []
        for owner, pmap in (("target", self.page_map),
                            ("draft", self.dpage_map))[:self.lanes]:
            pages += self.pool.alloc(need, owner=owner)
            pmap[slot, :] = self.pool.trash
            pmap[slot, :need] = pages[-need:]
        kernels, trash = self.kernels, self.pool.trash
        start = 0
        while True:
            final = n - start <= self.chunk
            width = next(b for b in self.buckets if b >= n - start) \
                if final else self.chunk
            piece = np.full((width,), self.pad_id, np.int32)
            real = min(width, n - start)
            piece[:real] = prompt[start:start + real]
            if not final:
                self.cache = kernels.chunk(self.cache, self.page_map[slot],
                                           piece, start, width, trash)
            elif self.dcache is None:
                tok, new_key, self.cache = kernels.prefill(
                    self.cache, self.page_map[slot], piece, start, real,
                    trash, self.temps[slot], self.top_ks[slot],
                    self.top_ps[slot], key, **_masked(bias1))
                key = new_key[0]
            else:
                tok, self.cache = kernels.prefill(
                    self.cache, self.page_map[slot], piece, start, real,
                    trash, self.temps[slot], self.top_ks[slot],
                    self.top_ps[slot], key, **_masked(bias1))
            if self.dcache is not None:
                self.dcache = kernels.draft_write(
                    self.dcache, self.dpage_map[slot], piece, start, real,
                    trash)
            if final:
                break
            start += width
        self.keys[slot] = key
        return int(tok.item()), pages, g

    def release(self, pages) -> None:
        self.pool.release(pages)
        for a in (self.page_map, self.dpage_map):
            a[:] = self.pool.trash
        self.temps[:] = 0.0
        self.top_ks[:] = 0
        self.top_ps[:] = 1.0
        self.keys[:] = 0
        if self.bias is not None:
            self.bias[:] = 0.0
        self.constrained = False


def _static_emit(g, s, tok, eos_id):
    """Append ``tok`` to static stream ``s`` and advance its automaton;
    True when the stream stopped on EOS."""
    s["tokens"].append(tok)
    if eos_id is not None and tok == eos_id:
        return True
    s["gstate"] = _static_grammar_step(g, s["gstate"], tok, eos_id,
                                       len(s["tokens"]))
    return False


def _static_settle(g_group, slot, s, eos_id, max_len):
    """After a stream's tokens of one step or round: arm its mask row,
    and decide whether it is done (EOS, its budget, the lane end; or, with
    no EOS id, a finished parse), checking the parse where it stops on
    its budget."""
    g = s["grammar"]
    if g is not None:
        g_group.bias[slot] = g.bias_row(s["gstate"])
    if _finished(s, eos_id, max_len):
        s["done"] = True
        _static_grammar_finish(g, s["gstate"], s["last"], eos_id,
                               len(s["tokens"]))
    elif (g is not None and eos_id is None
          and not g.has_continuation(s["gstate"])):
        s["done"] = True


def _static_groups(model, requests, kernels, *, max_slots, max_len, eos_id,
                   draft_model, **knobs):
    """Group-at-a-time admission for the static bodies: yields ``(group
    state, per-slot dicts)`` for each group of ``max_slots`` requests,
    with every prompt run and its first token drawn; fills ``outputs`` and
    releases the group's pages once the caller has run it to
    completion."""
    g = _StaticGroup(model, kernels, max_slots=max_slots, max_len=max_len,
                     draft_model=draft_model, requests=requests, **knobs)
    for base in range(0, len(requests), max_slots):
        states = []
        for slot, (prompt, mnt) in enumerate(
                requests[base:base + max_slots]):
            target = min(mnt, max_len - len(prompt))
            tok, pages, grammar = g.admit(slot, base + slot, prompt, target)
            s = {"index": base + slot, "tokens": [], "last": tok,
                 "pos": len(prompt), "target": target, "pages": pages,
                 "grammar": grammar, "done": False,
                 "gstate": None if grammar is None else grammar.start_state}
            _static_emit(grammar, s, tok, eos_id)
            _static_settle(g, slot, s, eos_id, max_len)
            states.append(s)
        yield g, states
        g.release([p for s in states for p in s["pages"]])


def _finished(s, eos_id, max_len) -> bool:
    return ((eos_id is not None and s["last"] == eos_id)
            or len(s["tokens"]) >= s["target"] or s["pos"] >= max_len)


def _static_generate_paged(model, requests, kernels, *, max_slots, max_len,
                           eos_id, spec_k, **knobs):
    outputs: List[Optional[List[int]]] = [None] * len(requests)
    total_steps = 0
    for g, states in _static_groups(model, requests, kernels,
                                    max_slots=max_slots, max_len=max_len,
                                    eos_id=eos_id, **knobs):
        while not all(s["done"] for s in states):
            tokens = np.zeros((max_slots,), np.int32)
            positions = np.zeros((max_slots,), np.int32)
            for slot, s in enumerate(states):
                tokens[slot] = s["last"]
                positions[slot] = s["pos"]
            toks_dev, g.keys, g.cache = kernels.decode(
                g.cache, tokens, positions, g.page_map, *g.params(),
                **_masked(g.step_bias()))
            toks = toks_dev.cpu().numpy()
            total_steps += 1
            for slot, s in enumerate(states):
                if s["done"]:
                    continue
                s["last"] = int(toks[slot])
                _static_emit(s["grammar"], s, s["last"], eos_id)
                s["pos"] += 1
                _static_settle(g, slot, s, eos_id, max_len)
        for s in states:
            outputs[s["index"]] = s["tokens"]
    return outputs, total_steps


def _static_generate_spec(model, requests, kernels, *, max_slots, max_len,
                          eos_id, spec_k, **knobs):
    """Speculative body of :func:`static_generate`: the engine's draft and
    verify rounds, group at a time, grammar masks walked on scratch
    states as the engine walks them. Draws are keyed by (request, output
    position), so the streams equal the engine's under any grouping.
    Returns ``(token lists, verify rounds executed)``."""
    outputs: List[Optional[List[int]]] = [None] * len(requests)
    total_rounds = 0
    for g, states in _static_groups(model, requests, kernels,
                                    max_slots=max_slots, max_len=max_len,
                                    eos_id=eos_id, **knobs):
        while not all(s["done"] for s in states):
            tokens, positions, out_base = (
                np.zeros((max_slots,), np.int32) for _ in range(3))
            for slot, s in enumerate(states):
                tokens[slot] = s["last"]
                positions[slot] = s["pos"]
                out_base[slot] = len(s["tokens"])
            glive = [(slot, s) for slot, s in enumerate(states)
                     if not s["done"] and s["grammar"] is not None]
            scratch = {slot: s["gstate"] for slot, s in glive}
            d_tokens, d_dists, biases = [], [], []
            cur = tokens
            for i in range(spec_k + 1):
                rows = None
                if g.constrained:
                    rows = g.bias.copy()
                    for slot, s in glive:
                        rows[slot] = s["grammar"].bias_row(scratch[slot])
                bias_i = g.step_bias(rows)
                pos_i = np.minimum(positions + i, max_len - 1)
                cur, dist, g.dcache = kernels.draft(
                    g.dcache, cur, pos_i, g.dpage_map, *g.params(),
                    out_base + i, **_masked(bias_i))
                if bias_i is not None:
                    biases.append(bias_i)
                    proposed = cur.cpu().numpy()
                    for slot, s in glive:
                        scratch[slot] = s["grammar"].advance(
                            scratch[slot], int(proposed[slot]))
                if i < spec_k:
                    d_tokens.append(cur)
                    d_dists.append(dist)
            n_dev, out_dev, g.cache = kernels.verify(
                g.cache, tokens, d_tokens, positions, g.page_map,
                g.pool.trash, *g.params(), out_base, d_dists,
                **_masked(torch.stack(biases, dim=1) if biases else None))
            n_acc = n_dev.cpu().numpy()
            outs = out_dev.cpu().numpy()
            total_rounds += 1
            for slot, s in enumerate(states):
                if s["done"]:
                    continue
                room = min(s["target"] - len(s["tokens"]),
                           max_len - s["pos"])
                pushed = 0
                for j in range(min(int(n_acc[slot]) + 1, room)):
                    pushed += 1
                    if _static_emit(s["grammar"], s, int(outs[slot, j]),
                                    eos_id):
                        break
                s["last"] = int(outs[slot, pushed - 1])
                s["pos"] += pushed
                _static_settle(g, slot, s, eos_id, max_len)
        for s in states:
            outputs[s["index"]] = s["tokens"]
    return outputs, total_rounds
