"""Serving metrics for the generation engine
(``bigdl_tpu/serving/metrics.py``): lock-protected counters and
bounded-reservoir latency histograms, cheap enough to stay on in
production (O(1) per request, fixed memory).

The snapshot keeps the JAX package's keys in its order, each block after
the ones before it, without the keys of tiers this package has not
ported: the replica group (``replicas_total``, ``replicas_healthy``,
``replica_evictions``, ``replica_rejoins``, ``rolling_reloads``,
``replica_inflight``) and the autoscaler's recent-window views
(``ttft_recent_ms``, ``itl_recent_ms``, ``recent_window_s``).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

from bigdl_tpu_torch.core.rng import uniform01


class _Reservoir:
    """Fixed-size uniform sample of a stream (Vitter's algorithm R) with a
    keyed draw per element, so the sample replays exactly. Caller holds
    the metrics lock."""

    def __init__(self, size: int, seed: int = 0):
        self.size = size
        self.seen = 0
        self.values: List[float] = []
        self._seed = seed

    def add(self, v: float) -> None:
        self.seen += 1
        if len(self.values) < self.size:
            self.values.append(v)
        else:
            j = int(uniform01(self._seed, self.seen) * self.seen)
            if j < self.size:
                self.values[j] = v

    def percentiles(self, qs) -> Optional[List[float]]:
        if not self.values:
            return None
        return [float(p) for p in np.percentile(self.values, qs)]


def _ms(qs, values) -> Optional[dict]:
    """Percentiles in seconds as ``{"p50": ms, ...}``, or None."""
    if values is None:
        return None
    return {f"p{q}": round(v * 1e3, 3) for q, v in zip(qs, values)}


class ServingMetrics:
    """Counters and histograms of one engine (or of one front door over
    several). Every mutator takes the internal lock; ``snapshot()``
    returns a plain JSON-able dict and ``format_table()`` a fixed-width
    dump."""

    LATENCY_QS = (50, 95, 99)

    def __init__(self, reservoir_size: int = 2048):
        self._lock = threading.Lock()
        self.served = 0
        self.rejected = 0
        self.expired = 0
        self.failed = 0          # streams failed by a request error
        self.forwards = 0        # executed batched forwards
        self.batched_rows = 0    # real rows through a forward
        self.padded_rows = 0     # padding rows added to reach a bucket
        self.queue_depth = 0
        self._batch_sizes: Dict[int, int] = {}   # real rows per forward
        self._latency = _Reservoir(reservoir_size)      # submit -> done
        self._queue_wait = _Reservoir(reservoir_size)   # submit -> admit
        self.prefills = 0         # final prompt chunks (one first token each)
        self.prefill_tokens = 0   # real prompt tokens written to caches
        self.prefill_padded = 0   # pad tokens added to reach a bucket
        self.decode_steps = 0
        self.decode_active = 0    # sum over steps of slots serving
        self.decode_slot_rows = 0  # sum over steps of all slots
        self.tokens_out = 0
        self.reloads = 0          # hot weight swaps (service and engine)
        self._ttft = _Reservoir(reservoir_size)         # submit -> 1st token
        self._stream_rate = _Reservoir(reservoir_size)  # per-stream tokens/s
        self.prefill_chunks = 0   # non-final chunk forwards
        self.sampled_tokens = 0   # tokens from temperature > 0 slots
        self.pages_in_use = 0
        self.pages_total = 0
        self.pages_peak = 0
        self.kv_bytes_in_use = 0     # reserved KV bytes, scale pools incl.
        self.kv_cache_dtype = ""     # "" until a paged engine reports one
        self.quantized_gemms = 0     # int8 GEMMs in the serving model
        self.draft_tokens = 0        # candidates the draft proposed
        self.accepted_tokens = 0     # candidates accepted and emitted
        self.verify_steps = 0        # target verify forwards
        # the engine's step timeline, aggregated: scheduler iterations,
        # host time, and time inside the kernel-call regions
        self.engine_steps = 0
        self.step_host_s = 0.0
        self.step_device_s = 0.0
        self.prefix_hits = 0         # admissions that attached cached pages
        self.prefix_misses = 0       # admissions with no cached prefix
        self.shared_pages = 0        # pages the prefix index holds (gauge)
        self.prefill_chunks_skipped = 0  # prompt calls not executed
        # one sample per generated token past a stream's first: the gap
        # since that stream's previous token (the first token's wait is
        # TTFT). Prefill interference inflates it; disaggregation exists
        # to protect it
        self._itl = _Reservoir(reservoir_size)
        self.kv_offload_pages = 0    # device->host prefix copies landed
        self.kv_restore_pages = 0    # host->device prefix copies
        self.kv_offload_dropped = 0  # offload candidates abandoned
        self.kv_swaps_out = 0        # streams parked under priority pressure
        self.kv_swaps_in = 0         # parked streams resumed
        self.host_pages = 0          # host-tier resident pages (gauge)
        self.host_bytes = 0          # host-tier resident bytes (gauge)
        self.host_pages_peak = 0
        # async scheduling: iterations whose host work ran while a decode
        # step was in flight on the device
        self.overlapped_steps = 0
        self.constrained_streams = 0         # grammar requests admitted
        self.grammar_compile_cache_hits = 0  # automaton reuses at submit
        self._masked_frac_sum = 0.0  # mean masked-vocab share over every
        self._masked_frac_n = 0      # armed constrained step

    # ------------------------------------------------------- mutators ----

    def record_batch(self, n_real: int, n_padded: int) -> None:
        """One batched forward of ``n_real`` rows padded to ``n_padded``."""
        with self._lock:
            self.forwards += 1
            self.batched_rows += n_real
            self.padded_rows += n_padded - n_real
            self._batch_sizes[n_real] = self._batch_sizes.get(n_real, 0) + 1

    def record_served(self, latency_s: float, queue_wait_s: float) -> None:
        """One request served: submit to done, and submit to admission."""
        with self._lock:
            self.served += 1
            self._latency.add(latency_s)
            self._queue_wait.add(queue_wait_s)

    def record_rejected(self) -> None:
        with self._lock:
            self.rejected += 1

    def record_expired(self) -> None:
        with self._lock:
            self.expired += 1

    def record_failed(self, n: int = 1) -> None:
        """``n`` streams failed with a request-scoped error (a handoff
        that raised, a grammar violation)."""
        with self._lock:
            self.failed += int(n)

    def set_queue_depth(self, depth: int) -> None:
        with self._lock:
            self.queue_depth = int(depth)

    def record_prefill(self, n_prompt: int, n_padded: int,
                       ttft_s: Optional[float] = None) -> None:
        """One final prompt chunk, which emits the first token: ``n_prompt``
        real tokens padded up to the ``n_padded`` bucket; ``ttft_s`` is
        submit to first token."""
        with self._lock:
            self.prefills += 1
            self.prefill_tokens += n_prompt
            self.prefill_padded += n_padded - n_prompt
            self.tokens_out += 1
            if ttft_s is not None:
                self._ttft.add(ttft_s)

    def record_reload(self) -> None:
        """One hot swap of the serving weights."""
        with self._lock:
            self.reloads += 1

    def record_chunk(self, n_real: int, n_padded: int) -> None:
        """One non-final prompt chunk forward (no token); its tokens count
        toward the prompt totals."""
        with self._lock:
            self.prefill_chunks += 1
            self.prefill_tokens += n_real
            self.prefill_padded += n_padded - n_real

    def record_decode_step(self, n_active: int, n_slots: int) -> None:
        """One decode step serving ``n_active`` of ``n_slots`` slots; each
        active slot emits a token."""
        with self._lock:
            self.decode_steps += 1
            self.decode_active += n_active
            self.decode_slot_rows += n_slots
            self.tokens_out += n_active

    def record_stream(self, n_tokens: int, duration_s: float) -> None:
        """One finished stream's rate (tokens generated / submit to
        done)."""
        with self._lock:
            if duration_s > 0:
                self._stream_rate.add(n_tokens / duration_s)

    def record_itl(self, gap_s: float, n: int = 1) -> None:
        """``n`` tokens of one stream arrived ``gap_s`` after the stream's
        previous token each (n > 1: a speculative round's gap spread over
        the tokens it pushed)."""
        with self._lock:
            for _ in range(int(n)):
                self._itl.add(gap_s)

    def record_sampled(self, n: int) -> None:
        """``n`` tokens of this step came from temperature-sampled slots
        (the rest of ``tokens_out`` is greedy)."""
        with self._lock:
            self.sampled_tokens += int(n)

    def set_pages(self, in_use: int, total: int) -> None:
        with self._lock:
            self.pages_in_use = in_use
            self.pages_total = total
            self.pages_peak = max(self.pages_peak, in_use)

    def set_kv_cache(self, bytes_in_use: int, dtype: str) -> None:
        """KV byte-occupancy gauge: bytes the reserved pages cost in the
        cache's own dtype, scale pools included."""
        with self._lock:
            self.kv_bytes_in_use = int(bytes_in_use)
            self.kv_cache_dtype = str(dtype)

    def set_quantized_gemms(self, n: int) -> None:
        """How many GEMMs of the serving model run int8 (0 = float)."""
        with self._lock:
            self.quantized_gemms = int(n)

    def record_verify_step(self, n_draft: int, n_accepted: int,
                           n_extra_tokens: int = 0) -> None:
        """One speculative round's verify forward: the draft proposed
        ``n_draft`` candidates across the batch and ``n_accepted`` of them
        were accepted and emitted; ``n_extra_tokens`` are the round's
        tokens beyond the one per active slot that
        :meth:`record_decode_step` counted, folded into ``tokens_out``."""
        with self._lock:
            self.verify_steps += 1
            self.draft_tokens += int(n_draft)
            self.accepted_tokens += int(n_accepted)
            self.tokens_out += int(n_extra_tokens)

    def record_engine_step(self, host_s: float, device_s: float,
                           overlapped: bool = False) -> None:
        """One engine scheduler iteration: ``host_s`` of host scheduling
        and bookkeeping, ``device_s`` inside the iteration's kernel-call
        regions (prompt calls and the decode step or round).
        ``overlapped`` marks an async iteration whose host work ran under
        an in-flight decode step."""
        with self._lock:
            self.engine_steps += 1
            self.step_host_s += float(host_s)
            self.step_device_s += float(device_s)
            if overlapped:
                self.overlapped_steps += 1

    def record_constrained_stream(self) -> None:
        """One grammar-constrained request reached admission."""
        with self._lock:
            self.constrained_streams += 1

    def record_grammar_cache_hit(self) -> None:
        """A submit reused a grammar key this engine had already served:
        its automaton came from the compile cache."""
        with self._lock:
            self.grammar_compile_cache_hits += 1

    def record_masked_frac(self, frac: float) -> None:
        """The share of the vocabulary the just-armed mask row excludes
        (one sample per armed constrained step; the snapshot reports the
        mean)."""
        with self._lock:
            self._masked_frac_sum += float(frac)
            self._masked_frac_n += 1

    def record_prefix_probe(self, hit: bool,
                            chunks_skipped: int = 0) -> None:
        """One admission's prefix-cache probe: ``hit`` when cached pages
        were attached, ``chunks_skipped`` the prompt calls (chunks and the
        final prefill) the attach made unnecessary."""
        with self._lock:
            if hit:
                self.prefix_hits += 1
            else:
                self.prefix_misses += 1
            self.prefill_chunks_skipped += int(chunks_skipped)

    def set_shared_pages(self, n: int) -> None:
        """Pages the prefix index currently holds references for."""
        with self._lock:
            self.shared_pages = int(n)

    def record_offload(self, n_pages: int) -> None:
        """``n_pages`` prefix pages crossed device->host (the copy landed
        and the host store filed them)."""
        with self._lock:
            self.kv_offload_pages += int(n_pages)

    def record_restore(self, n_pages: int) -> None:
        """``n_pages`` prefix pages crossed host->device."""
        with self._lock:
            self.kv_restore_pages += int(n_pages)

    def record_offload_dropped(self, n_pages: int = 1) -> None:
        """``n_pages`` offload candidates evicted without a copy (an
        injected ``kv.offload`` fault, or the in-flight copy cap)."""
        with self._lock:
            self.kv_offload_dropped += int(n_pages)

    def record_swap_out(self) -> None:
        """One active stream exported its pages and parked."""
        with self._lock:
            self.kv_swaps_out += 1

    def record_swap_in(self) -> None:
        """One parked stream re-adopted its pages and resumed."""
        with self._lock:
            self.kv_swaps_in += 1

    def set_host_pages(self, pages: int, bytes_used: int) -> None:
        """Host-tier residency (prefix entries and parked streams)."""
        with self._lock:
            self.host_pages = int(pages)
            self.host_bytes = int(bytes_used)
            self.host_pages_peak = max(self.host_pages_peak, int(pages))

    # -------------------------------------------------------- readers ----

    def snapshot(self) -> dict:
        """Point-in-time dict of every counter and distribution, in the
        JAX package's key order."""
        qs = self.LATENCY_QS
        with self._lock:
            padded_total = self.batched_rows + self.padded_rows
            prompt_total = self.prefill_tokens + self.prefill_padded
            rate = self._stream_rate.percentiles((50,))
            host_dev = self.step_host_s + self.step_device_s
            return {
                "served": self.served,
                "rejected": self.rejected,
                "expired": self.expired,
                "failed": self.failed,
                "forwards": self.forwards,
                "queue_depth": self.queue_depth,
                "batch_size_dist": dict(sorted(self._batch_sizes.items())),
                "mean_batch_size": (self.batched_rows / self.forwards
                                    if self.forwards else 0.0),
                "padding_waste": (self.padded_rows / padded_total
                                  if padded_total else 0.0),
                "latency_ms": _ms(qs, self._latency.percentiles(qs)),
                "queue_wait_ms": _ms(qs, self._queue_wait.percentiles(qs)),
                "latency_samples": self._latency.seen,
                "prefills": self.prefills,
                "decode_steps": self.decode_steps,
                "tokens_out": self.tokens_out,
                "reloads": self.reloads,
                "slot_occupancy": (self.decode_active / self.decode_slot_rows
                                   if self.decode_slot_rows else 0.0),
                "prompt_padding_waste": (self.prefill_padded / prompt_total
                                         if prompt_total else 0.0),
                "ttft_ms": _ms(qs, self._ttft.percentiles(qs)),
                "stream_tokens_per_sec": (None if rate is None
                                          else round(rate[0], 2)),
                "prefill_chunks": self.prefill_chunks,
                "sampled_tokens": self.sampled_tokens,
                "pages_in_use": self.pages_in_use,
                "pages_total": self.pages_total,
                "pages_peak": self.pages_peak,
                "page_occupancy": (self.pages_in_use / self.pages_total
                                   if self.pages_total else 0.0),
                "kv_bytes_in_use": self.kv_bytes_in_use,
                "kv_cache_dtype": self.kv_cache_dtype,
                "quantized_gemms": self.quantized_gemms,
                "draft_tokens": self.draft_tokens,
                "accepted_tokens": self.accepted_tokens,
                "acceptance_rate": (self.accepted_tokens / self.draft_tokens
                                    if self.draft_tokens else 0.0),
                "verify_steps": self.verify_steps,
                "engine_steps": self.engine_steps,
                "step_host_ms": round(self.step_host_s * 1e3, 3),
                "step_device_ms": round(self.step_device_s * 1e3, 3),
                "step_host_frac": (self.step_host_s / host_dev
                                   if host_dev else 0.0),
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "prefix_hit_rate": (
                    self.prefix_hits
                    / (self.prefix_hits + self.prefix_misses)
                    if self.prefix_hits + self.prefix_misses else 0.0),
                "shared_pages": self.shared_pages,
                "prefill_chunks_skipped": self.prefill_chunks_skipped,
                "itl_ms": _ms(qs, self._itl.percentiles(qs)),
                "itl_samples": self._itl.seen,
                "kv_offload_pages": self.kv_offload_pages,
                "kv_restore_pages": self.kv_restore_pages,
                "kv_offload_dropped": self.kv_offload_dropped,
                "kv_swaps_out": self.kv_swaps_out,
                "kv_swaps_in": self.kv_swaps_in,
                "host_pages": self.host_pages,
                "host_bytes": self.host_bytes,
                "host_pages_peak": self.host_pages_peak,
                "overlapped_steps": self.overlapped_steps,
                "step_overlap_frac": (self.overlapped_steps
                                      / self.engine_steps
                                      if self.engine_steps else 0.0),
                "constrained_streams": self.constrained_streams,
                "grammar_compile_cache_hits":
                    self.grammar_compile_cache_hits,
                "masked_vocab_frac": (self._masked_frac_sum
                                      / self._masked_frac_n
                                      if self._masked_frac_n else 0.0),
            }

    def format_table(self) -> str:
        """Fixed-width dump of the snapshot. A block of rows appears only
        when its tier reported something, each after the ones before it,
        as in the JAX package (whose replica rows this package does not
        have)."""
        s = self.snapshot()
        lines = [f"{'metric':<26} {'value':>18}"]

        def row(name, value):
            lines.append(f"{name:<26} {value:>18}")

        for k in ("served", "rejected", "expired", "failed", "forwards",
                  "queue_depth"):
            row(k, s[k])
        row("mean_batch_size", f"{s['mean_batch_size']:.2f}")
        row("padding_waste", f"{s['padding_waste'] * 100:.1f}%")
        dist = " ".join(f"{k}:{v}" for k, v in s["batch_size_dist"].items())
        row("batch_size_dist", dist or "-")
        for key in ("latency_ms", "queue_wait_ms"):
            if s[key]:
                for q, v in s[key].items():
                    row(f"{key[:-3]}_{q}(ms)", f"{v:.3f}")
        if s["prefills"] or s["decode_steps"] or s["tokens_out"]:
            row("tokens_out", s["tokens_out"])
            row("prefills", s["prefills"])
            row("decode_steps", s["decode_steps"])
            row("slot_occupancy", f"{s['slot_occupancy'] * 100:.1f}%")
            row("prompt_padding_waste",
                f"{s['prompt_padding_waste'] * 100:.1f}%")
            if s["ttft_ms"]:
                for q, v in s["ttft_ms"].items():
                    row(f"ttft_{q}(ms)", f"{v:.3f}")
            if s["stream_tokens_per_sec"] is not None:
                row("stream_tokens/s_p50", f"{s['stream_tokens_per_sec']:.2f}")
        if s["pages_total"] or s["prefill_chunks"] or s["sampled_tokens"]:
            row("pages_in_use", s["pages_in_use"])
            row("pages_total", s["pages_total"])
            row("pages_peak", s["pages_peak"])
            row("page_occupancy", f"{s['page_occupancy'] * 100:.1f}%")
            row("prefill_chunks", s["prefill_chunks"])
            row("sampled_tokens", s["sampled_tokens"])
        if s["reloads"]:
            row("reloads", s["reloads"])
        if s["kv_cache_dtype"] or s["quantized_gemms"]:
            row("kv_bytes_in_use", s["kv_bytes_in_use"])
            row("kv_cache_dtype", s["kv_cache_dtype"] or "-")
            row("quantized_gemms", s["quantized_gemms"])
        if s["verify_steps"]:
            row("draft_tokens", s["draft_tokens"])
            row("accepted_tokens", s["accepted_tokens"])
            row("acceptance_rate", f"{s['acceptance_rate'] * 100:.1f}%")
            row("verify_steps", s["verify_steps"])
        if s["engine_steps"]:
            row("engine_steps", s["engine_steps"])
            row("step_host_ms", f"{s['step_host_ms']:.3f}")
            row("step_device_ms", f"{s['step_device_ms']:.3f}")
            row("step_host_frac", f"{s['step_host_frac'] * 100:.1f}%")
        if s["prefix_hits"] or s["prefix_misses"] or s["shared_pages"]:
            row("prefix_hits", s["prefix_hits"])
            row("prefix_misses", s["prefix_misses"])
            row("prefix_hit_rate", f"{s['prefix_hit_rate'] * 100:.1f}%")
            row("shared_pages", s["shared_pages"])
            row("prefill_chunks_skipped", s["prefill_chunks_skipped"])
        if s["itl_samples"]:
            for q, v in s["itl_ms"].items():
                row(f"itl_{q}(ms)", f"{v:.3f}")
            row("itl_samples", s["itl_samples"])
        if (s["kv_offload_pages"] or s["kv_restore_pages"]
                or s["kv_swaps_out"] or s["host_pages"]
                or s["kv_offload_dropped"]):
            row("kv_offload_pages", s["kv_offload_pages"])
            row("kv_restore_pages", s["kv_restore_pages"])
            row("kv_offload_dropped", s["kv_offload_dropped"])
            row("kv_swaps_out", s["kv_swaps_out"])
            row("kv_swaps_in", s["kv_swaps_in"])
            row("host_pages", s["host_pages"])
            row("host_bytes", s["host_bytes"])
            row("host_pages_peak", s["host_pages_peak"])
        if s["overlapped_steps"]:
            row("overlapped_steps", s["overlapped_steps"])
            row("step_overlap_frac",
                f"{s['step_overlap_frac'] * 100:.1f}%")
        if s["constrained_streams"]:
            row("constrained_streams", s["constrained_streams"])
            row("grammar_compile_cache_hits",
                s["grammar_compile_cache_hits"])
            row("masked_vocab_frac",
                f"{s['masked_vocab_frac'] * 100:.1f}%")
        return "\n".join(lines)
