"""Serving metrics for the generation engine (a subset of
``bigdl_tpu/serving/metrics.py``): request outcomes, prefills and prompt
chunks, decode steps, tokens out, time to first token (p50/p95/p99 over a
bounded reservoir), page occupancy, the quantized-serving gauges (KV
bytes in use, KV cache dtype, int8 GEMMs), the tokens sampled at a
temperature above 0, the speculative tier's verify rounds (draft
tokens proposed, accepted, their rate), the prefix cache's probes (hits,
misses, prompt calls skipped, pages the index holds) and the KV tiers'
page moves (offloaded, restored, dropped, streams swapped out and in,
host pages resident), inter-token latency (ITL, p50/p95/p99) and failed
streams, and the grammar counters (constrained streams, compile-cache
hits, the mean masked share of the vocabulary). Lock-protected; the
snapshot keys keep the JAX package's names, each block after the ones
before it.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np

_M64 = (1 << 64) - 1


def _uniform01(seed: int, index: int) -> float:
    """Deterministic uniform draw in [0, 1) (splitmix64 finalizer over
    ``(seed, index)``, as ``bigdl_tpu/core/rng.py::uniform01``)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(index) * 0xBF58476D1CE4E5B9
         + 0x2545F4914F6CDD1D) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    x ^= x >> 31
    return (x >> 1) / float(1 << 63)


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
            j = int(_uniform01(self._seed, self.seen) * self.seen)
            if j < self.size:
                self.values[j] = v

    def percentiles(self, qs) -> Optional[List[float]]:
        if not self.values:
            return None
        return [float(p) for p in np.percentile(self.values, qs)]


class ServingMetrics:
    LATENCY_QS = (50, 95, 99)

    def __init__(self, reservoir_size: int = 2048):
        self._lock = threading.Lock()
        self.served = 0
        self.rejected = 0
        self.expired = 0
        self.prefills = 0         # final prompt chunks (one first token each)
        self.prefill_chunks = 0   # non-final chunk forwards
        self.decode_steps = 0
        self.tokens_out = 0
        self.pages_in_use = 0
        self.pages_total = 0
        self.pages_peak = 0
        self.kv_bytes_in_use = 0     # reserved KV bytes, scale pools incl.
        self.kv_cache_dtype = ""     # "" until a paged engine reports one
        self.quantized_gemms = 0     # int8 GEMMs in the serving model
        self.sampled_tokens = 0      # tokens from temperature > 0 slots
        self.draft_tokens = 0        # candidates the draft proposed
        self.accepted_tokens = 0     # candidates accepted and emitted
        self.verify_steps = 0        # target verify forwards
        self.prefix_hits = 0         # admissions that attached cached pages
        self.prefix_misses = 0       # admissions with no cached prefix
        self.shared_pages = 0        # pages the prefix index holds (gauge)
        self.prefill_chunks_skipped = 0  # prompt calls not executed
        self.kv_offload_pages = 0    # device->host prefix copies landed
        self.kv_restore_pages = 0    # host->device prefix copies
        self.kv_offload_dropped = 0  # offload candidates abandoned
        self.kv_swaps_out = 0        # streams parked under priority pressure
        self.kv_swaps_in = 0         # parked streams resumed
        self.host_pages = 0          # host-tier resident pages (gauge)
        self.host_bytes = 0          # host-tier resident bytes (gauge)
        self.host_pages_peak = 0
        self.failed = 0              # streams failed by a request error
        self.constrained_streams = 0         # grammar requests admitted
        self.grammar_compile_cache_hits = 0  # automaton reuses at submit
        self._masked_frac_sum = 0.0  # mean masked-vocab share over every
        self._masked_frac_n = 0      # armed constrained step
        self._ttft = _Reservoir(reservoir_size)      # submit -> 1st token
        # one sample per generated token past a stream's first: the gap
        # since that stream's previous token (the first token's wait is
        # TTFT). Prefill interference inflates it; disaggregation exists
        # to protect it
        self._itl = _Reservoir(reservoir_size)

    def record_served(self) -> None:
        with self._lock:
            self.served += 1

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

    def record_itl(self, gap_s: float, n: int = 1) -> None:
        """``n`` tokens of one stream arrived ``gap_s`` after the stream's
        previous token each (n > 1: a speculative round's gap spread over
        the tokens it pushed)."""
        with self._lock:
            for _ in range(int(n)):
                self._itl.add(gap_s)

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

    def record_prefill(self, ttft_s: float) -> None:
        """One final prompt chunk, which emits the first token."""
        with self._lock:
            self.prefills += 1
            self.tokens_out += 1
            self._ttft.add(ttft_s)

    def record_chunk(self) -> None:
        """One non-final prompt chunk forward (no token)."""
        with self._lock:
            self.prefill_chunks += 1

    def record_decode_step(self, n_active: int) -> None:
        """One decode step; each of ``n_active`` slots emits a token."""
        with self._lock:
            self.decode_steps += 1
            self.tokens_out += n_active

    def record_sampled(self, n: int) -> None:
        """``n`` tokens of this step came from temperature-sampled slots
        (the rest of ``tokens_out`` is greedy)."""
        with self._lock:
            self.sampled_tokens += int(n)

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
        """``n_pages`` offload candidates evicted without a copy (the
        in-flight copy cap)."""
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

    def snapshot(self) -> dict:
        with self._lock:
            ttft = self._ttft.percentiles(self.LATENCY_QS)
            itl = self._itl.percentiles(self.LATENCY_QS)
            return {
                "served": self.served,
                "rejected": self.rejected,
                "expired": self.expired,
                "prefills": self.prefills,
                "decode_steps": self.decode_steps,
                "tokens_out": self.tokens_out,
                "ttft_ms": None if ttft is None else {
                    f"p{q}": round(v * 1e3, 3)
                    for q, v in zip(self.LATENCY_QS, ttft)},
                "prefill_chunks": self.prefill_chunks,
                "pages_in_use": self.pages_in_use,
                "pages_total": self.pages_total,
                "pages_peak": self.pages_peak,
                "kv_bytes_in_use": self.kv_bytes_in_use,
                "kv_cache_dtype": self.kv_cache_dtype,
                "quantized_gemms": self.quantized_gemms,
                "sampled_tokens": self.sampled_tokens,
                "draft_tokens": self.draft_tokens,
                "accepted_tokens": self.accepted_tokens,
                "acceptance_rate": (self.accepted_tokens / self.draft_tokens
                                    if self.draft_tokens else 0.0),
                "verify_steps": self.verify_steps,
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "prefix_hit_rate": (
                    self.prefix_hits
                    / (self.prefix_hits + self.prefix_misses)
                    if self.prefix_hits + self.prefix_misses else 0.0),
                "shared_pages": self.shared_pages,
                "prefill_chunks_skipped": self.prefill_chunks_skipped,
                "kv_offload_pages": self.kv_offload_pages,
                "kv_restore_pages": self.kv_restore_pages,
                "kv_offload_dropped": self.kv_offload_dropped,
                "kv_swaps_out": self.kv_swaps_out,
                "kv_swaps_in": self.kv_swaps_in,
                "host_pages": self.host_pages,
                "host_bytes": self.host_bytes,
                "host_pages_peak": self.host_pages_peak,
                "itl_ms": None if itl is None else {
                    f"p{q}": round(v * 1e3, 3)
                    for q, v in zip(self.LATENCY_QS, itl)},
                "itl_samples": self._itl.seen,
                "failed": self.failed,
                "constrained_streams": self.constrained_streams,
                "grammar_compile_cache_hits":
                    self.grammar_compile_cache_hits,
                "masked_vocab_frac": (self._masked_frac_sum
                                      / self._masked_frac_n
                                      if self._masked_frac_n else 0.0),
            }
