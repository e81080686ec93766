"""Host-side serving pieces of the port against the JAX package's:
page accounting, prompt buckets, typed errors, metrics."""

import jax.numpy as jnp
import pytest
import torch

from bigdl_tpu.serving import batcher as jax_batcher
from bigdl_tpu.serving import errors as jax_errors
from bigdl_tpu.serving import paging as jax_paging
from bigdl_tpu_torch.serving import (
    DeadlineExceeded,
    Overloaded,
    PagePool,
    ServingMetrics,
    bucket_sizes_for,
    page_bytes,
    pages_per_lane,
)


class TestPagePool:
    def test_smallest_first_and_reuse(self):
        pool = PagePool(8, 4, 32)
        assert pool.trash == 8 and pool.pages_per_slot == 8
        a = pool.alloc(3)
        b = pool.alloc(2)
        assert a == [0, 1, 2] and b == [3, 4]
        assert pool.in_use == 5 and pool.free_pages == 3
        pool.release(a)
        assert pool.alloc(4) == [0, 1, 2, 5]
        assert pool.in_use == 6

    def test_allocation_sequence_matches_jax_pool(self):
        ours, ref = PagePool(10, 4, 40), jax_paging.PagePool(10, 4, 40)
        script = [("a", 3), ("a", 2), ("r", 0), ("a", 4), ("r", 1),
                  ("a", 1), ("a", 2)]
        got_o, got_r = [], []
        for op, n in script:
            if op == "a":
                got_o.append(ours.alloc(n))
                got_r.append(ref.alloc(n))
            else:
                ours.release(got_o[n])
                ref.release(got_r[n])
        assert got_o == got_r
        assert (ours.in_use, ours.free_pages) == (ref.in_use, ref.free_pages)

    def test_double_release_raises(self):
        pool = PagePool(4, 4, 16)
        pages = pool.alloc(2)
        pool.release(pages)
        with pytest.raises(RuntimeError, match="not reserved"):
            pool.release(pages[:1])
        with pytest.raises(RuntimeError, match="not reserved"):
            pool.release([pool.trash])

    def test_exhaustion_and_can_reserve(self):
        pool = PagePool(3, 4, 12)
        assert pool.can_reserve(3) and not pool.can_reserve(4)
        pool.alloc(2)
        assert not pool.can_reserve(2)
        with pytest.raises(RuntimeError, match="exhausted"):
            pool.alloc(2)

    @pytest.mark.parametrize("n_tokens", [0, 1, 4, 5, 16, 17])
    def test_pages_for_matches_jax(self, n_tokens):
        assert PagePool(8, 4, 32).pages_for(n_tokens) == \
            jax_paging.PagePool(8, 4, 32).pages_for(n_tokens)

    def test_rejects_bad_sizes(self):
        with pytest.raises(ValueError):
            PagePool(0, 4, 16)
        with pytest.raises(ValueError):
            PagePool(4, 0, 16)


@pytest.mark.parametrize("max_len, page_size", [(256, 16), (48, 5), (7, 8)])
def test_pages_per_lane_matches_jax(max_len, page_size):
    assert pages_per_lane(max_len, page_size) == \
        jax_paging.pages_per_lane(max_len, page_size)


@pytest.mark.parametrize("dtype, jdtype", [(torch.float32, jnp.float32),
                                           (torch.bfloat16, jnp.bfloat16),
                                           (torch.int8, jnp.int8)])
def test_page_bytes_matches_jax(dtype, jdtype):
    """int8 pages carry one fp32 scale per K and per V row."""
    assert page_bytes(16, 8, 64, dtype) == jax_paging.page_bytes(
        16, 8, 64, jdtype)


@pytest.mark.parametrize("n", [1, 2, 5, 16, 33])
def test_bucket_sizes_match_jax(n):
    assert bucket_sizes_for(n) == jax_batcher.bucket_sizes_for(n)


def test_bucket_sizes_reject_zero():
    with pytest.raises(ValueError):
        bucket_sizes_for(0)


def test_errors_carry_jax_messages():
    assert str(Overloaded(4, 4)) == str(jax_errors.Overloaded(4, 4))
    assert str(DeadlineExceeded(0.5, 0.25)) == str(
        jax_errors.DeadlineExceeded(0.5, 0.25))


def test_metrics_snapshot_counts():
    m = ServingMetrics()
    assert m.snapshot()["ttft_ms"] is None
    m.record_prefill(3, 4, 0.010)
    m.record_prefill(5, 8, 0.030)
    m.record_chunk(4, 4)
    m.record_decode_step(2, 4)
    m.set_pages(6, 10)
    m.set_pages(2, 10)
    m.record_served(0.05, 0.01)
    snap = m.snapshot()
    assert snap["prefills"] == 2 and snap["prefill_chunks"] == 1
    assert snap["decode_steps"] == 1 and snap["tokens_out"] == 4
    assert snap["slot_occupancy"] == pytest.approx(0.5)
    assert snap["prompt_padding_waste"] == pytest.approx(4 / 16)
    assert snap["latency_ms"]["p50"] == pytest.approx(50.0)
    assert snap["queue_wait_ms"]["p50"] == pytest.approx(10.0)
    assert snap["pages_in_use"] == 2 and snap["pages_peak"] == 6
    assert snap["ttft_ms"]["p50"] == pytest.approx(20.0)
    assert snap["ttft_ms"]["p99"] == pytest.approx(29.8)
    assert snap["served"] == 1


def test_metrics_quantized_serving_gauges():
    m = ServingMetrics()
    snap = m.snapshot()
    assert (snap["kv_bytes_in_use"], snap["kv_cache_dtype"],
            snap["quantized_gemms"]) == (0, "", 0)
    m.set_kv_cache(4096, "int8")
    m.set_quantized_gemms(25)
    snap = m.snapshot()
    assert (snap["kv_bytes_in_use"], snap["kv_cache_dtype"],
            snap["quantized_gemms"]) == (4096, "int8", 25)
    # the quantized block follows the page gauges; the speculative,
    # step-timeline, prefix-cache, ITL, KV-tier, async and grammar rows
    # append after it, in the JAX package's order
    keys = list(snap)
    at = keys.index("page_occupancy") + 1
    assert keys[at - 2] == "pages_peak"
    assert keys[at:at + 3] == ["kv_bytes_in_use", "kv_cache_dtype",
                               "quantized_gemms"]
    assert keys[at + 3:] == ["draft_tokens",
                             "accepted_tokens", "acceptance_rate",
                             "verify_steps"] + ["engine_steps",
        "step_host_ms", "step_device_ms", "step_host_frac"] + [
        "prefix_hits", "prefix_misses",
        "prefix_hit_rate", "shared_pages", "prefill_chunks_skipped"] + [
        "itl_ms", "itl_samples"] + [
        "kv_offload_pages", "kv_restore_pages", "kv_offload_dropped",
        "kv_swaps_out", "kv_swaps_in", "host_pages", "host_bytes",
        "host_pages_peak"] + ["overlapped_steps", "step_overlap_frac"] + [
        "constrained_streams", "grammar_compile_cache_hits",
        "masked_vocab_frac"]


def test_metrics_reservoir_is_bounded_and_replays():
    runs = []
    for _ in range(2):
        m = ServingMetrics(reservoir_size=8)
        for i in range(100):
            m.record_prefill(1, 1, i / 1000)
        runs.append(m.snapshot()["ttft_ms"])
    assert runs[0] == runs[1] and len(m._ttft.values) == 8
