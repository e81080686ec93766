"""The port's host KV tier on the CPU: the host page store, host offload
and restore of evicted prefix pages, and priority swap-out.

- ``HostPageStore`` against the JAX package's over the same seeded op
  sequence (put, take, has, drop, park, unpark, clear): equal return
  values and snapshots at every step. Leaf-first eviction of the port's
  ``PrefixCache`` as the JAX tests pin it.
- On weights bridged from JAX, a ``host_pages`` engine gives the JAX
  engine's greedy streams and its offloaded, restored and skipped counts
  over a workload whose working set overflows the device pool.
- Inside the port, bitwise: host tier on == off (greedy and sampled,
  float and int8 pools); a swapped-out stream resumes with the tokens of
  a run with no swap (greedy and sampled); equal priorities never swap;
  the knob's checks; both tiers drain to zero on close, cancel and
  ``close(drain=False)``.
- The copy path: ``PageBlockMover`` gathers and scatters every pool leaf
  in place; a copy that has not landed is never filed, and past two in
  flight an evicted page is dropped and counted.
"""

import gc
import time

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.serving import GenerationEngine as JaxEngine
from bigdl_tpu.serving import HostPageStore as JaxHostPageStore
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.nn import Transformer
from bigdl_tpu_torch.nn.quantized import quantize_for_serving
from bigdl_tpu_torch.serving import (
    GenerationEngine,
    HostCopier,
    HostPageStore,
    PageBlockMover,
    PagePool,
    PrefixCache,
    ServingMetrics,
)

CFG = dict(max_slots=2, max_len=48, page_size=4, prefill_chunk=4)
# the JAX engines' shape (``jax_paged_kernels`` compiles its steps once):
# a 32-page pool
JAX_CFG = dict(max_slots=4, max_len=32, page_size=4, prefill_chunk=4)
RESULT_TIMEOUT = 60
SAMPLED = dict(temperature=0.9, top_k=20, top_p=0.95)
SWAP_SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95, seed=7)


def family_prompts():
    """Four 3-page prefix families, two tails each (12 published pages
    against a 12-page pool), then a revisit of every family and a
    chunk-spanning tail: admissions evict, and the revisits restore."""
    fams = [[int(t) for t in np.random.RandomState(100 + i).randint(1, 60, 12)]
            for i in range(4)]
    long_tail = [int(t) for t in np.random.RandomState(9).randint(1, 60, 7)]
    first = [f + t for f in fams for t in ([1, 2], [3, 4])]
    revisit = [f + [5, 6] for f in fams] + [fams[0] + long_tail]
    return first, revisit


@pytest.fixture(scope="module")
def lm(jax_lm):
    jm, params = jax_lm       # JaxTransformer(64, 32, 4, 64, 2), key(2)
    tm = load_jax_params(Transformer(64, 32, 4, 64, 2, device="cpu"),
                         jax.device_get(params))
    return jm, params, tm, quantize_for_serving(tm)


def make_engine(lm, model=None, **kw):
    cfg = dict(CFG, device="cpu")
    cfg.update(kw)
    return GenerationEngine(lm[2] if model is None else model, **cfg)


def _close(engine):
    host = engine.host_store
    engine.close()
    assert engine.pages_in_use == 0 and engine.shared_pages == 0
    assert engine.host_pages_in_use == 0
    assert host is None or host.snapshot()["by_owner"] == {}
    snap = engine.metrics.snapshot()
    assert snap["host_pages"] == 0 and snap["host_bytes"] == 0
    return snap


# ------------------------------------------- host structures vs JAX ----


@pytest.mark.parametrize("seed", range(12))
def test_host_store_matches_jax_over_seeded_ops(seed):
    rs = np.random.RandomState(seed)
    stores = (HostPageStore(5, page_bytes=96),
              JaxHostPageStore(5, page_bytes=96))

    def both(fn, rows=False):
        got = [fn(st) for st in stores]
        if rows:      # host rows: a tensor on one side, numpy on the other
            got = [None if g is None else np.asarray(g) for g in got]
            assert (got[0] is None) == (got[1] is None)
            assert got[0] is None or np.array_equal(got[0], got[1])
        else:
            assert got[0] == got[1], got
        assert stores[0].snapshot() == stores[1].snapshot()
        assert (stores[0].pages, stores[0].bytes_used,
                stores[0].prefix_pages, stores[0].stream_pages) == (
            stores[1].pages, stores[1].bytes_used,
            stores[1].prefix_pages, stores[1].stream_pages)

    for _ in range(150):
        op = rs.choice(["put", "take", "has", "drop", "record", "park",
                        "unpark", "clear"],
                       p=[.3, .2, .15, .08, .05, .1, .1, .02])
        version = int(rs.randint(2))
        key = tuple(int(t) for t in rs.randint(1, 4, rs.randint(1, 4)))
        if op == "put":
            value = rs.rand(3).astype(np.float32)
            rows = (torch.from_numpy(value.copy()), value)
            it = iter(rows)
            both(lambda st: st.put_prefix(version, key, next(it)))
        elif op == "take":
            both(lambda st: st.take_prefix(version, key), rows=True)
        elif op == "has":
            both(lambda st: st.has_prefix(version, key))
        elif op == "drop":
            both(lambda st: st.drop_prefix(version, key))
        elif op == "record":
            n = int(rs.randint(1, 3))
            both(lambda st: st.record_drop(n))
        elif op == "park":
            swap_id, n = int(rs.randint(4)), int(rs.randint(1, 6))
            both(lambda st: st.park_stream(swap_id, n))
        elif op == "unpark":
            swap_id = int(rs.randint(4))
            both(lambda st: st.unpark_stream(swap_id))
        else:
            both(lambda st: st.clear())


def test_host_store_capacity_validation():
    with pytest.raises(ValueError):
        HostPageStore(0)


def _two_branch_tree():
    """root -> n1 {n2 -> n3, n4}: chain A (3 pages, stamp 1) and a younger
    branch B sharing the first page (n1, n4 stamped 2)."""
    pool = PagePool(16, 4, 32)
    cache = PrefixCache(pool)
    a = list(range(1, 13))
    b = a[:4] + list(range(21, 25))
    for prompt, n in ((a, 3), (b, 2)):
        pages = pool.alloc(n)
        cache.publish(prompt, pages)
        pool.release(pages)
    assert cache.pages == 4
    return pool, cache, a, b


def test_leaf_first_eviction_keeps_the_shorter_shared_prefix():
    _, cache, a, b = _two_branch_tree()
    assert cache.evict(2) == 2
    assert cache.lookup(a + [63])[0] == 8       # n1 -> n2 survive
    assert len(cache.match_pages(b, 2)) == 1    # n4 went


def test_eviction_rounds_offer_the_shortest_prefix_last():
    pool, cache, a, b = _two_branch_tree()
    order = []
    cache.evict(4, on_evict=lambda prefix, page: order.append(prefix))
    assert cache.pages == 0 and pool.in_use == 0
    c1, c2, c3, c4 = (tuple(a[:4]), tuple(a[4:8]), tuple(a[8:12]),
                      tuple(b[4:8]))
    assert order == [c1 + c2 + c3, c1 + c4, c1 + c2, c1]


def test_protect_shields_the_matched_chain():
    _, cache, a, _ = _two_branch_tree()
    _, _, nodes = cache.lookup(a + [63])
    assert cache.evict(4, protect=frozenset(nodes)) == 1
    assert cache.pages == 3


# --------------------------------------------------- the copy path ----


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_mover_gathers_and_scatters_every_leaf_in_place(lm, dtype):
    tm = lm[2]
    cache = tm.init_paged_cache(9, 4, dtype)
    g = torch.Generator().manual_seed(0)
    for leaves in cache.values():
        for leaf in leaves:
            leaf.copy_(torch.randint(-100, 100, leaf.shape, generator=g)
                       .to(leaf.dtype))
    before = {n: tuple(t.clone() for t in ls) for n, ls in cache.items()}
    ptrs = [t.data_ptr() for ls in cache.values() for t in ls]
    mover = PageBlockMover()
    block = mover.gather(cache, [3, 5, 8, 8])       # trash-padded (8)
    assert all(len(ls) == (4 if dtype == torch.int8 else 2)
               for ls in block.values())
    for name, leaves in block.items():
        for rows, want in zip(leaves, before[name]):
            assert torch.equal(rows, want[[3, 5, 8, 8]])
    mover.scatter(cache, {n: tuple(t[:2] for t in ls)
                          for n, ls in block.items()}, [0, 1])
    assert [t.data_ptr() for ls in cache.values() for t in ls] == ptrs
    for name, leaves in cache.items():
        for leaf, want in zip(leaves, before[name]):
            assert torch.equal(leaf[[0, 1]], want[[3, 5]])
            assert torch.equal(leaf[2:], want[2:])
    assert (mover.gathers, mover.scatters) == (1, 1)


def test_host_copier_ring_on_the_cpu(lm):
    cache = lm[2].init_paged_cache(5, 4)
    copier = HostCopier(cache, slots=2, slot_pages=3)
    block = PageBlockMover().gather(cache, [1, 2])
    a, b = copier.start(block), copier.start(block)
    assert copier.start(block) is None               # the ring is full
    assert copier.ready(a) and copier.take(a) is block
    assert copier.start(block) is not None           # a's slot came back
    assert copier.upload(block) is block             # already on the CPU
    copier.reset()
    assert copier.start(block) is not None and b is not None


def test_warmup_runs_the_tier_copies_on_the_trash_page(lm):
    engine = make_engine(lm, prefix_cache=True, host_pages=8)
    before = {n: tuple(t.clone() for t in ls)
              for n, ls in engine._cache.items()}
    engine.warmup()
    assert (engine._mover.gathers, engine._mover.scatters) == (1, 1)
    assert not engine._pending_offloads and engine._copier._free == [0, 1]
    trash = engine._pool.trash
    for name, leaves in engine._cache.items():
        for leaf, want in zip(leaves, before[name]):
            assert torch.equal(leaf[:trash], want[:trash])
    _close(engine)


def _published_engine(lm, **kw):
    """A host-tier engine whose index holds one family's 3 pages."""
    engine = make_engine(lm, prefix_cache=True, host_pages=8, **kw)
    first, _ = family_prompts()
    engine.generate(first[0], max_new_tokens=3, timeout=RESULT_TIMEOUT)
    assert engine.shared_pages == 3
    return engine, first[0]


def test_a_copy_that_has_not_landed_is_never_filed(lm):
    """Readiness is the copy's own: while it says no, drains file nothing;
    past two copies in flight an evicted page is dropped and counted."""
    engine, prompt = _published_engine(lm)
    landed = False
    engine._copier.ready = lambda ticket: landed
    engine._evict_for(engine.num_pages, None)        # evicts all 3
    assert engine.shared_pages == 0
    assert len(engine._pending_offloads) == 2
    engine._drain_offloads()
    assert engine.host_store.prefix_pages == 0
    snap = engine.metrics.snapshot()
    assert (snap["kv_offload_pages"], snap["kv_offload_dropped"]) == (0, 1)
    landed = True
    engine._drain_offloads()
    assert engine.host_store.prefix_pages == 2 and not engine._pending_offloads
    assert engine.metrics.snapshot()["kv_offload_pages"] == 2
    # the eviction goes leaf first: the two deepest pages were kept
    assert engine.host_store.has_prefix(0, tuple(prompt[:12]))
    assert engine.host_store.has_prefix(0, tuple(prompt[:8]))
    _close(engine)


def test_drain_with_wait_files_every_copy(lm):
    engine, prompt = _published_engine(lm)
    engine._copier.ready = lambda ticket: False
    engine._evict_for(engine.num_pages, None)
    engine._drain_offloads(wait=True)
    assert engine.host_store.prefix_pages == 2 and not engine._pending_offloads
    _close(engine)


# ---------------------------------------- the engine against JAX ----


def overflow_prompts():
    """Twelve 3-page families (36 published pages against a 32-page
    pool, one or two pages evicted per admission once it is full), then
    a revisit of each."""
    fams = [[int(t) for t in np.random.RandomState(200 + i).randint(1, 60, 12)]
            for i in range(12)]
    return [f + [1, 2] for f in fams] + [f + [5, 6] for f in fams]


@pytest.fixture(scope="module")
def jax_host_run(lm, jax_paged_kernels):
    jm, params = lm[:2]
    engine = JaxEngine(jm, params, prefix_cache=True, host_pages=32,
                       kernels=jax_paged_kernels, **JAX_CFG)
    outs = [engine.generate(p, max_new_tokens=3, timeout=RESULT_TIMEOUT)
            for p in overflow_prompts()]
    snap = engine.metrics.snapshot()
    host = engine.host_store.snapshot()
    engine.close()
    del engine
    gc.collect()
    return outs, snap, host


def test_host_tier_engine_matches_jax_engine(lm, jax_host_run):
    want, jsnap, jhost = jax_host_run
    engine = make_engine(lm, prefix_cache=True, host_pages=32, **JAX_CFG)
    got = [engine.generate(p, max_new_tokens=3, timeout=RESULT_TIMEOUT)
           for p in overflow_prompts()]
    host = engine.host_store.snapshot()
    snap = _close(engine)
    assert got == want
    keys = ("kv_offload_pages", "kv_restore_pages", "kv_offload_dropped",
            "prefix_hits", "prefill_chunks_skipped", "host_pages_peak")
    assert {k: snap[k] for k in keys} == {k: jsnap[k] for k in keys}
    assert snap["kv_offload_pages"] > 0 and snap["kv_restore_pages"] > 0
    assert host == dict(jhost, bytes_in_use=host["bytes_in_use"])


# ------------------------------------------------ identities ----


@pytest.mark.parametrize("knobs, cache_dtype", [
    ({}, torch.float32), (SAMPLED, torch.float32), ({}, torch.int8),
    (SAMPLED, torch.int8)],
    ids=["greedy-f32", "sampled-f32", "greedy-int8", "sampled-int8"])
def test_host_tier_on_equals_off(lm, knobs, cache_dtype):
    """Revisits served by host -> device restores give the streams of an
    engine without the tier, and run fewer prompt calls."""
    first, revisit = family_prompts()

    model = lm[3] if cache_dtype == torch.int8 else lm[2]   # int8 weights

    def run(host_pages):
        engine = make_engine(lm, model=model, seed=3, num_pages=12,
                             cache_dtype=cache_dtype, prefix_cache=True,
                             host_pages=host_pages)
        outs = [engine.generate(p, max_new_tokens=3, timeout=RESULT_TIMEOUT,
                                **knobs) for p in first]
        calls = engine.metrics.snapshot()["prefill_chunks"]
        outs += [engine.generate(p, max_new_tokens=3, timeout=RESULT_TIMEOUT,
                                 **knobs) for p in revisit]
        host = engine.host_store
        snap = _close(engine)
        return outs, snap, snap["prefill_chunks"] - calls, host

    want, _, calls_off, none = run(None)
    got, snap, calls_on, host = run(32)
    assert none is None and got == want
    assert snap["kv_offload_pages"] > 0 and snap["kv_restore_pages"] > 0
    assert host.offloaded_pages == snap["kv_offload_pages"]
    assert host.restored_pages == snap["kv_restore_pages"]
    assert snap["host_pages_peak"] > 0 and host.pages == 0
    assert calls_on < calls_off


def _swap_run(lm, knobs, close_early=False):
    """Two priority-0 streams fill both 12-page lanes of a 24-page pool; a
    priority-5 request then heads the queue and can only be admitted by
    swapping one of them out."""
    engine = make_engine(lm, max_slots=3, num_pages=24, prefix_cache=True,
                         host_pages=64)
    lows = [engine.submit([i + 1] * 6, max_new_tokens=42, tag=("low", i),
                          **knobs) for i in range(2)]
    deadline = time.monotonic() + RESULT_TIMEOUT
    while engine.active_slots < 2 and time.monotonic() < deadline:
        time.sleep(0.001)
    assert engine.active_slots == 2
    high = engine.submit([40, 41, 42], max_new_tokens=4, priority=5)
    if close_early:
        while not engine.metrics.snapshot()["kv_swaps_out"] \
                and time.monotonic() < deadline:
            time.sleep(0.001)
        engine.close(drain=False)
        for s in [high] + lows:
            with pytest.raises(RuntimeError):
                s.result(RESULT_TIMEOUT)
        return engine
    outs = [s.result(RESULT_TIMEOUT) for s in [high] + lows]
    return outs, _close(engine)


@pytest.mark.parametrize("knobs", [{}, SWAP_SAMPLED],
                         ids=["greedy", "sampled"])
def test_swap_out_and_resume_are_byte_exact(lm, knobs):
    ref = make_engine(lm, max_slots=3, num_pages=24)
    want = [ref.generate([40, 41, 42], max_new_tokens=4,
                         timeout=RESULT_TIMEOUT)]
    want += [ref.generate([i + 1] * 6, max_new_tokens=42,
                          timeout=RESULT_TIMEOUT, **knobs) for i in range(2)]
    _close(ref)
    got, snap = _swap_run(lm, knobs)
    assert snap["kv_swaps_out"] >= 1
    assert snap["kv_swaps_in"] == snap["kv_swaps_out"]
    assert got == want


def test_close_without_drain_empties_both_tiers_after_a_swap(lm):
    engine = _swap_run(lm, {}, close_early=True)
    assert engine.pages_in_use == 0 and engine.host_pages_in_use == 0
    assert engine.shared_pages == 0 and not engine._pending_offloads
    assert engine.metrics.snapshot()["host_pages"] == 0


def test_equal_priority_never_swaps(lm):
    """Three 9-page reservations against 24 pages: the third waits at the
    head, and with equal priorities it waits; nothing swaps."""
    engine = make_engine(lm, max_slots=3, num_pages=24, prefix_cache=True,
                         host_pages=64)
    streams = [engine.submit([i + 1] * 6, max_new_tokens=30)
               for i in range(3)]
    assert all(len(s.result(RESULT_TIMEOUT)) == 30 for s in streams)
    assert _close(engine)["kv_swaps_out"] == 0


def test_host_pages_needs_the_prefix_cache_and_no_speculation(lm):
    with pytest.raises(ValueError, match="prefix_cache"):
        make_engine(lm, host_pages=8)
    draft = Transformer(64, 16, 2, 32, 1, device="cpu")
    with pytest.raises(ValueError, match="speculative"):
        make_engine(lm, prefix_cache=True, host_pages=8,
                    speculate=(draft, 2))


def test_tier_tagged_snapshots_and_cancel_drain(lm):
    engine = make_engine(lm, num_pages=12, prefix_cache=True, host_pages=32)
    first, _ = family_prompts()
    for p in first:
        engine.generate(p, max_new_tokens=3, timeout=RESULT_TIMEOUT)
    engine._drain_offloads(wait=True)
    assert engine._pool.snapshot()["tier"] == "hbm"
    host_snap = engine.host_store.snapshot()
    assert host_snap["tier"] == "host"
    assert host_snap["pages_in_use"] == engine.host_pages_in_use > 0
    assert engine.metrics.snapshot()["host_pages"] == engine.host_pages_in_use
    s = engine.submit(first[0], max_new_tokens=30)
    deadline = time.monotonic() + RESULT_TIMEOUT
    while not s.tokens and time.monotonic() < deadline:
        time.sleep(0.001)
    s.cancel()
    with pytest.raises(Exception):
        s.result(RESULT_TIMEOUT)
    assert engine._pool.snapshot()["pages_shared"] == 0
    _close(engine)


def test_kv_tier_metrics_rows_follow_the_prefix_block():
    m = ServingMetrics()
    m.record_offload(3)
    m.record_restore(2)
    m.record_offload_dropped()
    m.record_swap_out()
    m.record_swap_in()
    m.set_host_pages(5, 500)
    m.set_host_pages(1, 100)
    snap = m.snapshot()
    keys = list(snap)
    # the JAX package's order: prefix block, ITL block, then the tier's
    at = keys.index("itl_samples") + 1
    assert keys[at - 3] == "prefill_chunks_skipped"
    assert keys[at:at + 8] == ["kv_offload_pages", "kv_restore_pages",
                               "kv_offload_dropped", "kv_swaps_out",
                               "kv_swaps_in", "host_pages", "host_bytes",
                               "host_pages_peak"]
    assert [snap[k] for k in keys[at:at + 8]] == [3, 2, 1, 1, 1, 1, 100, 5]
