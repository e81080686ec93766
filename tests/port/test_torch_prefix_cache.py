"""The port's prefix cache on the CPU: refcounted pages, the radix index,
cache-aware admission and publish-time dedup.

- The host structures against the JAX package's: the port's ``PagePool``
  and ``PrefixCache`` and JAX's, driven over the same seeded op sequence
  (alloc, share, release, publish, lookup, match, evict with ``protect``,
  export, adopt, clear), give equal return values and snapshots at every
  step.
- On weights bridged from JAX, the port's ``prefix_cache=True`` engine
  gives the JAX engine's greedy streams, hits and ``prefill_chunks_skipped``
  over a system-prompt mix. Greedy tokens are compared as in
  ``test_torch_engine.py``: logits agree to ~2e-5, and every token here
  won its argmax by a top-2 gap far above that.
- Inside the port, bitwise: cache on == cache off (greedy and sampled,
  float and int8 pools, speculative), whatever the admission order; hits
  skip their prompt calls; eviction runs before the FIFO wait and keeps
  the usable prefix; speculative lanes share within a lane only;
  concurrent same-prefix requests converge on one copy after publish;
  the bypass bound; owner accounting on cancel and ``close(drain=False)``.
"""

import gc
import threading
import time

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.serving import GenerationEngine as JaxEngine
from bigdl_tpu.serving import PagePool as JaxPagePool
from bigdl_tpu.serving import PrefixCache as JaxPrefixCache
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.nn import Transformer
from bigdl_tpu_torch.nn.quantized import quantize_for_serving
from bigdl_tpu_torch.serving import (
    GenerationEngine,
    PagePool,
    PrefixCache,
    ServingMetrics,
)

MAXLEN = 48
CFG = dict(max_slots=2, max_len=MAXLEN, page_size=4, prefill_chunk=4)
# the JAX engines' shape (``jax_paged_kernels`` compiles its steps once)
JAX_CFG = dict(max_slots=4, max_len=32, page_size=4, prefill_chunk=4)
RESULT_TIMEOUT = 60
GAP_MIN = 1e-3      # 50x the 2e-5 logits tolerance
SAMPLED = dict(temperature=0.9, top_k=20, top_p=0.95)
PREFIX = [int(t) for t in np.random.RandomState(7).randint(1, 60, 12)]


def shared_prefix_prompts():
    """One 3-page system prefix with divergent tails (short, and one
    spanning chunks) and one unrelated prompt that must miss."""
    long_tail = [int(t) for t in np.random.RandomState(8).randint(1, 60, 10)]
    return ([PREFIX + [i + 1, i + 2] for i in range(4)]
            + [PREFIX + long_tail] + [[9, 2, 5]])


LENS = [6, 3, 8, 5, 4, 7]


@pytest.fixture(scope="module")
def lm(jax_lm):
    jm, params = jax_lm       # JaxTransformer(64, 32, 4, 64, 2), key(2)
    tm = load_jax_params(Transformer(64, 32, 4, 64, 2, device="cpu"),
                         jax.device_get(params))
    draft = Transformer(64, 16, 2, 32, 1, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    return jm, params, tm, draft, quantize_for_serving(tm)


def make_engine(lm, model=None, **kw):
    cfg = dict(CFG, device="cpu")
    cfg.update(kw)
    return GenerationEngine(lm[2] if model is None else model, **cfg)


def _close(engine):
    engine.close()
    assert engine.pages_in_use == 0 and engine.shared_pages == 0
    return engine.metrics.snapshot()


# ------------------------------------------- host structures vs JAX ----


def _node_keys(cache, nodes):
    return [cache.node_prefix(nd) for nd in nodes]


@pytest.mark.parametrize("seed", range(16))
def test_pool_and_index_match_jax_over_seeded_ops(seed):
    """Both packages' pool and index under one seeded op sequence: every
    return value and both snapshots equal after every op."""
    rs = np.random.RandomState(seed)
    ps, n_pages = 2, 24
    pools = (PagePool(n_pages, ps, 16), JaxPagePool(n_pages, ps, 16))
    caches = (PrefixCache(pools[0]), JaxPrefixCache(pools[1]))
    held = []          # one entry per reference this script owns
    adopted = []

    def prompt():
        # a small alphabet and short prompts: chains share prefixes
        return [int(t) for t in rs.randint(1, 3, rs.randint(2, 9))]

    def both(fn):
        got = [fn(pool, cache) for pool, cache in zip(pools, caches)]
        assert got[0] == got[1], got
        assert pools[0].snapshot() == pools[1].snapshot()
        assert caches[0].snapshot() == caches[1].snapshot()
        return got[0]

    for _ in range(120):
        op = rs.choice(["alloc", "share", "release", "publish", "lookup",
                        "match", "evict", "export", "adopt", "probe",
                        "clear"], p=[.16, .08, .14, .14, .12, .06, .1, .06,
                                     .06, .05, .03])
        if op == "alloc":
            n = int(rs.randint(1, 4))
            if pools[0].can_reserve(n):
                owner = [None, "target", "draft"][rs.randint(3)]
                held += both(lambda p, c: p.alloc(n, owner=owner))
        elif op == "share" and held:
            pages = [held[i] for i in rs.randint(0, len(held), 2)]
            both(lambda p, c: p.share(pages))
            held += pages
        elif op in ("release", "export") and held:
            i = int(rs.randint(len(held)))
            pages = [held.pop(i)]
            both(lambda p, c: getattr(p, op + ("_pages" if op == "export"
                                                 else ""))(pages))
        elif op == "publish":
            pr = prompt()
            need = len(pr) // ps
            if pools[0].can_reserve(need):
                row = both(lambda p, c: p.alloc(need, owner="target"))
                both(lambda p, c: c.publish(pr, row + [n_pages] * 4))
                both(lambda p, c: p.release(row))   # the request's refs
        elif op == "lookup":
            pr = prompt()
            both(lambda p, c: (lambda r: (r[0], r[1], _node_keys(c, r[2])))(
                c.lookup(pr)))
        elif op == "match":
            pr, limit = prompt(), int(rs.randint(0, 5))
            both(lambda p, c: c.match_pages(pr, limit))
        elif op == "evict":
            pr = prompt()
            n = int(rs.randint(1, 5))

            def evict(p, c):
                seen = []
                protect = frozenset(c.lookup(pr)[2])
                freed = c.evict(n, protect,
                                on_evict=lambda k, pg: seen.append((k, pg)))
                return freed, seen

            both(evict)
        elif op == "adopt":
            meta = [(int(rs.randint(4)), int(rs.randint(1, 3)),
                     int(rs.randint(2))) for _ in range(rs.randint(1, 3))]
            if pools[0].can_reserve(len(meta)):
                adopted += both(lambda p, c: p.adopt_pages(
                    meta, source="peer", owner="target"))
                if adopted and rs.rand() < 0.5:
                    page = adopted.pop(0)
                    both(lambda p, c: p.release([page]))
        elif op == "probe":
            hit = bool(rs.randint(2))
            both(lambda p, c: c.record_probe(hit, 4 * hit))
        elif op == "clear":
            both(lambda p, c: c.clear())
        pages = list(range(n_pages + 1))
        both(lambda p, c: ([p.refcount(q) for q in pages],
                           [p.generation(q) for q in pages],
                           p.in_use_by("target"), p.in_use_by("draft"),
                           p.free_pages, c.pages, c.version))


def test_lookup_is_page_aligned_and_never_whole_prompt():
    pool = PagePool(16, 4, 32)
    cache = PrefixCache(pool)
    prompt = list(range(1, 13))             # exactly 3 pages
    pages = pool.alloc(3)
    assert cache.publish(prompt, pages) == 3
    n, hit, _ = cache.lookup(prompt)        # whole prompt: leaves a tail
    assert (n, hit) == (8, pages[:2])
    n, hit, _ = cache.lookup(prompt + [99])
    assert (n, hit) == (12, pages)
    assert cache.lookup(prompt[:3])[0] == 0


def test_match_pages_is_a_pure_reader():
    pool = PagePool(16, 4, 32)
    cache = PrefixCache(pool)
    prompt = list(range(1, 13))
    pages = pool.alloc(3)
    cache.publish(prompt, pages)
    stamps = [nd.stamp for nd in cache.lookup(prompt + [1])[2]]
    assert cache.match_pages(prompt, 3) == pages       # no tail clamp
    assert cache.match_pages(prompt, 2) == pages[:2]
    assert cache.match_pages([5] + prompt[1:], 3) == []
    assert [nd.stamp for nd in cache.lookup(prompt + [1])[2]] \
        == [s + 1 for s in stamps]                     # only lookup touched


def test_refcounted_pool_shares_and_charges_once():
    pool = PagePool(8, 4, 16)
    a = pool.alloc(2, owner="target")
    pool.share(a)
    pool.release(a)
    assert pool.in_use == 2 and pool.refcount(a[0]) == 1
    assert pool.snapshot()["by_owner"] == {"target": 2}
    pool.release(a)
    assert pool.in_use == 0 and pool.refcount(a[0]) == 0
    with pytest.raises(RuntimeError, match="not reserved"):
        pool.share(a)
    b = pool.alloc(1)
    assert b == [0] and pool.generation(0) == 2


# ---------------------------------------- the engine against JAX ----


@pytest.fixture(scope="module")
def jax_prefix_run(lm, jax_paged_kernels):
    """The JAX prefix-caching engine over the system-prompt mix, one
    request after another (every later shared-prefix request hits)."""
    jm, params = lm[:2]
    engine = JaxEngine(jm, params, prefix_cache=True,
                       kernels=jax_paged_kernels, **JAX_CFG)
    outs = [engine.generate(p, max_new_tokens=m, timeout=RESULT_TIMEOUT)
            for p, m in zip(shared_prefix_prompts(), LENS)]
    snap = engine.metrics.snapshot()
    engine.close()
    del engine
    gc.collect()
    return outs, snap


def test_prefix_engine_matches_jax_engine(lm, jax_prefix_run):
    want, jsnap = jax_prefix_run
    engine = make_engine(lm, prefix_cache=True, **JAX_CFG)
    prompts = shared_prefix_prompts()
    got = [engine.generate(p, max_new_tokens=m, timeout=RESULT_TIMEOUT)
           for p, m in zip(prompts, LENS)]
    snap = _close(engine)
    assert got == want
    keys = ("prefix_hits", "prefix_misses", "prefill_chunks_skipped",
            "prefill_chunks", "prefills")
    assert {k: snap[k] for k in keys} == {k: jsnap[k] for k in keys}
    assert snap["prefix_hits"] == 4 and snap["prefill_chunks_skipped"] > 0
    tm = lm[2]
    with torch.no_grad():
        for prompt, out in zip(prompts, got):
            seq = prompt + out
            logits = tm(torch.tensor([seq[:-1]]))[0, len(prompt) - 1:]
            assert logits.argmax(-1).tolist() == out
            top2 = logits.topk(2, dim=-1).values
            assert (top2[:, 0] - top2[:, 1]).min().item() > GAP_MIN


# ------------------------------------------------ identities ----


@pytest.mark.parametrize("knobs, engine_kw", [
    ({}, {}),
    (SAMPLED, {}),
    ({}, dict(cache_dtype=torch.int8, quantize="int8")),
    ({}, dict(speculate=True)),
], ids=["greedy-f32", "sampled-f32", "greedy-int8", "greedy-speculative"])
def test_cache_on_equals_cache_off(lm, knobs, engine_kw):
    """Cache on vs off, bitwise: one request after another (maximal
    hits), and all at once in reversed order."""
    engine_kw = dict(engine_kw)
    if engine_kw.pop("speculate", False):
        engine_kw["speculate"] = (lm[3], 2)
    model = lm[2]
    if engine_kw.pop("quantize", None):
        model = lm[4]
    prompts = shared_prefix_prompts()

    def run(enabled, order=range(len(prompts)), sequential=False):
        engine = make_engine(lm, model=model, seed=3, prefix_cache=enabled,
                             **engine_kw)
        if sequential:
            outs = {i: engine.generate(prompts[i], max_new_tokens=LENS[i],
                                       timeout=RESULT_TIMEOUT, **knobs)
                    for i in order}
        else:
            streams = {i: engine.submit(prompts[i], max_new_tokens=LENS[i],
                                        **knobs) for i in order}
            outs = {i: s.result(RESULT_TIMEOUT) for i, s in streams.items()}
        return outs, _close(engine)

    want, _ = run(False)
    got, snap = run(True, sequential=True)
    assert got == want
    assert snap["prefix_hits"] == 4 and snap["prefill_chunks_skipped"] > 0
    assert run(True, order=range(len(prompts) - 1, -1, -1))[0] == want


def test_hits_skip_prompt_calls(lm):
    """A 12-token prefix at prefill_chunk=4 costs 3 chunk calls; with the
    cache only the first request runs them."""
    prompts = [PREFIX + [i + 1, i + 2] for i in range(5)]

    def run(enabled):
        engine = make_engine(lm, prefix_cache=enabled)
        for p in prompts:
            engine.generate(p, max_new_tokens=3, timeout=RESULT_TIMEOUT)
        live = engine.metrics.snapshot()
        assert engine.shared_pages == (3 if enabled else 0)
        assert engine.pages_in_use == engine.shared_pages   # cache refs only
        return live, _close(engine)

    off, _ = run(False)
    on, closed = run(True)
    assert off["prefill_chunks"] == 3 * len(prompts)
    assert on["prefill_chunks"] == 3
    assert (on["prefix_hits"], on["prefix_misses"]) == (4, 1)
    assert on["prefix_hit_rate"] == pytest.approx(0.8)
    assert on["prefill_chunks_skipped"] == 3 * 4
    assert on["shared_pages"] == 3 and closed["shared_pages"] == 0
    assert off["prefix_hits"] == off["prefix_misses"] == 0


def test_eviction_runs_before_the_fifo_wait(lm):
    """A reservation the free pages cannot cover evicts unreferenced
    cached pages and admits at once; the recycled pages serve cleanly."""
    engine = make_engine(lm, num_pages=8, prefix_cache=True)
    prompt = PREFIX[:8] + [1]
    first = engine.generate(prompt, max_new_tokens=3, timeout=RESULT_TIMEOUT)
    assert engine.shared_pages == 2
    out = engine.generate([5, 6], max_new_tokens=31, timeout=RESULT_TIMEOUT)
    assert len(out) == 31                  # needed every page of the pool
    assert engine._prefix.evicted_pages == 2 and engine.shared_pages == 0
    again = engine.generate(prompt, max_new_tokens=3, timeout=RESULT_TIMEOUT)
    _close(engine)
    assert again == first


def test_partial_eviction_keeps_the_usable_prefix(lm):
    """Eviction takes leaves first: a partly evicted chain still serves
    the shorter hit, with the same tokens."""
    engine = make_engine(lm, num_pages=12, prefix_cache=True)
    long_p = PREFIX + list(range(30, 44))              # 26 tokens
    want = engine.generate(long_p, max_new_tokens=3, timeout=RESULT_TIMEOUT)
    assert engine.shared_pages == 6
    out = engine.generate([7, 7], max_new_tokens=29, timeout=RESULT_TIMEOUT)
    assert len(out) == 29 and engine.shared_pages == 4
    got = engine.generate(long_p, max_new_tokens=3, timeout=RESULT_TIMEOUT)
    snap = _close(engine)
    assert got == want and snap["prefix_hits"] == 1


def test_speculative_lanes_share_within_a_lane_never_across(lm):
    prompts = [PREFIX[:8] + [i + 1] for i in range(3)]
    plain = make_engine(lm)
    want = [plain.generate(p, max_new_tokens=5, timeout=RESULT_TIMEOUT)
            for p in prompts]
    _close(plain)
    engine = make_engine(lm, prefix_cache=True, speculate=(lm[3], 2))
    got = [engine.generate(p, max_new_tokens=5, timeout=RESULT_TIMEOUT)
           for p in prompts]
    assert got == want
    assert engine._prefix.pages == 2 and engine._dprefix.pages == 2
    assert set(engine._prefix.match_pages(prompts[0], 2)).isdisjoint(
        engine._dprefix.match_pages(prompts[0], 2))
    assert engine._pool.snapshot()["by_owner"] == {"draft": 2, "target": 2}
    snap = _close(engine)
    assert snap["prefix_hits"] == 2
    assert engine._pool.in_use_by("target") == 0
    assert engine._pool.in_use_by("draft") == 0


def test_concurrent_same_prefix_requests_converge_after_publish(lm):
    """Two requests race one cold prefix and each writes its own pages.
    When the short one retires and publishes, the long one's prompt pages
    repoint at the cached copies in both its row and the live page map,
    the duplicates free, and its tokens stay the same."""
    prompts = [PREFIX + [3, 4], PREFIX + [9, 11]]
    ref = make_engine(lm)
    s = [ref.submit(prompts[0], max_new_tokens=2),
         ref.submit(prompts[1], max_new_tokens=24)]
    want = [x.result(RESULT_TIMEOUT) for x in s]
    _close(ref)
    engine = make_engine(lm, prefix_cache=True)
    s = [engine.submit(prompts[0], max_new_tokens=2),
         engine.submit(prompts[1], max_new_tokens=24)]
    deadline = time.monotonic() + RESULT_TIMEOUT
    while engine._prefix.deduped_pages < 3 and not s[1].done \
            and time.monotonic() < deadline:
        time.sleep(0.001)
    with engine._core.lock:
        live = [(slot, st) for slot, st in engine._core.active.items()]
    got = [x.result(RESULT_TIMEOUT) for x in s]
    assert got == want
    assert engine._prefix.snapshot()["deduped_pages"] == 3
    canon = engine._prefix.match_pages(prompts[1], 3)
    for slot, st in live:                  # seen mid-decode, if still live
        if st.pages is not None:
            assert st.pages[:3] == canon
            assert list(st.page_row[:3]) == canon
    assert engine._pool.in_use == 3 and engine.shared_pages == 3
    _close(engine)


def test_dedup_skips_when_no_duplicates_exist(lm):
    engine = make_engine(lm, prefix_cache=True)
    engine.generate(PREFIX + [1, 2], max_new_tokens=3,
                    timeout=RESULT_TIMEOUT)
    engine.generate(PREFIX + [5, 6], max_new_tokens=3,
                    timeout=RESULT_TIMEOUT)
    assert engine._prefix.snapshot()["deduped_pages"] == 0
    _close(engine)


class _Gate:
    """Holds the engine loop between iterations until released."""

    def __init__(self, engine):
        self.event = threading.Event()
        step = engine._step

        def gated():
            self.event.wait(RESULT_TIMEOUT)
            step()

        engine._step = gated


def _seed_and_submit(lm, **kw):
    """A tight pool: a 3-page prefix is cached, a hog holds 10 of the 14
    pages, the FIFO head needs more than eviction can free, and a small
    request with the cached prefix waits behind it. The loop is held
    until all three are queued."""
    engine = make_engine(lm, num_pages=14, prefix_cache=True, **kw)
    engine.generate(PREFIX + [1, 2], max_new_tokens=2,
                    timeout=RESULT_TIMEOUT)
    gate = _Gate(engine)
    hog = engine.submit([11] * 8, max_new_tokens=30)
    big = engine.submit([12] * 8, max_new_tokens=30)
    small = engine.submit(PREFIX + [5, 6], max_new_tokens=2)
    gate.event.set()
    return engine, hog, big, small


def test_bypass_admits_a_small_request_past_a_blocked_head(lm):
    engine, hog, big, small = _seed_and_submit(lm,
                                               cache_aware_admission=True)
    got = [s.result(RESULT_TIMEOUT) for s in (small,)]
    assert not big.done                    # it passed the waiting head
    assert engine.admission_bypasses >= 1
    got += [s.result(RESULT_TIMEOUT) for s in (hog, big)]
    _close(engine)
    ref = make_engine(lm)                  # scheduling moved, not tokens
    want = [ref.generate(p, max_new_tokens=m, timeout=RESULT_TIMEOUT)
            for p, m in ((PREFIX + [5, 6], 2), ([11] * 8, 30),
                         ([12] * 8, 30))]
    _close(ref)
    assert got == want


def test_bypass_bound_is_enforced(lm):
    """At most ``_bypass_limit`` bypasses in a row, with six candidates
    queued: the head then waits with no one passing it, and completes."""
    engine = make_engine(lm, num_pages=14, prefix_cache=True,
                         cache_aware_admission=True)
    assert engine._bypass_limit == 4
    engine.generate(PREFIX + [1, 2], max_new_tokens=2,
                    timeout=RESULT_TIMEOUT)
    gate = _Gate(engine)
    hog = engine.submit([11] * 8, max_new_tokens=30)
    big = engine.submit([12] * 8, max_new_tokens=30)
    smalls = [engine.submit(PREFIX + [5, 6 + i], max_new_tokens=2)
              for i in range(6)]
    gate.event.set()
    assert all(len(s.result(RESULT_TIMEOUT)) == 2 for s in smalls)
    assert len(big.result(RESULT_TIMEOUT)) == 30
    assert len(hog.result(RESULT_TIMEOUT)) == 30
    assert 1 <= engine.admission_bypasses <= engine._bypass_limit
    _close(engine)


def test_cache_aware_admission_is_off_by_default(lm):
    engine, hog, big, small = _seed_and_submit(lm)
    assert engine.cache_aware_admission is False
    for s in (small, hog, big):
        s.result(RESULT_TIMEOUT)
    assert engine.admission_bypasses == 0
    _close(engine)


def test_owner_accounting_on_cancel_and_close_without_drain(lm):
    engine = make_engine(lm, max_slots=1, prefix_cache=True)
    engine.generate(PREFIX + [1, 1], max_new_tokens=3,
                    timeout=RESULT_TIMEOUT)
    assert engine._pool.snapshot()["by_owner"] == {"target": 3}
    s = engine.submit(PREFIX + [2, 2], max_new_tokens=30)
    deadline = time.monotonic() + RESULT_TIMEOUT
    while not s.tokens and time.monotonic() < deadline:
        time.sleep(0.001)
    s.cancel()
    with pytest.raises(Exception):
        s.result(RESULT_TIMEOUT)
    snap = engine._pool.snapshot()
    assert snap["by_owner"] == {"target": 3} and snap["pages_shared"] == 0
    engine.submit(PREFIX + [3, 3], max_new_tokens=30)
    engine.close(drain=False)
    snap = engine._pool.snapshot()
    assert snap["by_owner"] == {} and snap["pages_in_use"] == 0
    assert engine.metrics.snapshot()["shared_pages"] == 0


def test_step_failure_releases_every_reference(lm):
    engine = make_engine(lm, prefix_cache=True)
    engine.generate(PREFIX + [1, 1], max_new_tokens=3,
                    timeout=RESULT_TIMEOUT)

    def broken(*a, **k):
        raise RuntimeError("planted")

    engine.kernels.decode = broken
    s = engine.submit(PREFIX + [2, 2], max_new_tokens=5)
    with pytest.raises(RuntimeError, match="planted"):
        s.result(RESULT_TIMEOUT)
    engine.close()
    assert engine.pages_in_use == 0 and engine.shared_pages == 0


def test_prefix_metrics_rows_follow_the_speculative_block():
    m = ServingMetrics()
    m.record_verify_step(8, 5, 5)
    m.record_prefix_probe(True, 3)
    m.record_prefix_probe(True, 3)
    m.record_prefix_probe(False)
    m.set_shared_pages(6)
    snap = m.snapshot()
    keys = list(snap)
    # the JAX package's order: speculative block, step-timeline block,
    # then the prefix block
    assert keys[keys.index("verify_steps") + 1] == "engine_steps"
    at = keys.index("step_host_frac") + 1
    assert keys[at:at + 5] == ["prefix_hits", "prefix_misses",
                               "prefix_hit_rate", "shared_pages",
                               "prefill_chunks_skipped"]
    assert (snap["prefix_hits"], snap["prefix_misses"]) == (2, 1)
    assert snap["prefix_hit_rate"] == pytest.approx(2 / 3)
    assert snap["shared_pages"] == 6 and snap["prefill_chunks_skipped"] == 6
