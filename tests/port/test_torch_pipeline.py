"""The parallel input pipeline, the staging thread and the image
transformers against the JAX package's.

- An ordered pool's stream is bitwise the JAX package's serial pool
  stream for the same chain and base seed, for 1 and 3 workers, in
  threads and in spawned processes (the per-element reseed makes the
  stream independent of the worker count and the mode).
- A worker's exception reaches the consumer; a supervised restart
  replays the chunk bitwise; abandoning the stream joins every worker.
- Each image transformer's output is bitwise the JAX package's on the
  same input and seed.
- ``Optimizer.set_data_pipeline`` trains through the pool: the losses of
  2 and 3 workers are bitwise equal, and the stages' counters reach the
  step records.
"""

import logging
import threading
import time

import numpy as np
import pytest
import torch

from bigdl_tpu.core.rng import RandomGenerator as JaxRG
from bigdl_tpu.dataset import image as jimage
from bigdl_tpu.dataset.parallel_pipeline import (
    ParallelTransformer as JaxParallel,
)
from bigdl_tpu_torch import faults, nn
from bigdl_tpu_torch.core import RandomGenerator
from bigdl_tpu_torch.dataset import (
    DataSet,
    FunctionTransformer,
    ParallelTransformer,
    PipelineStats,
    SampleToMiniBatch,
    image,
    parallelize_chain,
)
from bigdl_tpu_torch.dataset.prefetch import host_prefetch
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

MEANS, STDS = (104.0, 117.0, 124.0), (58.0, 57.0, 57.5)


def _imgs(n=20, side=16):
    return [(np.random.RandomState(i).randint(0, 256, (3, side, side))
             .astype(np.uint8), i) for i in range(n)]


def _chain(m):
    """Crop, flip, normalise and wrap, from module ``m`` (either
    package's ``image``) and its ``RandomGenerator`` ``rg``."""
    rg = RandomGenerator if m is image else JaxRG
    return (m.RandomCropper(12, 12, pad=2, rng=rg(7))
            >> m.HFlip(rng=rg(9)) >> m.BGRImgNormalizer(MEANS, STDS)
            >> m.BGRImgToSample())


@pytest.fixture(scope="module")
def jax_stream():
    return list(JaxParallel(_chain(jimage), 1, base_seed=5)
                .apply(iter(_imgs())))


def _assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.feature, b.feature)
        np.testing.assert_array_equal(a.label, b.label)
        assert a.feature.dtype == b.feature.dtype


@pytest.mark.parametrize("processes, workers", [
    (False, 1), (False, 3), (True, 1), (True, 3)],
    ids=["threads1", "threads3", "processes1", "processes3"])
def test_ordered_stream_is_the_jax_stream(jax_stream, processes, workers,
                                         real_tracker_lock):
    pool = ParallelTransformer(_chain(image), workers, processes=processes,
                               base_seed=5, chunk=2)
    _assert_same(list(pool.apply(iter(_imgs()))), jax_stream)


def _boom_at_7(t):
    if t[1] == 7:
        raise ValueError("element 7 is poison")
    return t


def _threads_retire(baseline, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if threading.active_count() <= baseline:
            return True
        time.sleep(0.02)
    return False


def test_worker_error_reaches_the_consumer_and_workers_retire():
    baseline = threading.active_count()
    pool = ParallelTransformer(FunctionTransformer(_boom_at_7), 3,
                               max_worker_restarts=0)
    with pytest.raises(ValueError, match="element 7 is poison"):
        list(pool.apply(iter(_imgs())))
    assert _threads_retire(baseline)


def test_supervised_restart_replays_bitwise(jax_stream):
    stats = PipelineStats()
    spec = faults.arm("pipeline.worker", nth=3)
    got = list(ParallelTransformer(_chain(image), 3, base_seed=5,
                                   stats=stats, max_worker_restarts=2)
               .apply(iter(_imgs())))
    assert spec.fired == 1
    _assert_same(got, jax_stream)
    assert next(iter(stats.snapshot().values()))["restarts"] == 1


def test_abandoned_stream_joins_its_workers_and_the_stage():
    baseline = threading.active_count()
    stream = host_prefetch(ParallelTransformer(_chain(image), 3, base_seed=5)
                           .apply(iter(_imgs(200))), depth=2)
    next(stream)
    next(stream)
    stream.close()
    assert _threads_retire(baseline)


def test_host_prefetch_fails_after_the_buffered_items():
    def items():
        yield 1
        yield 2
        raise OSError("feed lost")

    stats = PipelineStats()
    got = []
    with pytest.raises(OSError, match="feed lost"):
        for item in host_prefetch(items(), depth=4, stats=stats):
            got.append(item)
    assert got == [1, 2]
    assert stats.snapshot()["stage"]["items"] == 2


@pytest.mark.parametrize("name", [
    "BytesToGreyImg", "GreyImgNormalizer", "GreyImgToSample",
    "BGRImgNormalizer", "RandomCropper", "CenterCropper", "HFlip",
    "BGRImgToSample", "MTImageToBatch"])
def test_image_transformer_is_bitwise_the_jax_one(name):
    rs = np.random.RandomState(3)
    grey = [(rs.randint(0, 256, 28 * 28).astype(np.uint8).tobytes(), i)
            for i in range(4)]
    grey_img = [(rs.rand(28, 28).astype(np.float32) * 255, i)
                for i in range(4)]
    chw = [(rs.randint(0, 256, (3, 20, 18)).astype(np.uint8), i)
           for i in range(6)]
    hwc = [(rs.randint(0, 256, (8, 8, 3)).astype(np.uint8), i)
           for i in range(6)]
    cases = {
        "BytesToGreyImg": ((28, 28), grey),
        "GreyImgNormalizer": ((33.3, 78.6), grey_img),
        "GreyImgToSample": ((), grey_img),
        "BGRImgNormalizer": ((MEANS, STDS), chw),
        "RandomCropper": ((12, 10, 2), chw),
        "CenterCropper": ((12, 10), chw),
        "HFlip": ((0.5,), chw),
        "BGRImgToSample": ((), chw),
        "MTImageToBatch": ((4, MEANS, STDS, 255.0, 2, True), hwc),
    }
    args, data = cases[name]
    kw_port, kw_jax = {}, {}
    if name in ("RandomCropper", "HFlip"):
        kw_port, kw_jax = {"rng": RandomGenerator(11)}, {"rng": JaxRG(11)}
    got = list(getattr(image, name)(*args, **kw_port)(data))
    want = list(getattr(jimage, name)(*args, **kw_jax)(data))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(_leaves(g), _leaves(w)):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)


def _leaves(item):
    if isinstance(item, tuple):
        return list(item)
    if hasattr(item, "feature"):
        return [item.feature, item.label]
    return [item.input, item.target]


def _to_sample(t):
    from bigdl_tpu_torch.dataset import Sample

    return Sample(np.float32(t[0]), np.int32(t[1]))


def test_set_data_pipeline_trains_through_the_pool():
    """2 and 3 workers give bitwise the same losses; the stages' counters
    reach the metrics and the step records."""
    rs = np.random.RandomState(1)
    x = rs.rand(64, 4).astype(np.float32)
    y = (x.sum(axis=1) > 2).astype(np.int64)
    runs = []
    for workers in (2, 3):
        g = torch.Generator().manual_seed(0)
        model = nn.Sequential(nn.Linear(4, 8, device="cpu", generator=g),
                              nn.ReLU(),
                              nn.Linear(8, 2, device="cpu", generator=g))
        ds = DataSet.array(list(zip(x, y)), rng=RandomGenerator(5)) \
            >> (FunctionTransformer(_to_sample) >> SampleToMiniBatch(16))
        opt = LocalOptimizer(model, ds, nn.CrossEntropyCriterion(), 16)
        opt.set_optim_method(SGD(0.5))
        opt.set_end_when(Trigger.max_iteration(6))
        opt.set_data_pipeline(workers, chunk=4)
        records = []
        handler = logging.Handler()
        handler.emit = records.append
        logger = logging.getLogger("bigdl_tpu_torch.optim")
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        try:
            opt.optimize()
        finally:
            logger.removeHandler(handler)
        runs.append([r.loss for r in records])
        snap = opt.pipeline_stats.snapshot()
        assert f"augment x{workers}" in snap
        assert snap["transfer"]["items"] >= 6 * 16
        assert records[-1].pipeline["stage"]["items"] >= 6
        assert opt.metrics.get("pipeline transfer items/s") >= 0
    assert runs[0] == runs[1] and len(runs[0]) == 6


def test_parallelize_chain_keeps_batching_serial():
    chain = (FunctionTransformer(_to_sample) >> FunctionTransformer(
        _to_sample) >> SampleToMiniBatch(4))
    wired = parallelize_chain(chain, 2)
    assert isinstance(wired.first, ParallelTransformer)
    assert isinstance(wired.second, SampleToMiniBatch)
    assert parallelize_chain(chain, 1) is chain



def test_the_loop_without_a_pipeline_reads_a_fixed_number_ahead():
    """Without ``set_data_pipeline`` there is no staging thread: a run
    stopped by its end trigger has drawn exactly two batches past its
    last step (the loop's next batch and the device copy's one ahead), so
    the next ``optimize()`` continues a dataset whose shuffle generator
    is where a resumed run expects it (the staging thread would read
    ahead by a number of batches that depends on its timing)."""
    from bigdl_tpu_torch.dataset import TensorDataSet

    class Counted(TensorDataSet):
        drawn = 0

        def _batch(self, idx):
            Counted.drawn += 1
            return super()._batch(idx)

    rs = np.random.RandomState(2)
    ds = Counted(rs.rand(64, 4).astype(np.float32), rs.randint(0, 2, 64),
                 RandomGenerator(3))
    g = torch.Generator().manual_seed(0)
    model = nn.Sequential(nn.Linear(4, 2, device="cpu", generator=g))
    opt = LocalOptimizer(model, ds, nn.CrossEntropyCriterion(), 8)
    opt.set_end_when(Trigger.max_iteration(3))
    opt.optimize()
    assert Counted.drawn == 3 + 2 and opt.host_prefetch_depth == 0
