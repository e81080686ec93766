"""The port's samples, transformer chains and datasets
(``dataset/sample.py``, ``transformer.py``, ``dataset.py``) against the
JAX package's: the same batches from the same samples, padded and partial
ones included, and the same element order from the same seed. Host
numpy on both sides, so equal means bitwise."""

import numpy as np
import pytest

from bigdl_tpu.core.rng import RandomGenerator as JaxRandomGenerator
from bigdl_tpu.dataset import dataset as jds
from bigdl_tpu.dataset import sample as jsample
from bigdl_tpu.dataset import transformer as jtr
from bigdl_tpu_torch.core import RandomGenerator
from bigdl_tpu_torch.dataset import (
    DataSet,
    FunctionTransformer,
    MiniBatch,
    PaddingParam,
    Sample,
    SampleToMiniBatch,
    Shuffle,
)


def _variable_samples(S):
    rs = np.random.RandomState(0)
    return [S.Sample.of(rs.randn(n, 3).astype(np.float32),
                        rs.randint(0, 5, (n,)))
            for n in (4, 2, 5, 3, 1, 4, 2)]


def _same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    np.testing.assert_array_equal(got, want)
    assert np.asarray(got).dtype == np.asarray(want).dtype


@pytest.mark.parametrize("fixed", [None, 3])
@pytest.mark.parametrize("partial", [False, True])
def test_padded_batches_match_jax(fixed, partial):
    port = _variable_samples(__import__("bigdl_tpu_torch.dataset.sample",
                                        fromlist=["Sample"]))
    ref = _variable_samples(jsample)
    pb = list(SampleToMiniBatch(3, PaddingParam(-1.0, fixed),
                                PaddingParam(0, fixed), partial)(port))
    jb = list(jtr.SampleToMiniBatch(3, jsample.PaddingParam(-1.0, fixed),
                                    jsample.PaddingParam(0, fixed),
                                    partial)(ref))
    assert len(pb) == len(jb) == (3 if partial else 2)
    for p, j in zip(pb, jb):
        _same(p.input, j.input)
        _same(p.target, j.target)
        assert p.size() == j.size()
    with pytest.raises(ValueError, match="PaddingParam"):
        list(SampleToMiniBatch(3)(port))


def test_tuple_features_stack_per_component():
    rs = np.random.RandomState(1)
    raw = [((rs.randn(2), rs.randn(3)), i) for i in range(4)]
    pb = MiniBatch.stack([Sample(f, np.int64(y)) for f, y in raw])
    jb = jsample.MiniBatch.stack([jsample.Sample(f, np.int64(y))
                                  for f, y in raw])
    _same(pb.input, jb.input)
    _same(pb.target, jb.target)
    assert pb.size() == 4


@pytest.mark.parametrize("seed", [0, 5])
def test_array_and_transformed_datasets_stream_as_jax(seed):
    rs = np.random.RandomState(seed)
    xs = rs.randn(10, 2).astype(np.float32)
    port = DataSet.array([Sample(xs[i], np.int32(i)) for i in range(10)],
                         RandomGenerator(seed)) \
        >> (FunctionTransformer(lambda s: Sample(s.feature * 2, s.label))
            >> SampleToMiniBatch(4, partial_batch=True))
    ref = jds.DataSet.array([jsample.Sample(xs[i], np.int32(i))
                             for i in range(10)], JaxRandomGenerator(seed)) \
        >> (jtr.FunctionTransformer(
            lambda s: jsample.Sample(s.feature * 2, s.label))
            >> jtr.SampleToMiniBatch(4, partial_batch=True))
    assert port.size() == ref.size() == 10
    for p, j in zip(port.data(train=False), ref.data(train=False)):
        _same(p.input, j.input)
        _same(p.target, j.target)
    tp, tj = port.data(train=True), ref.data(train=True)
    for _ in range(6):       # over two epochs' permutations
        p, j = next(tp), next(tj)
        _same(p.target, j.target)
        _same(p.input, j.input)


def test_tensor_dataset_samples_and_shuffle_match_jax():
    xs, ys = np.arange(12, dtype=np.float32)[:, None], np.arange(12)
    port = DataSet.tensors(xs, ys, RandomGenerator(2))
    ref = jds.DataSet.tensors(xs, ys, JaxRandomGenerator(2))
    assert [int(s.label) for s in port.data(False)] == \
        [int(s.label) for s in ref.data(False)]
    tp, tj = port.data(True), ref.data(True)
    assert [int(next(tp).label) for _ in range(20)] == \
        [int(next(tj).label) for _ in range(20)]
    got = list(Shuffle(RandomGenerator(4))(range(9)))
    assert got == list(jtr.Shuffle(JaxRandomGenerator(4))(range(9)))
    assert sorted(got) == list(range(9))
    # the default batches(): samples grouped, the last one partial
    arr = DataSet.array([Sample(xs[i], ys[i]) for i in range(5)])
    assert [b.size() for b in arr.batches(2, False, True)] == [2, 2, 1]
