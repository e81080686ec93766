"""The port's ``Predictor`` on lists of ``Sample``s and ``Evaluator``
against the JAX package's (``tests/test_predictor.py``'s cases): a small
MLP with the JAX model's seeded weights bridged in, 37 rows evaluated in
batches of 8 (the last partial). Values within 1e-5 (fp32, the two
packages' CPU GEMMs sum in other orders), counts equal."""

import jax
import numpy as np
import pytest
from _jax_trees import seeded_trees

import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset.sample import Sample as JaxSample
from bigdl_tpu.optim import predictor as jpred
from bigdl_tpu.optim import validation as jval
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import DataSet, Sample
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.optim import (
    Evaluator,
    Loss,
    MeanAveragePrecision,
    PrecisionRecallAUC,
    Predictor,
    Top1Accuracy,
    TopKAccuracy,
)

RTOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4),
                        jnn.LogSoftMax())
    params, _ = seeded_trees(jm, 0)
    tm = load_jax_params(nn.Sequential(
        nn.Linear(8, 16, device="cpu"), nn.ReLU(),
        nn.Linear(16, 4, device="cpu"), nn.LogSoftMax()), params)
    rs = np.random.RandomState(0)
    return jm, params, tm, rs.rand(37, 8).astype(np.float32), \
        rs.randint(0, 4, 37)


def test_predictor_takes_a_list_of_samples(setup):
    jm, params, tm, x, y = setup
    got = Predictor(tm, device="cpu", batch_size=8).predict(
        [Sample.of(x[i], y[i]) for i in range(10)])
    want = jpred.Predictor(jm, params, batch_size=8).predict(
        [JaxSample.of(x[i], y[i]) for i in range(10)])
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=1e-6)


def test_evaluator_matches_jax_with_host_methods(setup):
    jm, params, tm, x, y = setup
    got = Evaluator(tm, device="cpu", batch_size=8).test(
        DataSet.tensors(x, y),
        [Top1Accuracy(), TopKAccuracy(2), Loss(nn.ClassNLLCriterion()),
         Loss(nn.ClassNLLCriterion(size_average=False)),
         MeanAveragePrecision(4)])
    want = jpred.Evaluator(jm, params, batch_size=8).test(
        JaxDataSet.tensors(x, y),
        [jval.Top1Accuracy(), jval.TopKAccuracy(2),
         jval.Loss(jnn.ClassNLLCriterion()),
         jval.Loss(jnn.ClassNLLCriterion(size_average=False)),
         jval.MeanAveragePrecision(4)])
    assert [r.name for r in got] == [r.name for r in want]
    for g, w in zip(got, want):
        assert g.count == w.count == 37
        np.testing.assert_allclose(g.result()[0], w.result()[0], rtol=RTOL)
    assert got[2].result()[0] != got[3].result()[0]   # kept apart by place


def test_precision_recall_auc_matches_jax():
    rs = np.random.RandomState(2)
    jm = jnn.Sequential(jnn.Linear(8, 1))
    params, _ = seeded_trees(jm, 1)
    tm = load_jax_params(nn.Sequential(nn.Linear(8, 1, device="cpu")),
                         params)
    x = rs.rand(37, 8).astype(np.float32)
    yb = rs.randint(0, 2, 37).astype(np.float32)
    (got,) = Evaluator(tm, device="cpu", batch_size=8).test(
        DataSet.tensors(x, yb), [PrecisionRecallAUC()])
    (want,) = jpred.Evaluator(jm, params, batch_size=8).test(
        JaxDataSet.tensors(x, yb), [jval.PrecisionRecallAUC()])
    assert got.count == want.count == 37
    np.testing.assert_allclose(got.result()[0], want.result()[0], rtol=RTOL)


def test_evaluator_requires_labels(setup):
    _, _, tm, x, _ = setup
    with pytest.raises(ValueError, match="labels"):
        Evaluator(tm, device="cpu").test(DataSet.tensors(x), [Top1Accuracy()])
    assert tm.training    # left in the mode it was in
