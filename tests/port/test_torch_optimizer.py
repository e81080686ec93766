"""The port's training loop against the JAX package's ``LocalOptimizer``.

Same seeded weights (``_jax_trees.seeded_trees``), same data, same
``RandomGenerator(seed)`` for the shuffle: the loops must feed the same
batches in the same order, log the same losses and learning rates and
end with the same ``TrainingState``. Losses and final weights at fp32:
``rtol=1e-5`` (XLA's and PyTorch's CPU kernels sum in other orders).
Losses are read from the loops' own log records, which carry the float.
"""

import logging

import jax
import numpy as np
import pytest
import torch
from _jax_trees import assert_trees_close, seeded_trees

import bigdl_tpu.nn as jnn
from bigdl_tpu.core.rng import RandomGenerator as JaxRandomGenerator
from bigdl_tpu.dataset.dataset import DataSet as JaxDataSet
from bigdl_tpu.optim import optim_method as jopt
from bigdl_tpu.optim import schedules as jsched
from bigdl_tpu.optim.optimizer import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu.optim.trigger import Trigger as JaxTrigger
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.core import DtypePolicy, EngineConfig, RandomGenerator
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.dataset.prefetch import device_prefetch
from bigdl_tpu_torch.dataset.sample import MiniBatch
from bigdl_tpu_torch.interop import export_params, load_jax_params
from bigdl_tpu_torch.optim import (
    SGD,
    LocalOptimizer,
    MultiStep,
    Trigger,
    optimizer,
)

N, BATCH, CLASSES = 8, 4, 8


def _jax_model():
    return jnn.Sequential(
        jnn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1),
        jnn.SpatialBatchNormalization(4), jnn.ReLU(),
        jnn.GlobalAveragePooling2D(), jnn.Linear(4, CLASSES))


def _port_model():
    return nn.Sequential(
        nn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1, device="cpu"),
        nn.SpatialBatchNormalization(4, device="cpu"), nn.ReLU(),
        nn.GlobalAveragePooling2D(), nn.Linear(4, CLASSES, device="cpu"))


def _data():
    rs = np.random.RandomState(11)
    return rs.standard_normal((N, 3, 6, 6)).astype(np.float32), \
        np.arange(N) % CLASSES


def _recording(ds, seen):
    inner = ds.batches

    def batches(*args, **kwargs):
        for b in inner(*args, **kwargs):
            seen.append(np.asarray(b.target).tolist())
            yield b

    ds.batches = batches
    return ds


def _log_args(caplog, logger):
    return [r.args for r in caplog.records if r.name == logger]


ENDS = {"max_iteration_3": lambda T: T.max_iteration(3),
        "max_epoch_1": lambda T: T.max_epoch(1),
        "or": lambda T: T.or_(T.max_iteration(5), T.max_epoch(2))}


@pytest.mark.parametrize("end", sorted(ENDS))
def test_local_optimizer_matches_jax(caplog, end):
    caplog.set_level(logging.INFO)
    jm = _jax_model()
    params, state = seeded_trees(jm, seed=5)
    x, y = _data()
    jax_seen, port_seen = [], []

    jds = _recording(JaxDataSet.tensors(x, y, JaxRandomGenerator(3)),
                     jax_seen)
    jopt_ = JaxLocalOptimizer(jm, jds, jnn.CrossEntropyCriterion(), BATCH)
    jopt_.set_model_and_state(params, state)
    jopt_.set_optim_method(jopt.SGD(0.1, momentum=0.9,
                                    schedule=jsched.MultiStep([2], 0.5)))
    jopt_.set_end_when(ENDS[end](JaxTrigger))
    jparams, _ = jopt_.optimize()

    tm = load_jax_params(_port_model(), params, state)
    tds = _recording(DataSet.tensors(x, y, RandomGenerator(3)), port_seen)
    topt = optimizer(tm, tds, nn.CrossEntropyCriterion(), BATCH)
    assert isinstance(topt, LocalOptimizer)
    topt.set_optim_method(SGD(0.1, momentum=0.9,
                              schedule=MultiStep([2], 0.5)))
    topt.set_end_when(ENDS[end](Trigger))
    topt.optimize()

    jlog = _log_args(caplog, "bigdl_tpu.optim")
    tlog = _log_args(caplog, "bigdl_tpu_torch.optim")
    steps = len(jlog)
    assert steps == len(tlog) == jopt_.state.iteration >= 2
    assert port_seen[:steps] == jax_seen[:steps]
    for (je, ji, jl, jlr, _), (te, ti, tl, tlr, _) in zip(jlog, tlog):
        assert (te, ti) == (je, ji)
        np.testing.assert_allclose(tlr, jlr, rtol=1e-7)   # JAX: fp32 lr
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for r in caplog.records:
        if r.name == "bigdl_tpu_torch.optim":
            # the named fields agree with the formatted ones
            assert r.loss == r.args[2] and r.step_seconds > 0
    js, ts = jopt_.state, topt.state
    assert (ts.epoch, ts.iteration, ts.records_processed_this_epoch,
            ts.epoch_finished) == (js.epoch, js.iteration,
                                   js.records_processed_this_epoch,
                                   js.epoch_finished)
    np.testing.assert_allclose(ts.loss, js.loss, rtol=1e-5)
    assert topt.optim_state["step"] == steps
    assert_trees_close(export_params(tm), jax.device_get(jparams),
                       rtol=1e-5, atol=1e-5, what="param")


def test_multistep_tenth_matches_jax_bitwise_across_the_milestone():
    """gamma = 0.1, whose powers binary fractions do not hold exactly: at
    each step count before, at and after the milestone, the port's rate
    equals the JAX package's jitted one (as its training loop computes it)
    in every bit, and so does a momentum-SGD update of 1000 parameters
    from that step count (velocity zero, so the update's own arithmetic is
    one product and one difference on both sides, and only the rate can
    move a bit)."""
    rs = np.random.RandomState(21)
    p0 = rs.standard_normal(1000).astype(np.float32)
    jm = jopt.SGD(0.1, momentum=0.9, schedule=jsched.MultiStep([2], 0.1))
    tm = SGD(0.1, momentum=0.9, schedule=MultiStep([2], 0.1))
    update = jax.jit(jm.update)
    rate = jax.jit(lambda step: jm.current_lr({"step": step}))
    for step in range(4):
        g = rs.standard_normal(1000).astype(np.float32)
        tparams = {"w": torch.from_numpy(p0.copy())}
        tstate = dict(tm.init_state(tparams), step=step)
        want = np.float32(rate(np.int32(step)))
        assert np.float32(tm.current_lr(tstate)).view(np.uint32) == \
            want.view(np.uint32), (step, tm.current_lr(tstate), want)
        jparams, _ = update({"w": g}, {"w": p0},
                            dict(jm.init_state({"w": p0}),
                                 step=np.int32(step)))
        tm.update({"w": torch.from_numpy(g)}, tparams, tstate)
        np.testing.assert_array_equal(
            tparams["w"].numpy().view(np.uint32),
            np.asarray(jparams["w"]).view(np.uint32), err_msg=f"step {step}")
    assert want == np.float32(0.1) * np.float32(0.1)


def test_optimize_continues_from_its_state():
    x, y = _data()
    opt = optimizer(_port_model(), DataSet.tensors(x, y, RandomGenerator(1)),
                    nn.CrossEntropyCriterion(), BATCH)
    opt.set_end_when(Trigger.max_iteration(2))
    params, buffers = opt.optimize()
    assert opt.state.iteration == 2 and opt.state.epoch == 2
    assert set(params) == {"0.weight", "0.bias", "1.weight", "1.bias",
                           "4.weight", "4.bias"}
    assert set(buffers) == {"1.running_mean", "1.running_var"}
    opt.set_end_when(Trigger.max_iteration(5))
    opt.optimize()
    assert opt.state.iteration == 5 and opt.optim_state["step"] == 5
    assert opt.metrics.get("throughput") > 0
    assert opt.metrics.get("computing time for each iteration") > 0


def test_mixed_policy_step_keeps_fp32_masters():
    x, y = _data()
    model = _port_model()
    opt = optimizer(model, DataSet.tensors(x, y, RandomGenerator(1)),
                    nn.CrossEntropyCriterion(), BATCH,
                    EngineConfig(dtypes=DtypePolicy.mixed()))
    opt.set_optim_method(SGD(0.1, momentum=0.9))
    opt.set_end_when(Trigger.max_iteration(3))
    params, buffers = opt.optimize()
    assert np.isfinite(opt.state.loss)
    assert all(p.dtype == torch.float32 for p in params.values())
    assert all(b.dtype == torch.float32 for b in buffers.values())
    assert all(v.dtype == torch.float32
               for v in opt.optim_state["velocity"].values())


@pytest.mark.parametrize("setter", ["set_data_pipeline"])
def test_setters_outside_the_slice_raise(setter):
    """The setter is ported: a worker count that is not a number raises
    the JAX loop's ``TypeError``, and a count is kept with a fresh
    ``PipelineStats``, as the JAX loop keeps it."""
    x, y = _data()
    opt = optimizer(_port_model(), DataSet.tensors(x, y),
                    nn.CrossEntropyCriterion(), BATCH)
    ref = JaxLocalOptimizer(jnn.Linear(2, 2), JaxDataSet.tensors(x, y),
                            jnn.CrossEntropyCriterion(), BATCH)
    for o in (opt, ref):
        with pytest.raises(TypeError):
            getattr(o, setter)(None)
        assert getattr(o, setter)(3, host_depth=5) is o
        assert (o.pipeline_n_workers, o.host_prefetch_depth) == (3, 5)
        assert o.pipeline_stats.snapshot() == {}


@pytest.mark.parametrize("seed", [0, 4])
def test_tensor_dataset_streams_match_jax(seed):
    x, y = np.arange(10, dtype=np.float32)[:, None], np.arange(10)
    port = DataSet.tensors(x, y, RandomGenerator(seed))
    ref = JaxDataSet.tensors(x, y, JaxRandomGenerator(seed))
    tb, jb = port.batches(3, train=True), ref.batches(3, train=True)
    for _ in range(7):          # three per epoch, drop-last, over epochs
        np.testing.assert_array_equal(next(tb).target, next(jb).target)
    for partial in (False, True):
        got = [b.target.tolist() for b in port.batches(4, False, partial)]
        want = [b.target.tolist() for b in ref.batches(4, False, partial)]
        assert got == want
    with pytest.raises(ValueError, match="exceeds dataset size"):
        port.batches(11, train=True)


def test_device_prefetch_on_cpu_yields_the_batches():
    batches = [MiniBatch(np.full((2, 3), i, np.float32), np.array([i, i]))
               for i in range(3)]
    got = list(device_prefetch(iter(batches), torch.device("cpu")))
    assert len(got) == 3
    for i, (inp, tgt) in enumerate(got):
        assert inp.device.type == "cpu" and torch.equal(
            inp, torch.full((2, 3), float(i)))
        assert tgt.tolist() == [i, i]
    with pytest.raises(TypeError, match="numpy arrays"):
        list(device_prefetch(iter([MiniBatch([1.0])]), torch.device("cpu")))
