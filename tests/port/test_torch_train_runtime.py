"""The port's training runtime against the JAX package's ``LocalOptimizer``
on the MLP and data of ``tests/test_training.py``: validation, checkpoints
that cross both ways, gradient clipping, optim methods per child, the
seven other optim methods, every schedule, summaries, the watchdog,
retry, preemption and the registry hook.

Tolerances: trained weights, optim buffers and losses of the two packages
within ``rtol=1e-5`` (fp32; XLA's and PyTorch's CPU kernels sum in other
orders), each optim method over 5 updates within ``rtol=1e-5, atol=1e-6``
of the leaf's scale; the port against itself (resume against a straight
run) bitwise; the schedules bitwise against the jitted JAX schedule,
except ``NaturalExp``, within 1 ulp (XLA's CPU ``exp`` is its own
approximation).
"""

import logging
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_trees import assert_trees_close, flat, seeded_trees

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.optim import validation as jval
from bigdl_tpu.core.rng import RandomGenerator as JaxRandomGenerator
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.optim import optim_method as jom
from bigdl_tpu.optim import schedules as jsched
from bigdl_tpu.visualization.summary import Summary as JaxSummary
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.ckpt import load_manifest
from bigdl_tpu_torch.core import EngineConfig, RandomGenerator
from bigdl_tpu_torch.dataset import (
    AbstractDataSet,
    DataSet,
    FunctionTransformer,
    MiniBatch,
)
from bigdl_tpu_torch.interop import export_params, load_jax_params
from bigdl_tpu_torch.obs import MetricsRegistry
from bigdl_tpu_torch.optim import schedules as tsched
from bigdl_tpu_torch.visualization import TrainSummary, ValidationSummary

RTOL = 1e-5
BATCH = 32


def _toy_data(n=128, seed=0):
    """Linearly separable 2-class data (``tests/test_training.py``)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 4).astype(np.float32)
    w = np.asarray([[1.0, -1.0, 0.5, 2.0]], np.float32)
    return x, (x @ w.T > 0).astype(np.int32)[:, 0]


def _jax_mlp():
    return jnn.Sequential(jnn.Linear(4, 16), jnn.ReLU(), jnn.Linear(16, 2),
                          jnn.LogSoftMax())


def _port_mlp(params=None):
    model = nn.Sequential(nn.Linear(4, 16, device="cpu"), nn.ReLU(),
                          nn.Linear(16, 2, device="cpu"), nn.LogSoftMax())
    return model if params is None else load_jax_params(model, params)


@pytest.fixture(scope="module")
def mlp_params():
    return seeded_trees(_jax_mlp(), seed=4)[0]


def _jax_opt(params, x, y, seed, method, end):
    opt = joptim.LocalOptimizer(
        _jax_mlp(), JaxDataSet.tensors(x, y, JaxRandomGenerator(seed)),
        jnn.ClassNLLCriterion(), batch_size=BATCH)
    opt.set_model_and_state(params, {})
    opt.set_optim_method(method)
    opt.set_end_when(joptim.Trigger.max_iteration(end))
    return opt


def _port_opt(params, x, y, seed, method, end, rng=None):
    opt = optim.LocalOptimizer(
        _port_mlp(params), DataSet.tensors(x, y, rng or RandomGenerator(seed)),
        nn.ClassNLLCriterion(), BATCH,
        EngineConfig(failure_retry_interval_sec=0.0))
    opt.set_optim_method(method)
    opt.set_end_when(optim.Trigger.max_iteration(end))
    return opt


def _sgd(M, S):
    return M.SGD(0.2, momentum=0.9, weight_decay=1e-3,
                 schedule=S.Step(3, 0.5))


def _velocity(opt_state):
    return jax.device_get(opt_state["__all__"]["velocity"])


# ------------------------------------------------------------ validation --

def test_validation_matches_jax_with_partial_last_batch(mlp_params):
    x, y = _toy_data(100)   # 100 = 48 + 48 + 4
    names = ("Top1Accuracy", "Loss", "TreeNNAccuracy", "HitRatio@1")
    jopt = _jax_opt(mlp_params, x, y, 1, jom.SGD(0.5), 2)
    jopt.set_validation(
        joptim.Trigger.max_iteration(2), JaxDataSet.tensors(x, y),
        [joptim.Top1Accuracy(), joptim.Loss(jnn.ClassNLLCriterion()),
         jval.TreeNNAccuracy(), jval.HitRatio(k=1)], batch_size=48)
    jopt.optimize()
    want = jopt._run_validation()

    topt = _port_opt(mlp_params, x, y, 1, optim.SGD(0.5), 2)
    topt.set_validation(
        optim.Trigger.max_iteration(2), DataSet.tensors(x, y),
        [optim.Top1Accuracy(), optim.Loss(nn.ClassNLLCriterion()),
         optim.TreeNNAccuracy(), optim.HitRatio(k=1)], batch_size=48)
    topt.optimize()
    assert topt.model.training   # validation at 2 left it in train mode
    got = topt._run_validation()
    assert [r.name for r in got] == [r.name for r in want] == list(names)
    for g, w in zip(got, want):
        assert g.count == w.count == 100, g    # the 4-sample tail counted
        np.testing.assert_allclose(g.result()[0], w.result()[0], rtol=RTOL)
    assert topt.state.score == got[0].result()[0]


# ----------------------------------------------------- checkpoints / resume --

def test_resume_equals_a_straight_run_bitwise(mlp_params, tmp_path):
    """12 iterations straight, and 6 + a resume from the checkpoint at 6
    to 12: the same weights, velocity and losses, bit for bit. 6 is an
    epoch's end (192 samples, batch 32); the resumed dataset's generator
    is advanced past the first epoch's permutation, as the straight
    run's is."""
    x, y = _toy_data(192)
    method = lambda: optim.SGD(0.2, momentum=0.9, weight_decay=1e-3,  # noqa
                               schedule=optim.Step(4, 0.5))
    straight = _port_opt(mlp_params, x, y, 3, method(), 12)
    straight.optimize()

    first = _port_opt(mlp_params, x, y, 3, method(), 6)
    first.set_checkpoint(str(tmp_path), optim.Trigger.several_iteration(6))
    first.optimize()
    rng = RandomGenerator(3)
    rng.permutation(len(x))
    resumed = _port_opt(None, x, y, 3, method(), 12, rng=rng)
    resumed.set_checkpoint(str(tmp_path), optim.Trigger.several_iteration(6),
                           auto_resume=True)
    resumed.optimize()
    assert resumed.state.iteration == 12 and resumed.optim_state["step"] == 12
    for name, p in straight.model.named_parameters():
        assert torch.equal(p, dict(resumed.model.named_parameters())[name])
    for name, v in straight.optim_state["velocity"].items():
        assert torch.equal(v, resumed.optim_state["velocity"][name])
    assert [e.step for e in load_manifest(str(tmp_path))] == [6, 12]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_between_the_packages(mlp_params, tmp_path, writer):
    """A checkpoint at 4 written by one package, continued to 8 by each:
    the two continuations agree within RTOL (weights, velocity, loss)."""
    x, y = _toy_data()
    if writer == "jax":
        w = _jax_opt(mlp_params, x, y, 1, _sgd(jom, jsched), 4)
    else:
        w = _port_opt(mlp_params, x, y, 1, _sgd(optim, optim), 4)
    trigger = (joptim.Trigger if writer == "jax" else optim.Trigger)
    w.set_checkpoint(str(tmp_path), trigger.several_iteration(4))
    w.optimize()

    jcont = _jax_opt(seeded_trees(_jax_mlp(), seed=9)[0], x, y, 7,
                     _sgd(jom, jsched), 8)
    jcont.set_checkpoint(str(tmp_path), joptim.Trigger.several_iteration(100))
    jcont._restore_latest()
    assert jcont.state.iteration == 4
    jparams, _ = jcont.optimize()

    tcont = _port_opt(None, x, y, 7, _sgd(optim, optim), 8)
    tcont.set_checkpoint(str(tmp_path), optim.Trigger.several_iteration(100),
                         auto_resume=True)
    tcont.optimize()
    assert tcont.state.iteration == jcont.state.iteration == 8
    assert tcont.optim_state["step"] == 8
    np.testing.assert_allclose(tcont.state.loss, jcont.state.loss, rtol=RTOL)
    tol = dict(rtol=RTOL, atol=1e-6)
    assert_trees_close(export_params(tcont.model), jax.device_get(jparams),
                       what="param", **tol)
    assert_trees_close(
        {k: v.numpy() for k, v in tcont.optim_state["velocity"].items()},
        flat(_velocity(jcont._optim_state)),
        what="velocity", **tol)


def test_restored_run_does_not_resave_the_restored_step(mlp_params,
                                                         tmp_path):
    x, y = _toy_data(64)
    opt = _port_opt(mlp_params, x, y, 1, optim.SGD(0.5), 4)
    opt.set_checkpoint(str(tmp_path), optim.Trigger.several_iteration(2))
    opt.optimize()
    n_before = len(load_manifest(str(tmp_path)))
    opt2 = _port_opt(mlp_params, x, y, 1, optim.SGD(0.5), 4)
    opt2.set_checkpoint(str(tmp_path), optim.Trigger.several_iteration(2))
    opt2._restore_latest()
    assert opt2.state.iteration == 4
    opt2._save_checkpoint()      # the trigger would fire here, 4 % 2 == 0
    opt2.checkpoint_manager.wait()
    assert len(load_manifest(str(tmp_path))) == n_before


def test_auto_resume_keeps_warm_start_weights_when_nothing_restores(
        mlp_params, tmp_path):
    x, y = _toy_data(64)
    opt = _port_opt(mlp_params, x, y, 1, optim.SGD(0.5), 2)
    opt.set_checkpoint(str(tmp_path), optim.Trigger.several_iteration(2))
    opt.optimize()
    entry = load_manifest(str(tmp_path))[-1]
    blob = bytearray((tmp_path / entry.file).read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    (tmp_path / entry.file).write_bytes(bytes(blob))

    warm = seeded_trees(_jax_mlp(), seed=8)[0]
    opt2 = _port_opt(None, x, y, 1, optim.SGD(0.5), 2)
    opt2.set_checkpoint(str(tmp_path), optim.Trigger.several_iteration(2))
    opt2.set_model_and_state(warm)
    opt2._restore_latest(reset_on_missing=False)
    np.testing.assert_array_equal(
        opt2.model[0].weight.detach().numpy(), warm["0"]["weight"])


def test_retry_after_a_failing_step_resumes_from_the_checkpoint(
        mlp_params, tmp_path, caplog):
    """The fifth forward raises once: optimize() retries from the
    checkpoint at 4 and ends at 8 as an unbroken run would."""
    x, y = _toy_data()
    opt = _port_opt(mlp_params, x, y, 1, optim.SGD(0.5, momentum=0.9), 8)
    calls = []

    def fail_once(module, args):
        calls.append(1)
        if len(calls) == 5:
            raise RuntimeError("injected layer failure")

    opt.model[0].register_forward_pre_hook(fail_once)
    opt.set_checkpoint(str(tmp_path), optim.Trigger.several_iteration(2))
    caplog.set_level(logging.INFO, "bigdl_tpu_torch.optim")
    opt.optimize()
    restored = [r.args for r in caplog.records
                if r.msg.startswith("restored checkpoint")]
    assert restored == [("model.iter4", 4, 1, "")]
    assert opt.state.iteration == 8 and opt.optim_state["step"] == 8
    assert [e.step for e in load_manifest(str(tmp_path))] == [2, 4, 6, 8]


def test_retry_with_nothing_restorable_starts_from_the_first_weights(
        mlp_params, tmp_path):
    x, y = _toy_data()
    opt = _port_opt(mlp_params, x, y, 1, optim.SGD(0.5, momentum=0.9), 3)
    seen = []

    def fail_first(module, args):
        seen.append(module.weight.detach().clone())
        if len(seen) == 2:
            raise RuntimeError("injected layer failure")

    opt.model[0].register_forward_pre_hook(fail_first)
    opt.set_checkpoint(str(tmp_path), optim.Trigger.several_iteration(10))
    opt.optimize()
    assert not torch.equal(seen[1], seen[0])     # step 1 moved the weights
    assert torch.equal(seen[2], seen[0])         # the retry starts over
    assert opt.state.iteration == 3


class _PreemptingDataSet(DataSet.tensors(np.zeros((1, 4))).__class__):
    """Requests preemption (as SIGTERM would) before batch ``at``."""

    def __init__(self, x, y, at, get_mgr):
        super().__init__(x, y, RandomGenerator(1))
        self.at, self.get_mgr, self.count = at, get_mgr, 0

    def batches(self, batch_size, train, partial_batch=False):
        for b in super().batches(batch_size, train, partial_batch):
            self.count += 1
            if self.count == self.at:
                self.get_mgr().request_preemption()
            yield b


def test_preemption_saves_a_marked_entry_and_stops(mlp_params, tmp_path):
    x, y = _toy_data()
    holder = {}
    opt = optim.LocalOptimizer(
        _port_mlp(mlp_params),
        _PreemptingDataSet(x, y, 5, lambda: holder["mgr"]),
        nn.ClassNLLCriterion(), BATCH)
    opt.set_optim_method(optim.SGD(0.5))
    opt.set_checkpoint(str(tmp_path), optim.Trigger.several_iteration(2))
    holder["mgr"] = opt.checkpoint_manager
    opt.set_end_when(optim.Trigger.max_iteration(1000))
    opt.optimize()
    stopped = opt.state.iteration
    assert 1 <= stopped <= 5
    entries = load_manifest(str(tmp_path))
    assert entries[-1].step == stopped and entries[-1].preempted
    opt2 = _port_opt(mlp_params, x, y, 1, optim.SGD(0.5), 10)
    opt2.set_checkpoint(str(tmp_path), optim.Trigger.several_iteration(2))
    opt2._restore_latest()
    assert opt2.state.iteration == stopped


# -------------------------------------------------------------- clipping --

@pytest.mark.parametrize("clip", ["const", "l2norm"])
def test_gradient_clipping_matches_jax(mlp_params, clip):
    x, y = _toy_data()
    jopt = _jax_opt(mlp_params, x, y, 2, jom.SGD(1.0, momentum=0.5), 5)
    topt = _port_opt(mlp_params, x, y, 2, optim.SGD(1.0, momentum=0.5), 5)
    for opt in (jopt, topt):
        if clip == "const":
            opt.set_gradclip_const(-0.02, 0.02)
        else:
            opt.set_gradclip_l2norm(0.05)
    jparams, _ = jopt.optimize()
    topt.optimize()
    assert_trees_close(export_params(topt.model), jax.device_get(jparams),
                       rtol=RTOL, atol=1e-6, what=clip)
    unclipped = _port_opt(mlp_params, x, y, 2, optim.SGD(1.0, momentum=0.5),
                          5)
    unclipped.optimize()
    assert not torch.equal(unclipped.model[0].weight, topt.model[0].weight)


def test_optim_methods_per_child_match_jax(mlp_params):
    x, y = _toy_data()
    jopt = _jax_opt(mlp_params, x, y, 2, None, 4)
    jopt.set_optim_methods({"0": jom.SGD(0.3, momentum=0.9),
                            "__default__": jom.Adam(0.01)})
    jparams, _ = jopt.optimize()
    topt = _port_opt(mlp_params, x, y, 2, optim.SGD(), 4)
    topt.set_optim_methods({"0": optim.SGD(0.3, momentum=0.9),
                            "__default__": optim.Adam(0.01)})
    topt.optimize()
    assert set(topt.optim_states) == {"0", "__default__"}
    assert sorted(topt.optim_states["__default__"]["m"]) == ["2.bias",
                                                             "2.weight"]
    with pytest.raises(ValueError, match="optim_states"):
        topt.optim_state
    assert_trees_close(export_params(topt.model), jax.device_get(jparams),
                       rtol=RTOL, atol=1e-6, what="param")
    bad = _port_opt(mlp_params, x, y, 2, optim.SGD(), 1)
    bad.set_optim_methods({"nope": optim.SGD(), "__default__": optim.SGD()})
    with pytest.raises(ValueError, match="match no top-level"):
        bad.optimize()


# --------------------------------------------------------- optim methods --

METHODS = {
    "Adam": lambda M, S: M.Adam(0.01, weight_decay=0.01,
                                schedule=S.Step(2, 0.5)),
    "Adagrad": lambda M, S: M.Adagrad(0.05, weight_decay=0.02),
    "Adadelta": lambda M, S: M.Adadelta(0.8, 1e-6),
    "Adamax": lambda M, S: M.Adamax(0.01),
    "RMSprop": lambda M, S: M.RMSprop(0.01, schedule=S.Poly(0.5, 8)),
    "Ftrl": lambda M, S: M.Ftrl(0.05, -0.5, 0.1, 0.01, 0.02),
    "LarsSGD": lambda M, S: M.LarsSGD(0.1, 0.9, 5e-3, 0.01,
                                      schedule=S.Exponential(2, 0.9)),
}


@pytest.mark.parametrize("name", sorted(METHODS))
def test_optim_method_matches_jax_over_five_updates(name):
    rs = np.random.RandomState(sorted(METHODS).index(name))
    p0 = {"a": rs.randn(6, 5).astype(np.float32),
          "b": rs.randn(7).astype(np.float32)}
    jm, tm = METHODS[name](jom, jsched), METHODS[name](optim, optim)
    jparams, jstate = p0, jm.init_state(p0)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    tstate = tm.init_state(tparams)
    for _ in range(5):
        g = {k: rs.randn(*v.shape).astype(np.float32) for k, v in p0.items()}
        jparams, jstate = jm.update(g, jparams, jstate, jnp.int32(1))
        tm.update({k: torch.from_numpy(v) for k, v in g.items()}, tparams,
                  tstate, 1)
    assert tstate["step"] == int(jstate["step"]) == 5
    tol = dict(rtol=RTOL, atol=1e-6)
    assert_trees_close({k: v.numpy() for k, v in tparams.items()},
                       jax.device_get(jparams), what=name, **tol)
    for buf in set(jstate) - {"step"}:
        assert_trees_close({k: v.numpy() for k, v in tstate[buf].items()},
                           jax.device_get(jstate[buf]), what=buf, **tol)
    assert tm.get_hyper_parameters() == jm.get_hyper_parameters()


# ------------------------------------------------------------- schedules --

SCHEDULES = {
    "Step": lambda S: S.Step(3, 0.7),
    "MultiStep": lambda S: S.MultiStep([3, 7, 11], 0.3),
    "Poly0.5": lambda S: S.Poly(0.5, 10),
    "Poly2": lambda S: S.Poly(2.0, 7),
    "Poly1.5": lambda S: S.Poly(1.5, 9),
    "Exponential": lambda S: S.Exponential(4, 0.93),
    "ExponentialStaircase": lambda S: S.Exponential(4, 0.93, True),
    "NaturalExp": lambda S: S.NaturalExp(3, 0.37),
    "EpochDecay": lambda S: S.EpochDecay(2),
    "EpochStep": lambda S: S.EpochStep(2, 0.6),
    "EpochSchedule": lambda S: S.EpochSchedule([(1, 2, 0.05), (3, 5, 0.02)]),
    "Warmup": lambda S: S.Warmup(0.013),
    "Sequential": lambda S: S.SequentialSchedule(
        [(S.Warmup(0.07), 2), (S.Poly(0.5, 8), None)]),
    "Sequential3": lambda S: S.SequentialSchedule(
        [(S.Exponential(2, 0.9), 4), (S.Step(2, 0.5), 6),
         (S.Default(), None)]),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_equals_jitted_jax_bitwise(name):
    jax_s, port_s = SCHEDULES[name](jsched), SCHEDULES[name](tsched)
    rate = jax.jit(lambda step, epoch: jnp.asarray(
        jax_s(0.1, step, epoch), jnp.float32))
    ulps = 1 if name == "NaturalExp" else 0
    for step in range(30):
        epoch = step // 3 + 1
        want = np.asarray(rate(np.int32(step), np.int32(epoch)))
        got = np.float32(port_s(0.1, step, epoch))
        diff = abs(int(want.view(np.int32)) - int(got.view(np.int32)))
        assert diff <= ulps, (name, step, want, got)


def test_plateau_follows_jax_over_a_score_series():
    scores = [1.0, 0.9, 0.95, 0.96, 0.97, 0.8, 0.81, 0.82, 0.83, 0.84, 0.85]
    j = jsched.Plateau(factor=0.5, patience=2, cooldown=1, min_lr=0.01)
    t = tsched.Plateau(factor=0.5, patience=2, cooldown=1, min_lr=0.01)
    got = [t.update(s, base_lr=0.1) for s in scores]
    assert got == [j.update(s, base_lr=0.1) for s in scores]
    assert got[-1] < 1.0


# ------------------------------------------------------------- summaries --

def test_summaries_are_read_by_the_jax_package(mlp_params, tmp_path):
    x, y = _toy_data()
    opt = _port_opt(mlp_params, x, y, 1, optim.SGD(
        0.5, schedule=optim.SequentialSchedule(
            [(optim.Warmup(0.1), 2), (optim.Poly(0.5, 8), None)])), 4)
    ts = TrainSummary(str(tmp_path), "app").set_summary_trigger(
        "Parameters", optim.Trigger.several_iteration(2))
    vs = ValidationSummary(str(tmp_path), "app")
    opt.set_train_summary(ts).set_val_summary(vs)
    opt.set_validation(optim.Trigger.several_iteration(2),
                       DataSet.tensors(x, y), [optim.Top1Accuracy()])
    opt.optimize()
    ts.close(), vs.close()
    for tag in ("Loss", "Throughput", "LearningRate"):
        mine = ts.read_scalar(tag)
        assert [s for s, _ in mine] == [1, 2, 3, 4]
        assert JaxSummary(str(tmp_path), "app", "/train").read_scalar(
            tag) == mine
    lrs = [v for _, v in ts.read_scalar("LearningRate")]
    sched = opt.optim_methods["__all__"].schedule
    assert lrs == [np.float32(sched(0.5, i)) for i in range(4)]
    accs = JaxSummary(str(tmp_path), "app", "/validation").read_scalar(
        "Top1Accuracy")
    assert [s for s, _ in accs] == [2, 4] and accs == vs.read_scalar(
        "Top1Accuracy")
    assert any("0/weight" in n.decode(errors="ignore") for n in [
        (tmp_path / "app" / "train" / f).read_bytes()
        for f in os.listdir(tmp_path / "app" / "train")])


# ------------------------------------------------- watchdog and registry --

class _Feed(AbstractDataSet):
    """Two batches, then blocks until ``fail()`` poisons it."""

    def __init__(self, x, y):
        self.x, self.y = x, y
        self.error = None
        self.failed = threading.Event()

    def size(self):
        return 1000

    def fail(self, err):
        self.error = err
        self.failed.set()

    def data(self, train):
        for i in range(2):
            yield MiniBatch(self.x[i * 8:(i + 1) * 8], self.y[i * 8:(i + 1) * 8])
        self.failed.wait(30)
        raise IOError("feed failed") from self.error


def test_watchdog_poisons_a_stalled_feed(mlp_params):
    from bigdl_tpu_torch.faults import StallError

    x, y = _toy_data()
    opt = optim.LocalOptimizer(_port_mlp(mlp_params),
                               _Feed(x, y) >> FunctionTransformer(lambda b: b),
                               nn.ClassNLLCriterion(), 8)
    opt.set_end_when(optim.Trigger.max_iteration(5))
    opt.set_watchdog(0.3)
    with pytest.raises(IOError, match="feed failed") as ei:
        opt.optimize()
    assert isinstance(opt.watchdog_error, StallError)
    assert isinstance(ei.value.__cause__, StallError)
    with pytest.raises(ValueError, match="> 0"):
        opt.set_watchdog(0.0)


def test_metrics_registry_carries_train_and_ckpt_gauges(mlp_params,
                                                         tmp_path):
    x, y = _toy_data()
    opt = _port_opt(mlp_params, x, y, 1, optim.SGD(0.5), 3)
    opt.set_checkpoint(str(tmp_path), optim.Trigger.several_iteration(2))
    reg = MetricsRegistry()
    opt.set_metrics_registry(reg)
    opt.optimize()
    flat = reg.collect()
    assert flat["train.iteration"] == 3
    assert flat["train.learning_rate"] == pytest.approx(0.5)
    assert flat["train.throughput"] > 0 and np.isfinite(flat["train.loss"])
    assert flat["train.ckpt.commits"] == 1
    opt.checkpoint_manager.close()
