"""Data-parallel training: ``DistriOptimizer``, the overlap step builders,
the engine and the mesh, against the port's one-process training and the
JAX package's dp=2 steps.

One spawned 2-rank gloo group (``_torch_distri_ranks``, started when the
module starts, so its ranks train while the JAX references compile here)
trains a cifar-8 ResNet on two global batches of 8 rows:

- ``DistriOptimizer(zero1=True)`` (global batch-norm statistics, ZeRO-1
  shards, a checkpoint each step) against a one-process
  ``LocalOptimizer`` on the same global batches, and against the JAX
  ``DistriOptimizer`` step on a dp=2 mesh of the suite's 8 virtual CPU
  devices;
- ``DistriOptimizer(overlap_buckets=3)`` and ``make_zero1_overlap_step``
  against a one-process emulation (per-rank batch-norm statistics,
  averaged gradients and running statistics), and the former against the
  JAX ``make_ddp_overlap_step`` on the dp=2 mesh;
- a one-process ``Optimizer`` resumes the ZeRO-1 checkpoint (written by
  rank 0 alone) as it resumes its own.

Tolerances: losses rtol 1e-5; parameters, momentum and running statistics
``assert_trees_close`` rtol 1e-4, atol 1e-5 of each leaf's largest entry
(a two-rank sum adds in another order than a one-rank one).
"""

import multiprocessing
import queue as queue_mod
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_trees import FAST_COMPILE, assert_trees_close, seeded_trees
from _torch_distri_ranks import (
    GLOBAL_BATCH,
    SGD_KW,
    STEPS,
    data,
    global_batches,
    train,
)
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from bigdl_tpu.core.config import EngineConfig as JaxEngineConfig
from bigdl_tpu.dataset.dataset import DataSet as JaxDataSet
from bigdl_tpu.models import resnet as jresnet
from bigdl_tpu.nn import ClassNLLCriterion as JaxNLL
from bigdl_tpu.nn import CrossEntropyCriterion as JaxCE
from bigdl_tpu.nn import Linear as JaxLinear
from bigdl_tpu.nn import TimeDistributedCriterion as JaxTD
from bigdl_tpu.optim.distri_optimizer import DistriOptimizer as JaxDistri
from bigdl_tpu.optim.optim_method import SGD as JaxSGD
from bigdl_tpu.parallel import mesh as jmesh
from bigdl_tpu.parallel.overlap import make_buckets as jax_make_buckets
from bigdl_tpu.parallel.overlap import make_ddp_overlap_step
from bigdl_tpu_torch.core import Engine, EngineConfig, RandomGenerator
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.models.resnet import build_cifar
from bigdl_tpu_torch.nn import (
    ClassNLLCriterion,
    CrossEntropyCriterion,
    Linear,
    TimeDistributedCriterion,
)
from bigdl_tpu_torch.optim import SGD, DistriOptimizer, LocalOptimizer
from bigdl_tpu_torch.optim import Trigger
from bigdl_tpu_torch.parallel import (
    Mesh,
    MeshSpec,
    factor_devices,
    make_buckets,
    make_mesh,
)

TOL = dict(rtol=1e-4, atol=1e-5)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def trees():
    return seeded_trees(jresnet.build_cifar(8))


@pytest.fixture(scope="module")
def ranks(trees, tmp_path_factory, real_tracker_lock):
    """The 2-rank group, started now; ``ranks()`` waits for its results:
    ``{rank: results}`` and the checkpoint directory."""
    from _torch_distri_ranks import rank_main

    ckpt = str(tmp_path_factory.mktemp("zero1_ckpt"))
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=rank_main,
                         args=(r, 2, port, *trees, ckpt, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    got = {}

    def results():
        deadline = time.monotonic() + 120
        while len(got) < 2:
            try:
                rank, out = queue.get(timeout=1)
            except queue_mod.Empty:
                codes = [p.exitcode for p in procs]
                if all(c is not None for c in codes) \
                        or time.monotonic() > deadline:
                    raise RuntimeError(f"ranks gave no results: exit "
                                       f"codes {codes}") from None
                continue
            got[rank] = out
        return got, ckpt

    yield results
    try:
        results()     # a rank exits only once its results are read
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.terminate()
                p.join(5)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]


def _jax_mesh():
    return JaxMesh(np.asarray(jax.devices()[:2]), ("dp",))


def _jax_run(step, args_of, params, mstate, ostate):
    mesh = _jax_mesh()
    shard = NamedSharding(mesh, P("dp"))
    params, mstate, ostate = jax.tree_util.tree_map(
        lambda a: a if isinstance(getattr(a, "sharding", None),
                                  NamedSharding)
        else jax.device_put(a, NamedSharding(mesh, P())),
        (params, mstate, ostate))
    compiled, losses = None, []
    for b in global_batches():
        x = jax.device_put(b.input, shard)
        y = jax.device_put(b.target.astype(np.int32), shard)
        args = args_of(params, mstate, ostate, x, y)
        if compiled is None:
            compiled = jax.jit(step).lower(*args).compile(FAST_COMPILE)
            placed = (params, mstate, ostate)
        new = compiled(*args)[:4]
        # the next call takes the first call's input shardings
        params, mstate, ostate = jax.tree_util.tree_map(
            lambda a, t: jax.device_put(a, t.sharding), new[:3], placed)
        loss = new[3]
        losses.append(float(loss))
    return losses, jax.device_get(params), jax.device_get(mstate), \
        jax.device_get(ostate)


def test_zero1_two_ranks_equal_one_process_and_jax(ranks, trees):
    """Global batch norm: the 2-rank step is the 1-process step on the
    same global batch, and the JAX dp=2 ``DistriOptimizer`` step."""
    params, state = trees
    jm = jresnet.build_cifar(8)
    jopt = JaxDistri(jm, JaxDataSet.tensors(*data()), JaxCE(),
                     GLOBAL_BATCH, JaxEngineConfig(), mesh=_jax_mesh())
    jopt.set_optim_method(JaxSGD(**SGD_KW))
    jopt.set_model_and_state(params, state)
    jopt._ensure_initialized()
    step, _ = jopt._build_step()
    key, epoch = jax.random.key(0), jnp.int32(1)
    jl, jp, js, jo = _jax_run(
        step.__wrapped__ if hasattr(step, "__wrapped__") else step,
        lambda p, m, o, x, y: (p, m, o, x, y, key, epoch),
        jopt._params, jopt._module_state, jopt._optim_state)

    local_l, local_p, local_s, local_opt = train(LocalOptimizer, params,
                                                 state)
    got, _ = ranks()
    losses, p, s = got[0]["zero1"]
    assert got[1]["zero1"][0] == losses       # the mean over the ranks
    dims = dict(got[0]["zero1_sharded"])
    assert dims["fc.weight"] == 1 and dims["0.weight"] == 0
    for want_l, want_p, want_s, what in (
            (local_l, local_p, local_s, "one process"),
            (jl, jp, js, "jax dp=2")):
        np.testing.assert_allclose(losses, want_l, rtol=1e-5, err_msg=what)
        assert_trees_close(p, want_p, what=f"params vs {what}", **TOL)
        assert_trees_close(s, want_s, what=f"state vs {what}", **TOL)


def _emulated_overlap(params, state, world=2):
    """The overlap flavours' arithmetic in one process: each rank's rows
    forward alone (its own batch-norm statistics), gradients and running
    statistics averaged, one SGD update."""
    from bigdl_tpu_torch.interop import export_params, export_state

    model = load_jax_params(build_cifar(8, device="cpu"), params, state)
    crit, method = CrossEntropyCriterion(), SGD(**SGD_KW)
    named = dict(model.named_parameters())
    ostate = method.init_state(named)
    buffers = dict(model.named_buffers())
    per = GLOBAL_BATCH // world
    losses = []
    for b in global_batches():
        start = {k: v.clone() for k, v in buffers.items()}
        grads, stats, loss = None, [], 0.0
        for r in range(world):
            with torch.no_grad():
                for k, v in buffers.items():
                    v.copy_(start[k])
            x = torch.from_numpy(b.input[r * per:(r + 1) * per])
            y = torch.from_numpy(b.target[r * per:(r + 1) * per])
            out = model.train()(x)
            lr = crit.forward(out, y)
            g = torch.autograd.grad(lr, list(named.values()))
            grads = g if grads is None else [a + c for a, c in zip(grads, g)]
            stats.append({k: v.clone() for k, v in buffers.items()})
            loss += float(lr.detach()) / world
        with torch.no_grad():
            for k, v in buffers.items():
                v.copy_(sum(st[k] for st in stats) / world)
        method.update(dict(zip(named, [g / world for g in grads])), named,
                      ostate, 1)
        losses.append(loss)
    return losses, export_params(model), export_state(model)


def test_overlap_flavours_two_ranks_equal_emulation_and_jax(ranks, trees):
    params, state = trees
    jm = jresnet.build_cifar(8)
    method = JaxSGD(**SGD_KW)
    step = make_ddp_overlap_step(jm, JaxCE(), method, _jax_mesh(),
                                 num_buckets=3)
    it = jnp.int32(1)
    jl, jp, js, _ = _jax_run(step, lambda p, m, o, x, y: (p, m, o, x, y, it),
                             params, state, method.init_state(params))
    el, ep, es = _emulated_overlap(params, state)
    got, _ = ranks()
    for flavour in ("ddp", "zero1_overlap"):
        losses, p, s = got[0][flavour]
        refs = [(el, ep, es, "emulation")]
        if flavour == "ddp":
            refs.append((jl, jp, js, "jax make_ddp_overlap_step"))
        for want_l, want_p, want_s, what in refs:
            what = f"{flavour} vs {what}"
            np.testing.assert_allclose(losses, want_l, rtol=1e-5,
                                       err_msg=what)
            assert_trees_close(p, want_p, what=f"params {what}", **TOL)
            assert_trees_close(s, want_s, what=f"state {what}", **TOL)


def test_zero1_checkpoint_resumes_in_one_process(ranks, trees, tmp_path):
    """Only rank 0 committed; a 1-process optimizer resumes the blob (the
    one-process layout: whole momentum buffers) exactly as it resumes its
    own checkpoint of the same two steps."""
    params, state = trees
    got, ckpt = ranks()
    assert got[0]["zero1_commits"] == STEPS and got[1]["zero1_commits"] == 0
    own = str(tmp_path / "one_process")
    train(LocalOptimizer, params, state, ckpt_dir=own)
    runs = []
    for directory in (ckpt, own):
        losses, p, s, opt = train(LocalOptimizer, params, state,
                                  steps=STEPS + 1, ckpt_dir=directory)
        assert opt.state.iteration == STEPS + 1 and len(losses) == 1
        runs.append((losses, p, s, opt.optim_state["velocity"]))
    (la, pa, sa, va), (lb, pb, sb, vb) = runs
    np.testing.assert_allclose(la, lb, rtol=1e-5)
    assert_trees_close(pa, pb, what="resumed params", **TOL)
    assert_trees_close(sa, sb, what="resumed state", **TOL)
    for k in vb:
        assert va[k].shape == vb[k].shape
        np.testing.assert_allclose(va[k].numpy(), vb[k].numpy(), rtol=1e-4,
                                   atol=1e-5 * float(vb[k].abs().max()))


@pytest.mark.parametrize("num_buckets", [1, 2, 3, 4, 7, 200])
def test_make_buckets_cut_points_are_jax_s(num_buckets):
    shapes = [tuple(p.shape) for p in build_cifar(8, device="cpu")
              .parameters()] + [(1000, 2048), (), (3,)]
    leaves = [np.zeros(s, np.float32) for s in shapes]
    want = jax_make_buckets(leaves, num_buckets)
    assert make_buckets(leaves, num_buckets) == want
    assert make_buckets([torch.zeros(s) for s in shapes], num_buckets) \
        == want


def _one_rank(**kw):
    x, y = data()
    model = Linear(3 * 32 * 32, 10, device="cpu")
    return DistriOptimizer(model, DataSet.tensors(x.reshape(16, -1), y),
                           kw.pop("criterion", CrossEntropyCriterion()),
                           kw.pop("batch", 8), EngineConfig(), **kw)


def _jax_one(mesh=None, **kw):
    x, y = data()
    crit = kw.pop("criterion", JaxCE())
    return JaxDistri(JaxLinear(3 * 32 * 32, 10),
                     JaxDataSet.tensors(x.reshape(16, -1), y), crit,
                     kw.pop("batch", 8), JaxEngineConfig(),
                     mesh=mesh or JaxMesh(np.asarray(jax.devices()[:1]),
                                          ("dp",)), **kw)


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", [
    "wire_without_buckets", "batch_not_divisible", "two_methods",
    "sum_criterion", "weighted_criterion", "wrapped_weighted_criterion"])
def test_refusals_are_the_jax_words(case):
    dp2 = Mesh(np.arange(2), ("dp",), {"dp": None})
    jdp2 = JaxMesh(np.asarray(jax.devices()[:2]), ("dp",))
    w = np.ones(10, np.float32)
    criteria = {
        "sum_criterion": (CrossEntropyCriterion(size_average=False),
                          JaxCE(size_average=False)),
        "weighted_criterion": (CrossEntropyCriterion(torch.ones(10)),
                               JaxCE(jnp.asarray(w))),
        "wrapped_weighted_criterion": (
            TimeDistributedCriterion(ClassNLLCriterion(torch.ones(10))),
            JaxTD(JaxNLL(jnp.asarray(w)))),
    }
    if case == "wire_without_buckets":
        port = lambda: _one_rank(overlap_wire_dtype=torch.bfloat16)
        ref = lambda: _jax_one(overlap_wire_dtype=jnp.bfloat16)
    elif case == "batch_not_divisible":
        port = lambda: _one_rank(batch=7, mesh=dp2)
        ref = lambda: _jax_one(batch=7, mesh=jdp2)
    else:
        methods = ({"__default__": SGD(), "0": SGD()},
                   {"__default__": JaxSGD(), "0": JaxSGD()})
        tc, jc = criteria.get(case, (CrossEntropyCriterion(), JaxCE()))

        def port():
            opt = _one_rank(criterion=tc, overlap_buckets=2)
            if case == "two_methods":
                opt.set_optim_methods(methods[0])
            opt.optimize()

        def ref():
            opt = _jax_one(criterion=jc, overlap_buckets=2)
            if case == "two_methods":
                opt.set_optim_methods(methods[1])
            opt._build_step()
    assert _message(port) == _message(ref)


def test_engine_and_mesh_without_a_process_group():
    engine = Engine.init_multihost(device="cpu")
    try:
        assert Engine.get() is engine
        assert (engine.node_number(), engine.device_count()) == (1, 1)
        mesh = engine.mesh()
        assert mesh.shape == {"dp": 1} and mesh.group("dp") is None
        with pytest.raises(ValueError, match="needs 2 devices"):
            engine.mesh((("dp", 2),))
        with pytest.raises(RuntimeError, match="needs a process group"):
            make_mesh(MeshSpec(dp=1, tp=2), devices=[0, 1])
        with pytest.raises(ValueError, match="together"):
            Engine.init_multihost("127.0.0.1:1", None, 0, device="cpu")
    finally:
        Engine.reset()
    for n, want in ((8, ("dp", "tp", "sp")), (12, ("dp", "tp")), (7, ("dp",))):
        assert factor_devices(n, want) == jmesh.factor_devices(n, want)
