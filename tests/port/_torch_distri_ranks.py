"""The rank processes of ``test_torch_distri.py``: a 2-rank gloo group on
the CPU that trains the port's cifar-8 ResNet with ``DistriOptimizer``
(ZeRO-1 with global batch norm, with a checkpoint every step; the DDP
overlap flavour) and ``make_zero1_overlap_step``, and hands rank 0's
results back through a queue. This module imports no JAX: each spawned
rank imports only it and the port."""

import logging

import numpy as np
import torch

GLOBAL_BATCH, STEPS = 8, 2
SGD_KW = dict(learning_rate=0.1, momentum=0.9)


def data():
    rs = np.random.RandomState(0)
    return (rs.standard_normal((2 * GLOBAL_BATCH, 3, 32, 32))
            .astype(np.float32), rs.randint(0, 10, (2 * GLOBAL_BATCH,)))


def global_batches():
    """The first ``STEPS`` global batches of the seeded data as both
    packages' ``TensorDataSet`` streams them for ``RandomGenerator(0)``
    (bitwise equal, test_torch_optimizer)."""
    from bigdl_tpu_torch.core import RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet

    stream = DataSet.tensors(*data(), RandomGenerator(0)).batches(
        GLOBAL_BATCH, train=True)
    return [next(stream) for _ in range(STEPS)]


def train(cls, params, state, steps=STEPS, ckpt_dir=None, **kw):
    """``cls`` (an optimizer class) trains a cifar-8 ResNet holding
    ``params``/``state`` for ``steps`` global batches of the seeded data;
    -> (losses, params, state, optimizer)."""
    from bigdl_tpu_torch.core import EngineConfig, RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.interop import (
        export_params,
        export_state,
        load_jax_params,
    )
    from bigdl_tpu_torch.models.resnet import build_cifar
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import SGD, Trigger

    x, y = data()
    model = load_jax_params(build_cifar(8, device="cpu"), params, state)
    opt = cls(model, DataSet.tensors(x, y, RandomGenerator(0)),
              CrossEntropyCriterion(), GLOBAL_BATCH, EngineConfig(), **kw)
    opt.set_optim_method(SGD(**SGD_KW))
    opt.set_end_when(Trigger.max_iteration(steps))
    if ckpt_dir is not None:
        opt.set_checkpoint(ckpt_dir, Trigger.several_iteration(1),
                           async_save=False, auto_resume=True)
    losses = []
    handler = logging.Handler()
    handler.emit = lambda r: hasattr(r, "loss") and losses.append(r.loss)
    logger = logging.getLogger("bigdl_tpu_torch.optim")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        opt.optimize()
    finally:
        logger.removeHandler(handler)
    return losses, export_params(model), export_state(model), opt


def zero1_overlap_steps(params, state, mesh, rank, world):
    """``make_zero1_overlap_step``, 2 buckets, over this rank's rows of
    the global batches."""
    from bigdl_tpu_torch.interop import (
        export_params,
        export_state,
        load_jax_params,
    )
    from bigdl_tpu_torch.models.resnet import build_cifar
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.parallel import (
        make_zero1_overlap_step,
        zero1_init_state,
    )

    model = load_jax_params(build_cifar(8, device="cpu"), params, state)
    method = SGD(**SGD_KW)
    step = make_zero1_overlap_step(model, CrossEntropyCriterion(), method,
                                   mesh, num_buckets=2)
    ostate = zero1_init_state(method, model, mesh, num_buckets=2)
    per = GLOBAL_BATCH // world
    losses = []
    for b in global_batches():
        rows = slice(rank * per, (rank + 1) * per)
        losses.append(float(step(ostate, torch.from_numpy(b.input[rows]),
                                 torch.from_numpy(b.target[rows]), 1)))
    step.close()
    return losses, export_params(model), export_state(model)


def rank_main(rank, world, port, params, state, ckpt_dir, queue):
    import torch.distributed as dist

    from bigdl_tpu_torch.core import Engine
    from bigdl_tpu_torch.optim import DistriOptimizer

    torch.set_num_threads(1)
    Engine.init_multihost(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        out = {}
        losses, p, s, opt = train(DistriOptimizer, params, state,
                                  ckpt_dir=ckpt_dir)
        out["zero1"] = (losses, p, s)
        out["zero1_commits"] = opt.checkpoint_manager.commits
        out["zero1_sharded"] = sorted(opt._shard_dims.items())
        losses, p, s, _ = train(DistriOptimizer, params, state,
                                overlap_buckets=3)
        out["ddp"] = (losses, p, s)
        out["zero1_overlap"] = zero1_overlap_steps(
            params, state, Engine.get().mesh(), rank, world)
        queue.put((rank, out))
    finally:
        dist.destroy_process_group()
