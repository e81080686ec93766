"""The training loop (``bigdl_tpu/optim/optimizer.py``): ``Optimizer``,
``LocalOptimizer`` and the ``optimizer()`` factory, single device.

One step: cast the input to the policy's compute dtype, run the model in
training mode (BN updates its running statistics; a model whose forward
takes ``rng`` draws its dropout masks from the step's key), cast the
output to fp32, take the criterion's loss, differentiate it with autograd
and apply the optim method. The keys are the JAX loop's: the loop holds
``key(config.seed)``, takes one split where the JAX loop initialises its
params (the port's model arrives initialised) and one before each step.
The loop keeps the JAX package's ``TrainingState`` accounting —
``end_when`` checked before each step and again at an epoch's end, epochs
counted by records processed — and logs the loss, the learning rate and
the throughput. Each log record also carries ``loss`` and
``step_seconds`` as named attributes, for readers that need the numbers
rather than the text. The device is the model's; the batch for the
next step is fetched and copied while the current step runs on the card.

Not in this slice (their setters raise ``NotImplementedError``):
validation, checkpoints, the watchdog, summaries, gradient clipping and
the parallel input pipeline (ROADMAP A.3, left out), and the distributed
trainer (ROADMAP A.6).
"""

from __future__ import annotations

import inspect
import logging
import time
from typing import Optional

import torch
from torch import nn

from bigdl_tpu_torch.core.config import EngineConfig
from bigdl_tpu_torch.core.threefry import Key, key, split
from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.dataset.prefetch import device_prefetch
from bigdl_tpu_torch.nn.module import Criterion
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.trigger import TrainingState, Trigger

log = logging.getLogger("bigdl_tpu_torch.optim")


def _queued(name: str, item: str):
    def setter(self, *args, **kwargs):
        raise NotImplementedError(
            f"Optimizer.{name}: {item} is not ported yet (ROADMAP A.3, "
            f"left out of the training slice)")
    setter.__name__ = name
    return setter


class Optimizer:
    def __init__(self, model: nn.Module, dataset: AbstractDataSet,
                 criterion: Criterion, batch_size: Optional[int] = None,
                 config: Optional[EngineConfig] = None):
        self.model = model
        self.dataset = dataset
        self.criterion = criterion
        self.config = config or EngineConfig()
        self.batch_size = batch_size or self.config.default_batch_size
        self.optim_method: OptimMethod = SGD()
        self.end_when: Trigger = Trigger.max_epoch(10)
        self.state = TrainingState()
        self.metrics = Metrics()
        self._optim_state = None
        # the JAX loop splits its root key once to initialise the params
        self._rng, _ = split(key(self.config.seed))
        self._keyed = "rng" in inspect.signature(model.forward).parameters

    # ------------------------------------------------ builder setters ----
    def set_optim_method(self, method: OptimMethod) -> "Optimizer":
        self.optim_method = method
        self._optim_state = None
        return self

    def set_end_when(self, trigger: Trigger) -> "Optimizer":
        self.end_when = trigger
        return self

    set_validation = _queued("set_validation", "validation (Top-1)")
    set_checkpoint = _queued("set_checkpoint", "checkpointing")
    set_watchdog = _queued("set_watchdog", "the step watchdog")
    set_train_summary = _queued("set_train_summary", "training summaries")
    set_val_summary = _queued("set_val_summary", "validation summaries")
    set_gradclip_const = _queued("set_gradclip_const", "gradient clipping")
    set_gradclip_l2norm = _queued("set_gradclip_l2norm", "gradient clipping")
    set_data_pipeline = _queued("set_data_pipeline",
                                "the parallel input pipeline")

    @property
    def optim_state(self):
        """The optim method's state: ``step`` and its buffers keyed by
        parameter name (``None`` before the first ``optimize``)."""
        return self._optim_state

    # ------------------------------------------------------- the step ----
    def _ensure_initialized(self):
        if self._optim_state is None:
            self._optim_state = self.optim_method.init_state(
                dict(self.model.named_parameters()))

    def _step(self, x, y, epoch: int, step_key: Key) -> torch.Tensor:
        """One training step; returns the loss tensor (not synchronised)."""
        params = dict(self.model.named_parameters())
        self.model.train()
        x = self.config.dtypes.cast_compute(x)
        out = self.model(x, rng=step_key) if self._keyed else self.model(x)
        loss = self.criterion.forward(out.float(), y)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True, materialize_grads=True)
        self.optim_method.update(dict(zip(params, grads)), params,
                                 self._optim_state, epoch)
        return loss.detach()

    # ------------------------------------------------------- optimize ----
    def optimize(self):
        """Run the loop until ``end_when``; returns the model's parameters
        and buffers (BN running statistics) as dicts keyed by dotted
        name."""
        self._ensure_initialized()
        device = next(self.model.parameters()).device
        batches = self.dataset.batches(self.batch_size, train=True)
        self._train_loop(self.state, device_prefetch(batches, device),
                         self.dataset.size())
        return (dict(self.model.named_parameters()),
                dict(self.model.named_buffers()))

    def _train_loop(self, state, stream, train_size):
        batch = next(stream, None)
        while batch is not None:
            if self.end_when(state):
                break
            t0 = time.time()
            x, y = batch
            self._rng, step_key = split(self._rng)
            loss = self._step(x, y, state.epoch, step_key)
            # fetch and copy the next batch while this step runs
            batch = next(stream, None)
            loss = float(loss)
            bsz = int(x.shape[0])
            dt = time.time() - t0
            state.iteration += 1
            state.records_processed_this_epoch += bsz
            state.loss = loss
            state.epoch_finished = \
                state.records_processed_this_epoch >= train_size
            self.metrics.set("computing time for each iteration", dt)
            self.metrics.add("throughput", bsz / max(dt, 1e-9))
            # the lr this iteration used: the schedule at the step count
            # before the update
            method = self.optim_method
            lr = float(method.schedule(method.learning_rate,
                                       state.iteration - 1, state.epoch))
            if state.iteration % self.config.log_every_n_steps == 0:
                log.info("Epoch %d iteration %d: loss %.6f, lr %.5g. "
                         "Throughput is %.1f records/second.", state.epoch,
                         state.iteration, loss, lr, bsz / max(dt, 1e-9),
                         extra={"loss": loss, "step_seconds": dt})
            if state.epoch_finished:
                state.epoch += 1
                state.records_processed_this_epoch = 0
                # re-check the end condition at the epoch boundary
                if self.end_when(state):
                    break
                state.epoch_finished = False


class LocalOptimizer(Optimizer):
    """Single-device trainer."""


def optimizer(model, dataset, criterion, batch_size=None,
              config=None) -> Optimizer:
    """A :class:`LocalOptimizer`; the data-parallel trainer is ROADMAP
    A.6."""
    return LocalOptimizer(model, dataset, criterion, batch_size, config)
