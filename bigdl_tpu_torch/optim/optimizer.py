"""The training loop (``bigdl_tpu/optim/optimizer.py``): ``Optimizer``,
``LocalOptimizer`` and the ``optimizer()`` factory, single device.

One step: cast the input to the policy's compute dtype, run the model in
training mode (BN updates its running statistics; a model whose forward
takes ``rng`` draws its dropout masks from the step's key), cast the
output to fp32, take the criterion's loss, differentiate it with autograd,
clip the gradients (``set_gradclip_const`` / ``set_gradclip_l2norm``, over
all of them) and apply each optim method to its parameters
(``set_optim_methods`` splits them by top-level child). The keys are the
JAX loop's: the loop holds ``key(config.seed)``, takes one split where the
JAX loop initialises its params (the port's model arrives initialised)
and one before each step. The loop keeps the JAX package's
``TrainingState`` accounting — ``end_when`` checked before each step and
again at an epoch's end, epochs counted by records processed — and logs
the loss, the learning rate and the throughput. Each log record also
carries ``loss`` and ``step_seconds`` as named attributes, for readers
that need the numbers rather than the text. The device is the model's;
the batch for the next step is fetched and copied while the current step
runs on the card.

After each step, in the JAX package's order: summaries, validation
(``set_validation``), the checkpoint (``set_checkpoint``), the preemption
poll, the epoch boundary, the watchdog's beat (``set_watchdog``).
Checkpoints hold the JAX package's layout (``params`` and
``module_state`` as the weight bridge exports them, ``optim_state`` as
``{method key: {"step": int32, buffer: params-shaped tree}}``), so either
package resumes from the other's directory; a restore copies into the
model's own tensors and the optim methods' own buffers, in place. A step
that raises is retried from the newest checkpoint, up to
``config.failure_retry_times`` times; with nothing restorable the run
starts again from the weights the model held when ``optimize()`` first
ran (kept on the host only when a checkpoint path is set).

``set_data_pipeline(n)`` fans the elementwise run of a transformed
dataset's chain out over ``n`` workers (threads or spawned processes,
each element reseeded from ``(config.seed, index)``), keeping batching
and shuffling serial, and puts a staging thread (``host_prefetch``,
``host_depth`` ready batches ahead, 2 by default) before the device copy
(``device_prefetch``); the per-stage counters (``pipeline_stats``) are
folded into ``metrics`` and into each step's log record (``pipeline``)
at every log interval. Without it the loop pulls its batches itself, one
ahead, as before: the staging thread reads ahead by as many batches as
its timing allows, so a run stopped by its end trigger and continued by
another ``optimize()`` would find its dataset's shuffle generator
advanced by an amount that varies from run to run (the JAX loop stages
by default and has that property). The data-parallel trainer is
:class:`~bigdl_tpu_torch.optim.distri_optimizer.DistriOptimizer`.
"""

from __future__ import annotations

import inspect
import logging
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from bigdl_tpu_torch.ckpt import CheckpointManager
from bigdl_tpu_torch.core.config import EngineConfig
from bigdl_tpu_torch.core.threefry import Key, key, split
from bigdl_tpu_torch.dataset.dataset import (
    AbstractDataSet,
    TensorDataSet,
    TransformedDataSet,
)
from bigdl_tpu_torch.dataset.parallel_pipeline import (
    PipelineStats,
    parallelize_chain,
)
from bigdl_tpu_torch.dataset.prefetch import device_prefetch, host_prefetch
from bigdl_tpu_torch.interop.jax_params import (
    export_params,
    export_state,
    load_jax_params,
    load_optim_state,
)
from bigdl_tpu_torch.nn.module import Criterion, flatten_tree, unflatten_tree
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.trigger import TrainingState, Trigger
from bigdl_tpu_torch.optim.validation import accumulate_batch, results
from bigdl_tpu_torch.utils.checkpoint import to_host_tree

log = logging.getLogger("bigdl_tpu_torch.optim")


def _clip_constant(grads: List[torch.Tensor], min_v: float,
                   max_v: float) -> None:
    for g in grads:
        g.clamp_(min_v, max_v)


def _clip_l2norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """Scale every gradient by ``min(1, max_norm / (norm + 1e-12))``,
    ``norm`` the fp32 L2 norm over all of them (on the device: no host
    read)."""
    sq = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for g in grads:
        sq = sq + torch.sum(torch.square(g.float()))
    scale = torch.clamp(max_norm / (torch.sqrt(sq) + 1e-12), max=1.0)
    torch._foreach_mul_(grads, scale)


class Optimizer:
    def __init__(self, model: nn.Module, dataset: AbstractDataSet,
                 criterion: Criterion, batch_size: Optional[int] = None,
                 config: Optional[EngineConfig] = None):
        self.model = model
        self.dataset = dataset
        self.criterion = criterion
        self.config = config or EngineConfig()
        self.batch_size = batch_size or self.config.default_batch_size
        self.optim_methods: Dict[str, OptimMethod] = {"__all__": SGD()}
        self.end_when: Trigger = Trigger.max_epoch(10)
        self.val_trigger: Optional[Trigger] = None
        self.val_dataset: Optional[AbstractDataSet] = None
        self.val_methods: Optional[List] = None
        self.val_batch_size: Optional[int] = None
        self.checkpoint_path: Optional[str] = None
        self.checkpoint_trigger: Optional[Trigger] = None
        self.checkpoint_manager: Optional[CheckpointManager] = None
        self._auto_resume = False
        # iteration of the last save or restore: a restored run does not
        # save again the step it loaded
        self._last_ckpt_iteration = -1
        self.train_summary = None
        self.val_summary = None
        self.grad_clip: Optional[Callable] = None
        self.watchdog_timeout: Optional[float] = None
        self._watchdog_on_stall: Optional[Callable] = None
        self.watchdog_error = None
        self._last_lr = 0.0
        self._last_throughput = 0.0
        self.state = TrainingState()
        self.metrics = Metrics()
        self._optim_states = None
        self._groups = None
        self._given_optim_state = None
        self._initial_weights = None
        # the staging thread's depth (0: none; set_data_pipeline turns it
        # on, see the module docstring) and the worker pool (0 workers:
        # the chain runs serially)
        self.host_prefetch_depth = 0
        self.pipeline_n_workers = 0
        self.pipeline_depth = 2
        self.pipeline_ordered = True
        self.pipeline_processes = False
        self.pipeline_chunk = 1
        self.pipeline_max_restarts = 2
        self.pipeline_stats: Optional[PipelineStats] = None
        # the JAX loop splits its root key once to initialise the params
        self._rng, _ = split(key(self.config.seed))
        self._keyed = "rng" in inspect.signature(model.forward).parameters

    # ------------------------------------------------ builder setters ----
    def set_optim_method(self, method: OptimMethod) -> "Optimizer":
        return self.set_optim_methods({"__all__": method})

    def set_optim_methods(self, methods: Dict[str, OptimMethod]
                          ) -> "Optimizer":
        """Optim methods by top-level child name; ``"__default__"`` takes
        the children no key names."""
        self.optim_methods = dict(methods)
        self._optim_states = None
        return self

    def set_end_when(self, trigger: Trigger) -> "Optimizer":
        self.end_when = trigger
        return self

    def set_validation(self, trigger: Trigger, dataset: AbstractDataSet,
                       methods: Sequence,
                       batch_size: Optional[int] = None) -> "Optimizer":
        """Run ``methods`` over ``dataset`` (every sample, the last batch
        partial) whenever ``trigger`` fires; the first method's value
        becomes ``state.score``."""
        self.val_trigger = trigger
        self.val_dataset = dataset
        self.val_methods = list(methods)
        self.val_batch_size = batch_size
        return self

    def set_checkpoint(self, path: str, trigger: Trigger, *,
                       async_save: bool = True,
                       keep_last_n: Optional[int] = None,
                       keep_every_k_steps: Optional[int] = None,
                       handle_preemption: bool = False,
                       auto_resume: bool = False) -> "Optimizer":
        """Checkpoint to ``path`` whenever ``trigger`` fires, through a
        :class:`~bigdl_tpu_torch.ckpt.CheckpointManager`.
        ``handle_preemption`` makes SIGTERM commit a checkpoint at the
        next step boundary and stop; ``auto_resume`` makes ``optimize()``
        first restore the newest committed checkpoint of ``path``."""
        self.checkpoint_path = path
        self.checkpoint_trigger = trigger
        self._auto_resume = auto_resume
        if self.checkpoint_manager is not None:
            self.checkpoint_manager.close()
        self.checkpoint_manager = CheckpointManager(
            path, async_save=async_save, keep_last_n=keep_last_n,
            keep_every_k_steps=keep_every_k_steps)
        if handle_preemption:
            self.checkpoint_manager.install_preemption_hook()
        return self

    def set_data_pipeline(self, n_workers: int = 0, *, depth: int = 2,
                          ordered: bool = True, processes: bool = False,
                          chunk: int = 1, host_depth: Optional[int] = None,
                          stats: Optional[PipelineStats] = None,
                          max_worker_restarts: int = 2) -> "Optimizer":
        """The parallel host input pipeline: with ``n_workers > 0`` and a
        transformed dataset, the elementwise run of the transformer chain
        fans out over a worker pool
        (:func:`~bigdl_tpu_torch.dataset.parallel_pipeline.
        parallelize_chain`) seeded per element from ``config.seed``;
        batching and shuffling stay serial. A staging thread
        ``host_depth`` batches deep (2 unless given) runs the pipeline
        ahead of the loop. The per-stage counters land in
        ``self.pipeline_stats``."""
        self.pipeline_n_workers = int(n_workers)
        self.pipeline_depth = depth
        self.pipeline_ordered = ordered
        self.pipeline_processes = processes
        self.pipeline_chunk = chunk
        self.pipeline_max_restarts = int(max_worker_restarts)
        self.host_prefetch_depth = 2 if host_depth is None else host_depth
        self.pipeline_stats = stats or PipelineStats()
        return self

    def set_watchdog(self, timeout: float,
                     on_stall: Optional[Callable] = None) -> "Optimizer":
        """If no iteration completes for ``timeout`` seconds,
        ``on_stall(err)`` fires from the watchdog's thread with a
        :class:`~bigdl_tpu_torch.faults.StallError`. The default handler
        records the error on ``watchdog_error`` and poisons the dataset
        through the first ``fail()`` hook down its ``.base`` chain, so a
        loop blocked on a dead feed surfaces the stall. The handler never
        touches the device."""
        if timeout <= 0:
            raise ValueError(f"watchdog timeout must be > 0, got {timeout}")
        self.watchdog_timeout = float(timeout)
        self._watchdog_on_stall = on_stall
        return self

    def _watchdog_stalled(self, err) -> None:
        self.watchdog_error = err
        if self._watchdog_on_stall is not None:
            self._watchdog_on_stall(err)
            return
        log.error("training stalled: %s", err)
        ds = self.dataset
        while ds is not None:
            fail = getattr(ds, "fail", None)
            if callable(fail):
                fail(err)
                return
            ds = getattr(ds, "base", None)

    def set_metrics_registry(self, registry,
                             name: str = "train") -> "Optimizer":
        """Publish the step gauges (iteration, epoch, loss, throughput,
        learning rate) into an :class:`~bigdl_tpu_torch.obs.MetricsRegistry`
        under ``name``, and the checkpoint manager's counters under
        ``<name>.ckpt`` (call after ``set_checkpoint``)."""
        registry.register(name, self._obs_snapshot)
        if self.checkpoint_manager is not None:
            registry.register(f"{name}.ckpt", self.checkpoint_manager)
        return self

    def _obs_snapshot(self) -> dict:
        return {"iteration": self.state.iteration,
                "epoch": self.state.epoch,
                "loss": self.state.loss,
                "throughput": self._last_throughput,
                "learning_rate": self._last_lr}

    def set_train_summary(self, summary) -> "Optimizer":
        self.train_summary = summary
        return self

    def set_val_summary(self, summary) -> "Optimizer":
        self.val_summary = summary
        return self

    def set_gradclip_const(self, min_v: float, max_v: float) -> "Optimizer":
        self.grad_clip = lambda g: _clip_constant(g, min_v, max_v)
        return self

    def set_gradclip_l2norm(self, max_norm: float) -> "Optimizer":
        self.grad_clip = lambda g: _clip_l2norm(g, max_norm)
        return self

    def disable_gradclip(self) -> "Optimizer":
        self.grad_clip = None
        return self

    def set_model_and_state(self, params, module_state=None,
                            optim_state=None) -> "Optimizer":
        """Start from given weights: ``params`` and ``module_state`` in
        the weight bridge's layout are copied into the model now;
        ``optim_state`` in the JAX layout (``{method key: {"step", buffer
        trees}}``) into the optim methods' buffers before the next
        step."""
        load_jax_params(self.model, to_host_tree(params),
                        None if module_state is None
                        else to_host_tree(module_state))
        if optim_state is not None:
            self._given_optim_state = to_host_tree(optim_state)
        return self

    @property
    def optim_state(self):
        """The state (``step`` and buffers keyed by parameter name) of the
        one optim method ``set_optim_method`` set; ``None`` before the
        first ``optimize``. Per-child methods: :attr:`optim_states`."""
        states = self._optim_states
        if states is None:
            return None
        if set(states) != {"__all__"}:
            raise ValueError("per-child optim methods: read optim_states["
                             "method key]")
        return states["__all__"]

    @property
    def optim_states(self):
        """The optim methods' states by method key (``"__all__"`` under
        ``set_optim_method``); ``None`` before the first ``optimize``."""
        return self._optim_states

    # ------------------------------------------------------- the step ----
    def _split_params(self, params: Dict[str, torch.Tensor]):
        """Parameters by optim method key, split by top-level child. A key
        that matches no child is an error, unless it is
        ``"__default__"``."""
        if set(self.optim_methods) == {"__all__"}:
            return {"__all__": params}
        default = self.optim_methods.get("__default__")
        groups: Dict[str, Dict[str, torch.Tensor]] = {}
        children = dict.fromkeys(n.split(".")[0] for n in params)
        for name, p in params.items():
            child = name.split(".")[0]
            target = child if child in self.optim_methods else "__default__"
            if target == "__default__" and default is None:
                raise ValueError(f"no optim method for submodule '{child}' "
                                 "and no '__default__' given")
            groups.setdefault(target, {})[name] = p
        unmatched = set(self.optim_methods) - set(groups) - {"__default__"}
        if unmatched:
            raise ValueError(
                f"optim method keys {sorted(unmatched)} match no top-level "
                f"param subtree (available: {sorted(children)})")
        return groups

    def _ensure_initialized(self):
        groups = self._split_params(dict(self.model.named_parameters()))
        self._groups = {k: list(g) for k, g in groups.items()}
        if self._optim_states is None:
            self._optim_states = {
                k: self.optim_methods[k].init_state(self._local_params(g))
                for k, g in groups.items()}
        if self._given_optim_state is not None:
            self._load_optim_states(self._given_optim_state)
            self._given_optim_state = None

    def _local_params(self, params: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """The parts of ``params`` this process updates (all of them;
        a sharding trainer narrows them)."""
        return params

    def _full_optim_states(self):
        """The optim states in the one-process layout."""
        return self._optim_states

    def _should_write_checkpoint(self) -> bool:
        """One process: it writes. A data-parallel trainer narrows this
        to one writer per job."""
        return True

    def _rows(self, x: torch.Tensor) -> int:
        """Records a step on ``x`` consumes (the global batch)."""
        return int(x.shape[0])

    def _load_optim_states(self, tree) -> None:
        if set(tree) != set(self._optim_states):
            raise ValueError(f"optim state keys {sorted(tree)} do not match "
                             f"the optim methods' {sorted(self._optim_states)}")
        for k, state in self._optim_states.items():
            load_optim_state(state, tree[k])

    def _step(self, x, y, epoch: int, step_key: Key) -> torch.Tensor:
        """One training step; returns the loss tensor (not synchronised)."""
        params = dict(self.model.named_parameters())
        self.model.train()
        x = self.config.dtypes.cast_compute(x)
        out = self.model(x, rng=step_key) if self._keyed else self.model(x)
        loss = self.criterion.forward(out.float(), y)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()), allow_unused=True,
            materialize_grads=True)))
        if self.grad_clip is not None:
            self.grad_clip(list(grads.values()))
        for k, names in self._groups.items():
            self.optim_methods[k].update({n: grads[n] for n in names},
                                         {n: params[n] for n in names},
                                         self._optim_states[k], epoch)
        return loss.detach()

    # ------------------------------------------------------- optimize ----
    def optimize(self):
        """Run the loop until ``end_when``; returns the model's parameters
        and buffers (BN running statistics) as dicts keyed by dotted
        name. A failure is retried from the newest checkpoint when a
        checkpoint path is set."""
        if self.checkpoint_path and self._initial_weights is None:
            # copies: a CPU tensor's numpy view would follow the updates
            self._initial_weights = tuple(
                {k: np.array(v) for k, v in flatten_tree(tree).items()}
                for tree in (export_params(self.model),
                             export_state(self.model)))
        if self._auto_resume and self.checkpoint_manager is not None:
            self._auto_resume = False   # once per optimizer, not per retry
            # nothing restorable keeps set_model_and_state's weights
            self._restore_latest(reset_on_missing=False)
        retries = 0
        while True:
            try:
                return self._optimize_impl()
            except KeyboardInterrupt:
                raise
            except Exception:
                retries += 1
                if (retries > self.config.failure_retry_times
                        or not self.checkpoint_path):
                    raise
                log.exception("training failed; retrying from the latest "
                              "checkpoint (%d/%d)", retries,
                              self.config.failure_retry_times)
                if self.config.failure_retry_interval_sec > 0:
                    time.sleep(self.config.failure_retry_interval_sec)
                self._restore_latest()

    def _checkpoint_trees(self) -> dict:
        """The live tensors in the checkpoint layout."""
        optim = {}
        for k, state in self._full_optim_states().items():
            optim[k] = {name: unflatten_tree(value)
                        if isinstance(value, dict) else value
                        for name, value in state.items()}
            optim[k]["step"] = torch.tensor(state["step"], dtype=torch.int32)
        return {"params": unflatten_tree(dict(self.model.named_parameters())),
                "module_state": unflatten_tree(
                    dict(self.model.named_buffers())),
                "optim_state": optim}

    def _restore_latest(self, reset_on_missing: bool = True):
        if self.checkpoint_manager is None:
            self.checkpoint_manager = CheckpointManager(self.checkpoint_path)
        self._ensure_initialized()
        restored = self.checkpoint_manager.restore_latest(
            self._checkpoint_trees())
        if restored is None:
            # nothing restorable: the retry path starts again from the
            # first weights; auto-resume keeps the current ones
            if reset_on_missing:
                if self._initial_weights is not None:
                    load_jax_params(self.model, *(
                        unflatten_tree(w) for w in self._initial_weights))
                self._optim_states = None
            self._last_ckpt_iteration = -1
            return
        payload, entry = restored
        load_jax_params(self.model, payload["params"],
                        payload["module_state"])
        self._load_optim_states(payload["optim_state"])
        meta = entry.meta
        self.state = TrainingState(
            epoch=meta.get("epoch", 1),
            iteration=meta.get("iteration", entry.step),
            records_processed_this_epoch=meta.get("records", 0))
        self._last_ckpt_iteration = self.state.iteration
        log.info("restored checkpoint '%s' (iteration %d, epoch %d%s)",
                 entry.tag, self.state.iteration, self.state.epoch,
                 ", from a preemption save" if entry.preempted else "")

    def _train_batches(self):
        """A ``TensorDataSet`` is sliced into batches; any other dataset
        streams ``MiniBatch``es as built (``>> SampleToMiniBatch``), its
        elementwise stages on the worker pool under
        ``set_data_pipeline(n > 0)``."""
        if isinstance(self.dataset, TensorDataSet):
            return self.dataset.batches(self.batch_size, train=True)
        if (self.pipeline_n_workers > 0
                and isinstance(self.dataset, TransformedDataSet)):
            chain = parallelize_chain(
                self.dataset.transformer, self.pipeline_n_workers,
                depth=self.pipeline_depth, ordered=self.pipeline_ordered,
                processes=self.pipeline_processes, chunk=self.pipeline_chunk,
                base_seed=self.config.seed, stats=self.pipeline_stats,
                max_worker_restarts=self.pipeline_max_restarts)
            return chain.apply(self.dataset.base.data(train=True))
        return self.dataset.data(train=True)

    def _batch_stream(self, device):
        """The training batches on ``device``: the staging thread, then
        the device copy."""
        batches = self._train_batches()
        if self.host_prefetch_depth > 0:
            batches = host_prefetch(batches, self.host_prefetch_depth,
                                    stats=self.pipeline_stats)
        return device_prefetch(batches, device, stats=self.pipeline_stats)

    def _optimize_impl(self):
        self._ensure_initialized()
        device = next(self.model.parameters()).device
        watchdog = None
        if self.watchdog_timeout:
            from bigdl_tpu_torch.faults import Watchdog

            watchdog = Watchdog("optimizer", self.watchdog_timeout,
                                self._watchdog_stalled)
            watchdog.arm("training step (batch wait + compute)")
        try:
            stream = self._batch_stream(device)
            try:
                self._train_loop(self.state, stream, self.dataset.size(),
                                 watchdog)
            finally:
                # retire the staging thread and the worker pool now, not
                # when the collector finds the generator
                stream.close()
        finally:
            if watchdog is not None:
                watchdog.close()
        if self.checkpoint_manager is not None:
            # every triggered checkpoint is committed when optimize()
            # returns, and a write error surfaces here
            self.checkpoint_manager.wait()
        return (dict(self.model.named_parameters()),
                dict(self.model.named_buffers()))

    def _train_loop(self, state, stream, train_size, watchdog):
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
            bsz = self._rows(x)
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
            method = next(iter(self.optim_methods.values()))
            lr = float(method.schedule(method.learning_rate,
                                       state.iteration - 1, state.epoch))
            self._last_lr = lr
            self._last_throughput = bsz / max(dt, 1e-9)
            if state.iteration % self.config.log_every_n_steps == 0:
                pipeline = self._fold_pipeline_stats()
                log.info("Epoch %d iteration %d: loss %.6f, lr %.5g. "
                         "Throughput is %.1f records/second.", state.epoch,
                         state.iteration, loss, lr, bsz / max(dt, 1e-9),
                         extra={"loss": loss, "step_seconds": dt,
                                "pipeline": pipeline})
            if self.train_summary is not None:
                self._write_train_summary(state, loss, bsz / max(dt, 1e-9),
                                          lr)
            if self.val_trigger is not None and self.val_trigger(state):
                self._run_validation()
            if (self.checkpoint_trigger is not None
                    and self.checkpoint_trigger(state)):
                self._save_checkpoint()
            mgr = self.checkpoint_manager
            if mgr is not None and mgr.preemption_requested:
                # commit now, synchronously, and stop: the process is
                # about to be killed and an async save would be lost
                log.warning("preemption requested: committing checkpoint "
                            "at iteration %d and stopping", state.iteration)
                if state.iteration == self._last_ckpt_iteration:
                    # the trigger's save of this step may be in flight:
                    # drain it, then mark it by a manifest-only rewrite
                    mgr.wait()
                    mgr.mark_preempted(f"model.iter{state.iteration}")
                else:
                    self._save_checkpoint(preempted=True, blocking=True)
                break
            if state.epoch_finished:
                state.epoch += 1
                state.records_processed_this_epoch = 0
                # re-check the end condition at the epoch boundary
                if self.end_when(state):
                    break
                state.epoch_finished = False
            if watchdog is not None:
                # an iteration completed end to end, validation and
                # checkpoint included: the deadline resets
                watchdog.beat()

    def _fold_pipeline_stats(self):
        """The input pipeline's per-stage gauges into ``metrics`` (the
        JAX loop's names); returns the stats' snapshot, or None."""
        if self.pipeline_stats is None:
            return None
        snap = self.pipeline_stats.snapshot()
        for name, s in snap.items():
            self.metrics.set(f"pipeline {name} items/s", s["items_per_sec"])
            self.metrics.set(f"pipeline {name} stall s", s["stall_s"])
            self.metrics.set(f"pipeline {name} starve s", s["starve_s"])
            if s["queue_cap"]:
                self.metrics.set(f"pipeline {name} queue occupancy",
                                 s["queue_mean"] / s["queue_cap"])
        return snap

    def _write_train_summary(self, state, loss, throughput, lr):
        summary = self.train_summary
        summary.add_scalar("Loss", loss, state.iteration)
        summary.add_scalar("Throughput", throughput, state.iteration)
        summary.add_scalar("LearningRate", lr, state.iteration)
        trigger = summary.triggers.get("Parameters")
        if trigger is not None and trigger(state):
            for name, p in self.model.named_parameters():
                summary.add_histogram(name.replace(".", "/"),
                                      p.detach().float().cpu().numpy(),
                                      state.iteration)

    # ------------------------------------------------ validation ---------
    def _run_validation(self):
        """Every sample of the validation set through the model in eval
        mode (BN on its running statistics, no dropout), the input cast to
        the compute dtype and the output to fp32; the model goes back to
        its mode after. Returns the ``ValidationResult``s."""
        t0 = time.time()
        methods = self.val_methods
        sums = [[0.0, 0] for _ in methods]
        device = next(self.model.parameters()).device
        batches = self.val_dataset.batches(
            self.val_batch_size or self.batch_size, train=False,
            partial_batch=True)
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                for x, y in device_prefetch(batches, device):
                    out = self.model(self.config.dtypes.cast_compute(x))
                    if out.is_floating_point():
                        out = out.float()
                    accumulate_batch(sums, methods, out, y)
        finally:
            self.model.train(was_training)
        res = results(sums, methods)
        dt = time.time() - t0
        for r in res:
            v, n = r.result()
            log.info("%s is %.6f (count %d)", r.name, v, n,
                     extra={"validation": r, "validation_seconds": dt})
            if self.val_summary is not None:
                self.val_summary.add_scalar(r.name, v, self.state.iteration)
        self.state.score = res[0].result()[0]
        return res

    # ------------------------------------------------ checkpoint ---------
    def _save_checkpoint(self, preempted: bool = False,
                         blocking: bool = False):
        if self.state.iteration == self._last_ckpt_iteration and not preempted:
            return  # this step is already on disk (e.g. just restored)
        trees = self._checkpoint_trees()
        if self._should_write_checkpoint():
            self.checkpoint_manager.save(
                f"model.iter{self.state.iteration}", trees["params"],
                trees["module_state"], trees["optim_state"],
                meta={"epoch": self.state.epoch,
                      "iteration": self.state.iteration,
                      "records": self.state.records_processed_this_epoch,
                      "loss": self.state.loss},
                step=self.state.iteration, blocking=blocking,
                preempted=preempted)
        self._last_ckpt_iteration = self.state.iteration


class LocalOptimizer(Optimizer):
    """Single-device trainer."""


def optimizer(model, dataset, criterion, batch_size=None,
              config=None) -> Optimizer:
    """A :class:`~bigdl_tpu_torch.optim.distri_optimizer.DistriOptimizer`
    in a process group of more than one rank, else a
    :class:`LocalOptimizer` (the JAX factory chooses by device count)."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer

        return DistriOptimizer(model, dataset, criterion, batch_size, config)
    return LocalOptimizer(model, dataset, criterion, batch_size, config)
