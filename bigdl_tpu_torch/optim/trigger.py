"""Triggers (``bigdl_tpu/optim/trigger.py``): host-side predicates over
the training loop's ``TrainingState`` — every_epoch, several_iteration,
max_epoch, max_iteration, and/or composition."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TrainingState:
    """The training loop's counters."""

    epoch: int = 1
    iteration: int = 0
    records_processed_this_epoch: int = 0
    epoch_finished: bool = False
    loss: float = float("inf")
    score: float = 0.0


class Trigger:
    def __call__(self, state: TrainingState) -> bool:
        raise NotImplementedError

    @staticmethod
    def every_epoch() -> "Trigger":
        return _EveryEpoch()

    @staticmethod
    def several_iteration(n: int) -> "Trigger":
        return _SeveralIteration(n)

    @staticmethod
    def max_epoch(n: int) -> "Trigger":
        return _MaxEpoch(n)

    @staticmethod
    def max_iteration(n: int) -> "Trigger":
        return _MaxIteration(n)

    @staticmethod
    def and_(*triggers: "Trigger") -> "Trigger":
        return _And(triggers)

    @staticmethod
    def or_(*triggers: "Trigger") -> "Trigger":
        return _Or(triggers)


class _EveryEpoch(Trigger):
    def __call__(self, state):
        return state.epoch_finished


class _SeveralIteration(Trigger):
    def __init__(self, n: int):
        self.n = n

    def __call__(self, state):
        return state.iteration > 0 and state.iteration % self.n == 0


class _MaxEpoch(Trigger):
    def __init__(self, n: int):
        self.n = n

    def __call__(self, state):
        return state.epoch > self.n


class _MaxIteration(Trigger):
    def __init__(self, n: int):
        self.n = n

    def __call__(self, state):
        return state.iteration >= self.n


class _And(Trigger):
    def __init__(self, triggers):
        self.triggers = triggers

    def __call__(self, state):
        return all(t(state) for t in self.triggers)


class _Or(Trigger):
    def __init__(self, triggers):
        self.triggers = triggers

    def __call__(self, state):
        return any(t(state) for t in self.triggers)
