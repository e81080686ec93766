"""Training: optim methods, schedules, triggers and the loop; inference:
``Predictor`` and ``PredictionService`` (``bigdl_tpu/optim``
counterparts)."""

from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.predictor import PredictionService, Predictor
from bigdl_tpu_torch.optim.optimizer import (
    LocalOptimizer,
    Optimizer,
    optimizer,
)
from bigdl_tpu_torch.optim.schedules import Default, MultiStep
from bigdl_tpu_torch.optim.trigger import TrainingState, Trigger

__all__ = ["Default", "LocalOptimizer", "MultiStep", "OptimMethod",
           "Optimizer", "PredictionService", "Predictor", "SGD", "TrainingState", "Trigger", "optimizer"]
