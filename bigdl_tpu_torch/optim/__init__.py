"""Training: optim methods, schedules, triggers, validation and the loop;
inference: ``Predictor``, ``Evaluator`` and ``PredictionService``
(``bigdl_tpu/optim`` counterparts)."""

from bigdl_tpu_torch.optim.optim_method import (
    SGD,
    Adadelta,
    Adagrad,
    Adam,
    Adamax,
    Ftrl,
    LarsSGD,
    OptimMethod,
    ParallelAdam,
    RMSprop,
)
from bigdl_tpu_torch.optim.optimizer import (
    LocalOptimizer,
    Optimizer,
    optimizer,
)
from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer
from bigdl_tpu_torch.optim.predictor import (
    Evaluator,
    PredictionService,
    Predictor,
)
from bigdl_tpu_torch.optim.schedules import (
    Default,
    EpochDecay,
    EpochSchedule,
    EpochStep,
    Exponential,
    LearningRateSchedule,
    MultiStep,
    NaturalExp,
    Plateau,
    Poly,
    SequentialSchedule,
    Step,
    Warmup,
)
from bigdl_tpu_torch.optim.trigger import TrainingState, Trigger
from bigdl_tpu_torch.optim.validation import (
    NDCG,
    HitRatio,
    Loss,
    MeanAveragePrecision,
    PrecisionRecallAUC,
    Top1Accuracy,
    Top5Accuracy,
    TopKAccuracy,
    TreeNNAccuracy,
    ValidationMethod,
    ValidationResult,
)

__all__ = ["Adadelta", "Adagrad", "Adam", "Adamax", "Default",
           "DistriOptimizer", "EpochDecay",
           "EpochSchedule", "EpochStep", "Evaluator", "Exponential", "Ftrl",
           "HitRatio", "LarsSGD", "LearningRateSchedule", "LocalOptimizer",
           "Loss", "MeanAveragePrecision", "MultiStep", "NDCG",
           "NaturalExp", "OptimMethod", "Optimizer", "ParallelAdam",
           "Plateau", "Poly", "PrecisionRecallAUC", "PredictionService",
           "Predictor", "RMSprop", "SGD", "SequentialSchedule", "Step",
           "Top1Accuracy", "Top5Accuracy", "TopKAccuracy", "TrainingState",
           "TreeNNAccuracy", "Trigger", "ValidationMethod",
           "ValidationResult", "Warmup", "optimizer"]
