"""Device choice, configuration, the engine (process group and mesh) and
host-side randomness."""

from bigdl_tpu_torch.core.config import DtypePolicy, EngineConfig
from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.core.engine import Engine
from bigdl_tpu_torch.core.rng import RandomGenerator, element_seed, np_rng

__all__ = ["DtypePolicy", "Engine", "EngineConfig", "RandomGenerator", "element_seed",
           "np_rng", "resolve_device"]
