"""Seeded weight initialisation (``bigdl_tpu/nn/init.py`` counterparts).

The JAX package draws from threefry keys; the port draws from an explicit
``torch.Generator`` on the CPU and then moves the tensor to its device, so
the same generator seed gives the same weights on the CPU and on a card.
The two packages never give the same numbers from one seed: tests that
compare them copy the JAX weights across (``interop.jax_params``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


class InitializationMethod:
    def __call__(self, generator: torch.Generator, shape: Sequence[int],
                 fan_in: int, fan_out: int,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
        raise NotImplementedError


class RandomUniform(InitializationMethod):
    """Torch-style uniform in [-1/sqrt(fan_in), 1/sqrt(fan_in)]."""

    def __call__(self, generator, shape, fan_in, fan_out,
                 dtype=torch.float32):
        stdv = 1.0 / math.sqrt(max(1, fan_in))
        u = torch.rand(tuple(shape), generator=generator, dtype=dtype)
        return stdv * (2.0 * u - 1.0)


class RandomNormal(InitializationMethod):
    def __init__(self, mean: float = 0.0, stdv: float = 1.0):
        self.mean, self.stdv = mean, stdv

    def __call__(self, generator, shape, fan_in, fan_out,
                 dtype=torch.float32):
        return self.mean + self.stdv * torch.randn(
            tuple(shape), generator=generator, dtype=dtype)


def default_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    """The given generator, or a fresh CPU one seeded 0 (deterministic)."""
    return generator if generator is not None else torch.Generator().manual_seed(0)
