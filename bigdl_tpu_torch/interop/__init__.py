"""Weight interchange with the JAX package."""

from bigdl_tpu_torch.interop.jax_params import load_jax_params

__all__ = ["load_jax_params"]
