"""Weight and state interchange with the JAX package."""

from bigdl_tpu_torch.interop.jax_params import (
    export_optim_state,
    export_params,
    export_state,
    load_jax_params,
    load_optim_state,
    to_numpy_tree,
)

__all__ = ["export_optim_state", "export_params", "export_state",
           "load_jax_params", "load_optim_state", "to_numpy_tree"]
