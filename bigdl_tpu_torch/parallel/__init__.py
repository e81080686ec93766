"""Data parallelism over a ``torch.distributed`` process group
(``bigdl_tpu/parallel`` counterparts): named-axis meshes of ranks and
bucketed gradient synchronisation that overlaps the backward. The
tensor, pipeline, sequence and expert parallel strategies are not ported
yet (ROADMAP A.5.10, A.8)."""

from bigdl_tpu_torch.parallel.mesh import (
    Mesh,
    MeshSpec,
    axis_size,
    current_mesh,
    factor_devices,
    make_mesh,
    use_mesh,
)
from bigdl_tpu_torch.parallel.overlap import (
    STATE_REDUCE_POLICY,
    make_buckets,
    make_ddp_overlap_step,
    make_zero1_overlap_step,
    reduce_module_state,
    zero1_init_state,
)

__all__ = ["Mesh", "MeshSpec", "STATE_REDUCE_POLICY", "axis_size",
           "current_mesh", "factor_devices", "make_buckets",
           "make_ddp_overlap_step", "make_mesh", "make_zero1_overlap_step",
           "reduce_module_state", "use_mesh", "zero1_init_state"]
