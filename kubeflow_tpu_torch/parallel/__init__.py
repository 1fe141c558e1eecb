"""The mesh and the logical-axis sharding rules (counterpart of
kubeflow_tpu/parallel/; the pipeline runner is ROADMAP.md A6c)."""

from kubeflow_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    MeshConfig,
    active_mesh,
    check_ported_axes,
    data_shard_index,
    get_active_mesh,
    make_mesh,
    mesh_config,
    mesh_shape,
    num_data_shards,
    single_device_mesh,
    validate_divisibility,
)
from kubeflow_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    distribute,
    gather,
    local_chunk,
    logical_to_spec,
    reduce_grad,
    spec_placements,
    tree_logical_to_placements,
)

__all__ = [
    "AXIS_ORDER",
    "MeshConfig",
    "make_mesh",
    "mesh_config",
    "mesh_shape",
    "single_device_mesh",
    "active_mesh",
    "get_active_mesh",
    "num_data_shards",
    "data_shard_index",
    "validate_divisibility",
    "check_ported_axes",
    "DEFAULT_RULES",
    "logical_to_spec",
    "spec_placements",
    "tree_logical_to_placements",
    "local_chunk",
    "distribute",
    "gather",
    "reduce_grad",
]
