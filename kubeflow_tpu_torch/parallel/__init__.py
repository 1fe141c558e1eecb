"""The mesh and the logical-axis sharding rules (counterpart of
kubeflow_tpu/parallel/; `pipeline` holds the stage split: the GPipe
training schedule and the serving half), with the Megatron region
operators of the tensor and expert axes and the sequence group's
ring."""

from kubeflow_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    MeshConfig,
    active_mesh,
    arrange_ranks,
    data_shard_index,
    get_active_mesh,
    make_mesh,
    mesh_config,
    mesh_shape,
    num_data_shards,
    single_device_mesh,
    stage_submeshes,
    node_ids,
    validate_divisibility,
)
from kubeflow_tpu_torch.parallel.sharding import (
    BATCH_AXES,
    DEFAULT_RULES,
    NO_REGIONS,
    Regions,
    distribute,
    gather,
    local_chunk,
    logical_to_spec,
    reduce_grad,
    regions,
    ring_peers,
    spec_placements,
    tree_logical_to_placements,
    vocab_parallel_ce,
)

__all__ = [
    "AXIS_ORDER",
    "MeshConfig",
    "make_mesh",
    "arrange_ranks",
    "node_ids",
    "mesh_config",
    "mesh_shape",
    "single_device_mesh",
    "stage_submeshes",
    "active_mesh",
    "get_active_mesh",
    "num_data_shards",
    "data_shard_index",
    "validate_divisibility",
    "DEFAULT_RULES",
    "logical_to_spec",
    "spec_placements",
    "tree_logical_to_placements",
    "local_chunk",
    "distribute",
    "gather",
    "reduce_grad",
    "BATCH_AXES",
    "NO_REGIONS",
    "Regions",
    "regions",
    "ring_peers",
    "vocab_parallel_ce",
]
