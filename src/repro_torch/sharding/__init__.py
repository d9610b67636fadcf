"""Rule-based auto-sharder (FSDP × TP × EP) for the model zoo, over
DTensor placements."""

from .auto import (MeshShape, PartitionSpec, ShardingRules, batch_axes,
                   batch_specs, cache_specs_sharding, distribute_state_dict,
                   param_shardings, partition_spec, to_placements)

__all__ = ["batch_axes", "batch_specs", "cache_specs_sharding",
           "param_shardings", "partition_spec", "ShardingRules",
           "MeshShape", "PartitionSpec", "distribute_state_dict",
           "to_placements"]
