"""Distribution substrate: the sweep's lane split over a mesh, the
language models' logical-axis sharding rules, and GPipe stage
parallelism."""
from .sharding import (DEFAULT_RULES, Mesh, NamedSharding, PartitionSpec,
                       ShardingRules, constrain, current_rules, flat_shards,
                       logical_to_spec, mesh_device, pad_batch, padded_len,
                       set_rules, spec_tree)
from .pipeline import pipeline_apply, split_stages
