from repro_torch.sharding.logical import (FSDP_RULES, BASE_RULES,
                                          PartitionSpec, Sharding,
                                          activate_mesh, constrain,
                                          current_manual, current_mesh,
                                          current_rules, manual_axes,
                                          mesh_axis_sizes, rules_for,
                                          scenario_shard_map, sharding_for,
                                          spec_for)

__all__ = ["BASE_RULES", "FSDP_RULES", "PartitionSpec", "Sharding",
           "activate_mesh", "constrain", "current_manual", "current_mesh",
           "current_rules", "manual_axes", "mesh_axis_sizes", "rules_for",
           "scenario_shard_map", "sharding_for", "spec_for"]
