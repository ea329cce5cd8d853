"""Placement of the sharded serving plane: `sharding` (where each weight
and each shard of the merged decode cache lives on an `EngineMesh`) and
`annotate` (the mesh context the MoE layer reads)."""
