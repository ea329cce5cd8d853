"""Launch helpers of the port: `mesh` (the engine mesh of the sharded
serving plane)."""
