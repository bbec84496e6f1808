"""numpy-only FST and sparse-graph helpers the port needs."""
