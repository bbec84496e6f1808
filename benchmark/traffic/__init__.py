"""The benchmark's traffic: inputs drawn from a run's seed, identical for the
program and for the reference."""
