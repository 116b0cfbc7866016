"""Data: the synthetic pet-like batches of smoke tests and benchmarks."""
