"""Benchmark twins of the reference's `benchmarks/` scripts, run as
`python -m repro_torch.benchmarks.<name>`."""
