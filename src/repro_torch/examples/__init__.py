"""Example twins of the reference's `examples/` scripts, run as
`python -m repro_torch.examples.<name>`."""
