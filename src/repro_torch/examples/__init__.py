"""End-to-end programs of the port, twins of the JAX package's
``examples/``; each runs as ``python -m repro_torch.examples.<name>``."""
