"""Distributed helpers of the port: so far only the jax-free architecture
arithmetic of the JAX package's ``repro.distributed.tuning``."""
