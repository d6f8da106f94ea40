"""Distributed helpers of the port: the jax-free architecture arithmetic
of the JAX package's ``repro.distributed.tuning``, and the int8 gradient
round trip of its ``compression``."""
