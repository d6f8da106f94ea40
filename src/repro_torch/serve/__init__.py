"""Serving on the card: the batched engine (``engine``) and the online
shape-bucketed autotuner (``autotune``), carried over from the JAX
package's ``repro.serve``."""
