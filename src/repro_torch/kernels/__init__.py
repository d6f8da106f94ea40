"""Hand-written Hopper kernels of the paper's benchmarks.

Each subpackage: ``kernel.py`` (the wrapper, its launch count and the plain
PyTorch version), ``ops.py`` (config-dict dispatch), ``ref.py`` (oracle) and
``space.py`` (tuning space + portable workload model g(TP, I)).  CUDA
sources live in ``repro_torch/csrc``.
"""
