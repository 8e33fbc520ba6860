"""Hand-written Hopper kernels, one folder per kernel the JAX package
wrote in Pallas: ``ops.py`` (the wrapper and its launch counter) and
``ref.py`` (the plain PyTorch version) beside each.  CUDA sources live
in ``repro_torch/csrc/`` and are built by ``kernels/build.py``."""
