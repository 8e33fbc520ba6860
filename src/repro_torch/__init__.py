"""repro_torch — the RAGdb serving system in PyTorch, for one NVIDIA H100.

A port of the JAX package ``repro`` (which stays the reference): the
same ``.ragdb`` containers and delta journals, the same HSF scores and
rankings, the same serving runtime.  Plain tensor code is PyTorch; each
kernel the reference wrote in Pallas is a hand-written CUDA kernel
under ``csrc/``, built with ``nvcc`` at first use (``kernels/build.py``).

This package imports neither jax nor anything of ``repro``.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
