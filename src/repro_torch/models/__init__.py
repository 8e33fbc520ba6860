"""The generation plane in PyTorch: ``layers`` (norms, RoPE, gated MLP),
``attention`` (the flash kernel's dispatch, the plain blockwise and
banded paths, decode) and ``transformer`` (the decoder LM, dense
branches)."""
