"""The decode step's MoE layer: ``ops.py`` (wrapper, launch counter) and
``ref.py`` (its plain version); the kernel is ``csrc/moe_decode.cu``."""
