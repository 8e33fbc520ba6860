"""Flash attention: ``ops.py`` (wrapper, launch counter) and ``ref.py``
(its plain version); the kernel is ``csrc/flash_attention.cu``."""
