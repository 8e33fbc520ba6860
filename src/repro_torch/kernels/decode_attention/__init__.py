"""The decode step's GQA attention core: ``ops.py`` (wrapper, launch
counter) and ``ref.py`` (its plain version); the kernel is
``csrc/decode_attention.cu``."""
