"""The recsys family in PyTorch: ``base`` (config, loss, weight
carrying), ``embedding`` (the fused table and its lookups, the
EmbeddingBag path) and the models ``dlrm``, ``deepfm`` and ``autoint``."""
