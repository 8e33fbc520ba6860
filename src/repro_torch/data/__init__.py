"""Synthetic data: corpora (``corpus.py``) and the training and serving
batches of the model families (``pipeline.py``)."""
