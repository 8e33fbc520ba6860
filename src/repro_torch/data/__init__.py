"""Synthetic corpora (``corpus.py``)."""
