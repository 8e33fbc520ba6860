"""Runtime sanitizers (``sanitizers.py``).  The JAX package's static
analyzer is not ported yet."""
