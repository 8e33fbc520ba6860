"""The benchmark's own library: what a run needs besides the program
under test (``repro_torch``), and the yardstick later changes to the
program cannot move: traffic, the corpus, weights, the plain
references, the counts of operations and bytes, the peaks, and the
comparison that decides ``correct``.  Nothing here imports ``jax`` or
the JAX package; only ``harness`` and the files under ``adapters/``
import ``repro_torch``."""
