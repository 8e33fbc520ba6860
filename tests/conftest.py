import os
import sys
import types

import numpy as np

# Tests run on the single real CPU device (the dry-run, and only the
# dry-run, uses the 512-device XLA flag).  Sharded-equivalence tests
# spawn subprocesses with their own XLA_FLAGS.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def assert_bit_identical(a, b, *, score_rtol=None, score_atol=0.0,
                         label=""):
    """Assert two retrieval outputs are bit-identical.

    The repo's central correctness claim (ARCHITECTURE §6/§10) is that
    every optimized plane — IVF probe/rerank, the sharded mesh plane,
    generation-pinned snapshots — returns *the same bits* as the flat
    scan: same ids, same tie order, same scores, same boost flags.
    This is the one comparator every suite uses to state that claim.

    Accepts either shape of output:

    - two lists of per-query ``RetrievalResult`` lists (what
      ``QueryEngine.query_batch`` / ``EngineSnapshot.query_batch``
      return), or
    - two ``(vals, ids)`` array pairs (raw top-k planes).

    Scores compare with ``==`` by default.  ``score_rtol`` (plus
    optional ``score_atol``) loosens *only* the score comparison — for
    kernel-path tests where fused-multiply ordering shifts the last
    ulps; ids and tie order must still match exactly.
    """
    if isinstance(a, tuple):
        (av, ai), (bv, bi) = a, b
        np.testing.assert_array_equal(
            np.asarray(ai), np.asarray(bi), err_msg=f"{label}: ids")
        if score_rtol is None:
            np.testing.assert_array_equal(
                np.asarray(av), np.asarray(bv), err_msg=f"{label}: scores")
        else:
            np.testing.assert_allclose(
                np.asarray(av), np.asarray(bv), rtol=score_rtol,
                atol=score_atol, err_msg=f"{label}: scores")
        return
    assert len(a) == len(b), (label, len(a), len(b))
    for qi, (ra, rb) in enumerate(zip(a, b)):
        assert len(ra) == len(rb), (label, qi, len(ra), len(rb))
        for rank, (x, y) in enumerate(zip(ra, rb)):
            where = f"{label} query {qi} rank {rank}"
            assert x.doc_id == y.doc_id, (where, x.doc_id, y.doc_id)
            if score_rtol is None:
                assert x.score == y.score, (where, x.score, y.score)
                assert x.cosine == y.cosine, (where, x.cosine, y.cosine)
            else:
                np.testing.assert_allclose(x.score, y.score,
                                           rtol=score_rtol,
                                           atol=score_atol, err_msg=where)
                np.testing.assert_allclose(x.cosine, y.cosine,
                                           rtol=score_rtol,
                                           atol=score_atol, err_msg=where)
            assert x.boosted == y.boosted, (where, x.boosted, y.boosted)

# Optional-dependency gate: hypothesis is not in every deployment image.
# When absent, install a stub so test modules still import — property
# tests then skip individually at call time instead of erroring the
# whole file out of collection (deterministic tests keep running).
try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    import pytest

    def _given(*_a, **_k):
        def deco(fn):
            # NOTE: no functools.wraps — copying fn's signature would make
            # pytest resolve the strategy kwargs as fixtures and error.
            def wrapper():
                pytest.skip("hypothesis not installed (optional dep)")

            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            return wrapper

        return deco

    def _settings(*_a, **_k):
        return lambda fn: fn

    def _strategy(*_a, **_k):
        return None

    _st = types.ModuleType("hypothesis.strategies")
    _st.__getattr__ = lambda name: _strategy  # integers, text, characters, …

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


def pytest_configure(config):
    # tests of CUDA kernels that run only on a card: each decides inside
    # the test (a fixture) whether a CUDA device is present, and skips
    # with that reason where none is
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips on a host without one")
