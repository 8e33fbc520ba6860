"""The port's `QueryEngine` (device="cpu") against the JAX package's.

The map path is held bit for bit (``conftest.assert_bit_identical``:
ids, tie order, scores, cosines, boost flags) over the JAX engine
tests' sweeps: batch sizes 1/3/8, a ragged corpus, β = 0, duplicate
ties.  The gemm and kernel paths on the CPU are held to the same
ranking within f32 tolerance.  Refresh after add/update/remove equals a
cold rebuild bit for bit, and refresh never writes a tensor a snapshot
pinned."""
import numpy as np
import pytest
import torch

from conftest import assert_bit_identical
from repro.core.engine import QueryEngine as RefEngine
from repro.core.ingest import KnowledgeBase as RefKB
from repro.data.corpus import make_corpus
from repro_torch.core import engine as engine_mod
from repro_torch.core.engine import QueryEngine, resolve_scoring_path
from repro_torch.core.ingest import KnowledgeBase
from repro_torch.serving import EngineSnapshot, results_equal

# the suite runs test files in parallel workers: keep this file's torch
# ops on one thread so they do not starve the other workers
torch.set_num_threads(1)


def _texts(n_docs, seed=0, n_entities=6):
    docs, entities = make_corpus(n_docs=n_docs, n_entities=n_entities,
                                 seed=seed)
    return {f"doc_{i:05d}.txt": d for i, d in enumerate(docs)}, entities


def _kb(cls, texts, dim):
    kb = cls(dim=dim)
    for name, text in texts.items():
        kb.add_text(name, text)
    return kb


def _queries(entities):
    return ([code for code in entities]
            + [f"lookup {code} record" for code in entities]
            + ["quarterly forecast", "unrelated text", ""])


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("n_docs", [37, 80])  # 37: ragged against every block
@pytest.mark.parametrize("beta", [1.0, 0.0])
def test_map_path_bit_identical_to_jax(b, n_docs, beta):
    texts, entities = _texts(n_docs)
    ref = RefEngine(_kb(RefKB, texts, 1024), beta=beta)
    port = QueryEngine(_kb(KnowledgeBase, texts, 1024), beta=beta,
                       device="cpu")
    assert ref.scoring_path == port.scoring_path == "map"
    queries = _queries(entities)
    for start in range(0, len(queries), b):
        chunk = queries[start:start + b]
        assert_bit_identical(ref.query_batch(chunk, k=5),
                             port.query_batch(chunk, k=5),
                             label=f"b={b} n={n_docs} beta={beta}")


def test_duplicate_ties_bit_identical_to_jax():
    texts = {f"dup_{i:02d}": "identical tie content INV-7777"
             for i in range(12)}
    texts.update({f"other_{i:02d}": f"filler text {i}" for i in range(5)})
    ref = RefEngine(_kb(RefKB, texts, 512))
    port = QueryEngine(_kb(KnowledgeBase, texts, 512), device="cpu")
    got = port.query_batch(["INV-7777", "filler"], k=8)
    assert_bit_identical(ref.query_batch(["INV-7777", "filler"], k=8), got)
    assert [r.doc_id for r in got[0]] == [f"dup_{i:02d}" for i in range(8)]
    assert len({r.score for r in got[0]}) == 1


@pytest.mark.parametrize("path", ["gemm", "kernel"])
def test_gemm_and_kernel_paths_match_map_ranking(path):
    """The opt-in paths reorder the reduction, so scores agree within
    f32 tolerance; ids, tie order and boost flags must not move."""
    texts, entities = _texts(60)
    for i in range(10):
        texts[f"tie_{i:02d}"] = "identical tie content ZZ-4242"
    kb = _kb(KnowledgeBase, texts, 1024)
    queries = _queries(entities) + ["ZZ-4242"]
    a = QueryEngine(kb, device="cpu").query_batch(queries, k=6)
    b = QueryEngine(kb, device="cpu", scoring_path=path).query_batch(
        queries, k=6)
    assert_bit_identical(a, b, score_rtol=1e-5, score_atol=1e-6, label=path)


def test_boosted_flag_exact_at_beta_zero():
    texts = {"with_code": "the target document mentions QX-9090 here"}
    texts.update({f"filler_{i:02d}": f"unrelated filler text number {i}"
                  for i in range(15)})
    for path in ("map", "gemm", "kernel"):
        engine = QueryEngine(_kb(KnowledgeBase, texts, 512), beta=0.0,
                             scoring_path=path, device="cpu")
        flags = {r.doc_id: r.boosted
                 for r in engine.query_batch(["QX-9090"], k=16)[0]}
        assert flags["with_code"] is True
        assert not any(v for d, v in flags.items() if d != "with_code")


def _assert_matches_cold(engine, kb):
    matrix, sigs, ids = kb.materialize()
    assert engine.doc_ids == ids
    np.testing.assert_array_equal(engine.doc_vecs.numpy(), matrix)
    np.testing.assert_array_equal(engine.doc_sigs.numpy(), sigs)


def test_refresh_add_update_remove_equals_cold_and_jax():
    texts, _ = _texts(50)
    kb = _kb(KnowledgeBase, texts, 1024)
    ref_kb = _kb(RefKB, texts, 1024)
    engine = QueryEngine(kb, device="cpu")
    ref = RefEngine(ref_kb)
    steps = [
        (lambda k: k.add_text("zz_new_doc", "a brand new document QQ-1111"),
         dict(changed=1, restacked=True)),
        (lambda k: k.add_text("doc_00007.txt", "doc seven rewritten RR-2222"),
         dict(changed=1, removed=0, restacked=False)),
        (lambda k: k._remove_doc("doc_00003.txt"),
         dict(removed=1, restacked=True)),
    ]
    for mutate, want in steps:
        mutate(kb)
        mutate(ref_kb)
        stats = engine.refresh()
        ref.refresh()
        for key, value in want.items():
            assert getattr(stats, key) == value, (key, stats)
        _assert_matches_cold(engine, kb)
        np.testing.assert_array_equal(engine.doc_vecs.numpy(),
                                      np.asarray(ref.doc_vecs))
        np.testing.assert_array_equal(engine.doc_sigs.numpy(),
                                      np.asarray(ref.doc_sigs))
    assert engine.refresh().no_op


def test_refresh_patches_rows_copy_on_write():
    """A snapshot pinned before a row patch keeps its bits: refresh
    rebinds a patched clone and never writes the pinned tensor."""
    texts, entities = _texts(40)
    kb = _kb(KnowledgeBase, texts, 512)
    engine = QueryEngine(kb, device="cpu")
    queries = _queries(entities)
    snap = EngineSnapshot.capture(engine)
    pinned_vecs = snap.doc_vecs.clone()
    pinned_sigs = snap.doc_sigs.clone()
    before = snap.query_batch(queries, k=4)

    kb.add_text("doc_00001.txt", "doc one rewritten with WW-8080")
    stats = engine.refresh()
    assert stats.changed == 1 and not stats.restacked
    assert engine.doc_vecs is not snap.doc_vecs
    assert torch.equal(snap.doc_vecs, pinned_vecs)
    assert torch.equal(snap.doc_sigs, pinned_sigs)
    after = snap.query_batch(queries, k=4)
    for a, b in zip(before, after):
        assert results_equal(a, b)
    top = engine.query_batch(["WW-8080"], k=1)[0][0]
    assert top.doc_id == "doc_00001.txt" and top.boosted


def test_container_adoption_matches_fresh_build(tmp_path):
    texts, entities = _texts(30)
    kb = _kb(KnowledgeBase, texts, 512)
    p = str(tmp_path / "kb.ragdb")
    kb.save(p)
    fresh = QueryEngine(kb, device="cpu")
    loaded = QueryEngine(KnowledgeBase.load(p), device="cpu")
    queries = _queries(entities)
    assert_bit_identical(fresh.query_batch(queries, k=5),
                         loaded.query_batch(queries, k=5))


def test_engine_contracts():
    texts, _ = _texts(10)
    kb = _kb(KnowledgeBase, texts, 512)
    sharded = QueryEngine(kb, index="ivf-sharded", device="cpu")
    assert sharded.n_shards == 1 and sharded.scoring_path == "map"
    with pytest.raises(ValueError, match="n_shards"):
        QueryEngine(kb, index="ivf", n_shards=2, device="cpu")
    with pytest.raises(ValueError):
        QueryEngine(kb, index="hnsw", device="cpu")
    with pytest.raises(ValueError):
        QueryEngine(kb, device="cpu").query_batch(["x"], k=0)
    with pytest.raises(ValueError):
        QueryEngine(kb, device="meta")
    empty = QueryEngine(KnowledgeBase(dim=512), device="cpu")
    assert empty.query_batch(["x", "y"], k=3) == [[], []]
    assert engine_mod._bucket(5) == 8 and engine_mod._bucket(1) == 1


def test_scoring_path_resolution():
    assert resolve_scoring_path("auto", device="cpu") == "map"
    assert resolve_scoring_path("auto", device="cuda") == "kernel"
    assert resolve_scoring_path("auto", use_kernel=True) == "kernel"
    assert resolve_scoring_path("map", device="cuda") == "map"
    with pytest.raises(ValueError):
        resolve_scoring_path("auto", use_kernel=True, gemm_batch=True)
    with pytest.raises(ValueError):
        resolve_scoring_path("fast")


def test_no_device_without_a_card_raises(monkeypatch):
    """Entry points default to the card; with no card and no device
    asked for they raise rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    texts, _ = _texts(10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QueryEngine(_kb(KnowledgeBase, texts, 512))
    with pytest.raises(RuntimeError):
        QueryEngine(_kb(KnowledgeBase, texts, 512), device="cuda")
    assert engine_mod.resolve_device("cpu") == torch.device("cpu")


def test_arrays_from_numpy_copies():
    vecs = np.ones((3, 4), np.float32)
    sigs = np.ones((3, 2), np.int32)
    tv, ts = engine_mod.arrays_from_numpy(vecs, sigs, "cpu")
    vecs[0, 0] = 7.0
    assert tv[0, 0].item() == 1.0
    assert tv.dtype == torch.float32 and ts.dtype == torch.int32
