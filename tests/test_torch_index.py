"""The port's IVF index plane (`repro_torch.index`,
`QueryEngine(index="ivf")`) on the CPU: the contracts of
tests/test_index.py, and parity with the JAX package.

Within the port, everything is held bit for bit on the map path
(``conftest.assert_bit_identical``): exact mode against flat, mutations,
the candidate-row gather, the prefilter.  Across packages, k-means
cannot be compared (the JAX package seeds its init with ``jax.random``),
so the tests carry one trained state across instead — through a saved
container in both directions, adopted with no retrain — and hold the
probe and exact results of the two engines over that state bit for bit
at α = 1 (β ∈ {1, 0}), and within one FMA's rounding (rtol 1e-6) at
α ≠ 1, where XLA CPU contracts ``α·cos + β·ind`` (ROADMAP Queue 3
item 1)."""
import contextlib
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import assert_bit_identical
from repro.core.engine import QueryEngine as RefEngine
from repro.core.ingest import KnowledgeBase as RefKB
from repro.core.retrieval import Retriever as RefRetriever
from repro.data.corpus import make_corpus, write_corpus_dir
from repro.launch import serve as ref_serve
from repro.obs.ledger import measure_engine_planes as ref_planes
from repro_torch.core.engine import (
    QueryEngine,
    pack_query_arrays,
    score_batch_arrays,
)
from repro_torch.core.ingest import KnowledgeBase
from repro_torch.core.retrieval import (
    Retriever,
    _stable_top_k,
    build_sharded_retrieve,
    pad_corpus,
    single_device_reference,
)
from repro_torch.index import IVFIndex, default_n_clusters, spherical_kmeans
from repro_torch.index import ivf as ivf_mod
from repro_torch.launch import serve
from repro_torch.obs.ledger import measure_engine_planes

# the suite runs test files in parallel workers: keep this file's torch
# ops on one thread so they do not starve the other workers
torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _kb(cls=KnowledgeBase, n_docs=80, dim=512, n_entities=6, seed=0):
    docs, entities = make_corpus(n_docs=n_docs, n_entities=n_entities,
                                 seed=seed)
    kb = cls(dim=dim)
    for i, d in enumerate(docs):
        kb.add_text(f"doc_{i:05d}.txt", d)
    return kb, entities


def _eng(kb, **kw):
    return QueryEngine(kb, scoring_path="map", device="cpu", **kw)


def _scores(results):
    return [[r.score for r in res] for res in results]


def _queries(entities):
    return (list(entities) + [f"lookup {c} record" for c in entities]
            + ["quarterly forecast", "unrelated text", ""])


# --------------------------------------------------------------------------
# k-means: determinism + degenerate corpora
# --------------------------------------------------------------------------

def _unit_rows(n, d, seed):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_kmeans_deterministic_from_seed():
    x = torch.from_numpy(_unit_rows(200, 64, 0))
    c1, a1 = spherical_kmeans(x, 14, seed=7)
    c2, a2 = spherical_kmeans(x, 14, seed=7)
    np.testing.assert_array_equal(c1, c2)  # bit-identical refit
    np.testing.assert_array_equal(a1, a2)
    c3, _ = spherical_kmeans(x, 14, seed=8)
    assert not np.array_equal(c1, c3)  # the seed actually matters
    assert c1.dtype == np.float32 and a1.dtype == np.int32


def test_kmeans_centroids_are_unit_norm_and_assignments_valid():
    cent, assign = spherical_kmeans(_unit_rows(100, 32, 1), 10, seed=0)
    np.testing.assert_allclose(np.linalg.norm(cent, axis=1), 1.0, rtol=1e-5)
    assert assign.shape == (100,)
    assert assign.min() >= 0 and assign.max() < 10
    # every point sits with its most similar centroid
    np.testing.assert_array_equal(
        assign, np.argmax(_unit_rows(100, 32, 1) @ cent.T, axis=1))


def test_kmeans_survives_duplicate_points():
    """Empty-cluster reseeding: more clusters than distinct points must
    still terminate with finite centroids and in-range assignments."""
    x = np.tile(np.eye(2, 16, dtype=np.float32), (5, 1))  # 10 rows, 2 unique
    cent, assign = spherical_kmeans(x, 8, seed=0)
    assert np.all(np.isfinite(cent))
    assert assign.min() >= 0 and assign.max() < 8


def test_kmeans_clamps_k_to_n_and_handles_empty():
    cent, assign = spherical_kmeans(np.eye(3, 8, dtype=np.float32), 50,
                                    seed=0)
    assert cent.shape[0] == 3
    cent, assign = spherical_kmeans(np.zeros((0, 8), np.float32), None)
    assert cent.shape == (0, 8) and assign.shape == (0,)


def test_default_n_clusters_is_sqrt_n():
    assert default_n_clusters(0) == 1
    assert default_n_clusters(100) == 10
    assert default_n_clusters(50_000) == 224
    assert default_n_clusters(65_536) == 256


# --------------------------------------------------------------------------
# the exactness guarantee: ivf@exact is bit-identical to the flat scan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_docs", [7, 33, 100])   # ragged corpus sizes
@pytest.mark.parametrize("beta", [1.0, 0.0])       # β=0: pure cosine
def test_ivf_exact_bit_identical_to_flat_sweep(n_docs, beta):
    kb, entities = _kb(n_docs=n_docs,
                       n_entities=min(4, max(1, n_docs // 4)))
    flat = _eng(kb, beta=beta)
    ivf = _eng(kb, beta=beta, index="ivf", guarantee="exact", nprobe=1)
    queries = (list(entities)
               + [f"lookup {c} record" for c in list(entities)[:2]]
               + ["quarterly forecast", "unrelated text", ""])
    for b in (1, 3, 8):  # batch sizes (padding buckets 1/4/8)
        batch = (queries * 3)[:b]
        assert_bit_identical(flat.query_batch(batch, k=5),
                             ivf.query_batch(batch, k=5),
                             label=f"n_docs={n_docs} beta={beta} b={b}")


def test_ivf_exact_with_duplicate_ties():
    """Duplicate docs tie exactly; exact mode must reproduce the flat
    scan's doc-index tie order (ties at the k-th score force further
    probing)."""
    kb = KnowledgeBase(dim=512)
    for i in range(12):
        kb.add_text(f"dup_{i:02d}", "identical tie content INV-7777")
    for i in range(20):
        kb.add_text(f"filler_{i:02d}", f"unrelated filler number {i}")
    flat = _eng(kb)
    ivf = _eng(kb, index="ivf", guarantee="exact", nprobe=1)
    got = ivf.query_batch(["INV-7777"], k=6)
    assert_bit_identical(flat.query_batch(["INV-7777"], k=6), got)
    assert len(set(_scores(got)[0])) == 1  # genuinely tied


def test_ivf_probe_mode_recall_and_sublinear_scan():
    kb, entities = _kb(n_docs=400, n_entities=8)
    ivf = _eng(kb, index="ivf", nprobe=1)
    for code, target in entities.items():
        top = ivf.query_batch([code], k=1)[0][0]
        assert top.doc_id == f"doc_{target:05d}.txt", code
        stats = ivf.index_stats()
        assert stats["probed_fraction"] < 0.5  # genuinely pruned
        assert stats["clusters_probed"] < stats["n_clusters"]


def test_ivf_k_larger_than_corpus_clamps():
    kb, _ = _kb(n_docs=5, n_entities=1)
    ivf = _eng(kb, index="ivf", guarantee="exact")
    assert len(ivf.query_batch(["anything"], k=50)[0]) == 5


# --------------------------------------------------------------------------
# incremental maintenance: reassign / restack / drift-triggered retrain
# --------------------------------------------------------------------------

def test_ivf_tracks_mutations_and_stays_exact():
    kb, entities = _kb(n_docs=120)
    flat = _eng(kb)
    ivf = _eng(kb, index="ivf", guarantee="exact", nprobe=2)
    idx0 = ivf.ivf

    kb.add_text("doc_00004.txt", "rewritten four ZZ-1111")   # in-place
    stats = ivf.refresh()
    assert stats.index_reassigned == 1 and not stats.restacked
    assert ivf.ivf is not idx0  # maintenance rebinds, never mutates

    kb.add_text("brand_new.txt", "fresh doc YY-2222")        # restack
    kb._remove_doc("doc_00050.txt")
    stats = ivf.refresh()
    assert stats.restacked and stats.index_reassigned >= 1
    assert len(ivf.ivf.assign) == kb.n_docs

    queries = ["ZZ-1111", "YY-2222"] + list(entities)[:3]
    assert_bit_identical(flat.query_batch(queries, k=4),
                         ivf.query_batch(queries, k=4))


def test_ivf_drift_counter_triggers_retrain():
    kb, _ = _kb(n_docs=60)
    ivf = _eng(kb, index="ivf", retrain_drift=0.1)  # ~6 moved rows
    assert ivf.ivf.drift == 0 and ivf.retrains == 1
    for i in range(30):  # churn enough rows to cross the threshold
        kb.add_text(f"doc_{i:05d}.txt",
                    f"totally different content now {i} XK-{i:04d}")
    stats = ivf.refresh()
    assert stats.index_retrained and ivf.retrains == 2
    assert ivf.ivf.drift == 0 and ivf.ivf.trained_n == kb.n_docs


def test_ivf_reassign_keeps_bounds_conservative():
    """Incremental updates may only widen cluster bounds: the receiving
    cluster's signature union gains the row's bits and its radius never
    rises."""
    kb, _ = _kb(n_docs=80)
    ivf = _eng(kb, index="ivf")
    before = ivf.ivf
    kb.add_text("doc_00007.txt", "mutated seven with novel terms WQ-4242")
    ivf.refresh()
    after = ivf.ivf
    c = after.assign[ivf._row_of["doc_00007.txt"]]
    assert after.radius[c] <= before.radius[c] + 1e-7
    assert np.all((before.sig_union[c] & after.sig_union[c])
                  == before.sig_union[c])


def test_ivf_state_roundtrip_is_bit_identical():
    kb, _ = _kb(n_docs=50)
    ivf = _eng(kb, index="ivf")
    clone = IVFIndex.from_state(ivf.ivf.state_dict(ivf.doc_ids))
    for name in ("centroids", "assign", "radius", "sig_union"):
        np.testing.assert_array_equal(getattr(clone, name),
                                      getattr(ivf.ivf, name))
    for a, b in zip(clone.members, ivf.ivf.members):
        np.testing.assert_array_equal(a, b)
    assert (clone.drift, clone.trained_n, clone.seed) == \
        (ivf.ivf.drift, ivf.ivf.trained_n, ivf.ivf.seed)


def test_stale_index_state_is_not_adopted_after_inplace_rewrite(
        monkeypatch):
    """The persisted state's key covers doc *content*, not just ids: an
    in-place rewrite with no live index maintenance must refuse the
    stale state and retrain, and exact mode must still match flat."""
    kb, _ = _kb(n_docs=40)
    _eng(kb, index="ivf")  # writes kb.index_state
    kb.add_text("doc_00012.txt", "rewritten with a brand new code PJ-3131")
    calls = []
    orig = ivf_mod.spherical_kmeans
    monkeypatch.setattr(ivf_mod, "spherical_kmeans",
                        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    fresh = _eng(kb, index="ivf", guarantee="exact")
    assert calls == [1] and fresh.retrains == 1
    assert_bit_identical(fresh.query_batch(["PJ-3131"], k=4),
                         _eng(kb).query_batch(["PJ-3131"], k=4))


def test_from_assignments_bounds_cover_every_member():
    """The radius is the least member·centroid dot (computed on the doc
    tensors' device), the union ORs every member's signature."""
    kb, _ = _kb(n_docs=90)
    eng = _eng(kb)
    cent, assign = spherical_kmeans(eng.doc_vecs, 9, seed=3)
    idx = IVFIndex.from_assignments(cent, assign, eng.doc_vecs,
                                    eng.doc_sigs, drift=0, trained_n=90,
                                    seed=3)
    dv, ds = eng.doc_vecs.numpy(), eng.doc_sigs.numpy()
    dots = np.einsum("nd,nd->n", dv, cent[assign])
    for c in range(9):
        rows = idx.members[c]
        np.testing.assert_array_equal(rows, np.nonzero(assign == c)[0])
        if rows.size:
            np.testing.assert_allclose(idx.radius[c], dots[rows].min(),
                                       rtol=0, atol=1e-6)
            assert np.array_equal(np.bitwise_or.reduce(ds[rows], axis=0),
                                  idx.sig_union[c])


# --------------------------------------------------------------------------
# candidate-gather helper (shared with the postings prefilter)
# --------------------------------------------------------------------------

def test_score_candidate_rows_matches_flat_subset():
    kb, entities = _kb(n_docs=90)
    eng = _eng(kb)
    qv, qs = eng._query_arrays(next(iter(entities)))
    qvp, qsp = pack_query_arrays([(qv, qs)], kb.dim, kb.sig_words)
    n = len(eng.doc_ids)
    fv, fi, _, _ = score_batch_arrays(
        eng.doc_vecs, eng.doc_sigs, qvp, qsp,
        scoring_path="map", k=n, alpha=eng.alpha, beta=eng.beta, n_docs=n)
    cand = np.sort(np.random.default_rng(0).choice(n, 40, replace=False)
                   ).astype(np.int32)
    sv, si, _, _ = ivf_mod.score_candidate_rows(
        eng.doc_vecs, eng.doc_sigs, cand, qvp, qsp,
        scoring_path="map", k=10, alpha=eng.alpha, beta=eng.beta)
    in_cand = np.isin(fi[0], cand)
    np.testing.assert_array_equal(si[0], fi[0][in_cand][:10])
    np.testing.assert_array_equal(sv[0], fv[0][in_cand][:10])
    # an empty subset scores nothing
    ev, ei, _, _ = ivf_mod.score_candidate_rows(
        eng.doc_vecs, eng.doc_sigs, np.zeros((0,), np.int32), qvp, qsp,
        scoring_path="map", k=10, alpha=1.0, beta=1.0)
    assert ev.shape == ei.shape == (1, 0)


def test_prefilter_uses_shared_gather_and_matches_full_scan():
    kb, entities = _kb(n_docs=100)
    pre = Retriever(kb, prefilter=True, scoring_path="map", device="cpu")
    full = Retriever(kb, prefilter=False, scoring_path="map", device="cpu")
    for code in list(entities)[:3]:
        got = pre.query(code, k=5)
        want = full.query(code, k=5)
        assert len(got) >= 1
        assert [(r.doc_id, r.score, r.cosine, r.boosted) for r in got] == \
            [(r.doc_id, r.score, r.cosine, r.boosted)
             for r in want[:len(got)]]


# --------------------------------------------------------------------------
# parameter validation
# --------------------------------------------------------------------------

def test_ivf_parameter_validation():
    kb, _ = _kb(n_docs=10, n_entities=1)
    with pytest.raises(ValueError, match="index"):
        QueryEngine(kb, index="bogus", device="cpu")
    with pytest.raises(ValueError, match="guarantee"):
        QueryEngine(kb, index="ivf", guarantee="bogus", device="cpu")
    with pytest.raises(ValueError, match="nprobe"):
        QueryEngine(kb, index="ivf", nprobe=0, device="cpu")
    with pytest.raises(ValueError, match="alpha"):
        QueryEngine(kb, index="ivf", alpha=-1.0, device="cpu")
    with pytest.raises(ValueError, match="map"):
        QueryEngine(kb, index="ivf-sharded", scoring_path="kernel",
                    device="cpu")
    with pytest.raises(ValueError, match="shards"):
        build_sharded_retrieve(("cpu",), ("d",), 10, 3)
    flat = QueryEngine(kb, device="cpu")
    assert flat.ivf is None and flat.index_stats()["n_clusters"] == 0
    with pytest.raises(ValueError, match="disagrees"):
        Retriever(kb, alpha=0.5, engine=flat)


# --------------------------------------------------------------------------
# across packages: one trained state, both engines
# --------------------------------------------------------------------------

def _both_kbs(n_docs=120, dim=512, n_entities=6):
    port, entities = _kb(KnowledgeBase, n_docs=n_docs, dim=dim,
                         n_entities=n_entities)
    ref, _ = _kb(RefKB, n_docs=n_docs, dim=dim, n_entities=n_entities)
    return port, ref, entities


def test_jax_container_is_adopted_by_the_port_without_retrain(tmp_path):
    _, ref_kb, entities = _both_kbs()
    ref = RefEngine(ref_kb, index="ivf", nprobe=2)
    assert ref.retrains == 1
    ref_kb.save(str(tmp_path / "jax.ragdb"))
    kb = KnowledgeBase.load(str(tmp_path / "jax.ragdb"))
    port = _eng(kb, index="ivf", nprobe=2)
    assert port.retrains == 0 and port.refresh().no_op
    for name in ("centroids", "sig_union", "radius", "assign"):
        np.testing.assert_array_equal(getattr(port.ivf, name),
                                      getattr(ref.ivf, name))
    assert_bit_identical(ref.query_batch(_queries(entities), k=5),
                         port.query_batch(_queries(entities), k=5))


def test_port_container_is_adopted_by_jax_without_retrain(tmp_path):
    kb, _, entities = _both_kbs()
    port = _eng(kb, index="ivf", nprobe=2)
    assert port.retrains == 1
    kb.save(str(tmp_path / "port.ragdb"))
    ref_kb = RefKB.load(str(tmp_path / "port.ragdb"))
    ref = RefEngine(ref_kb, index="ivf", nprobe=2)
    assert ref.retrains == 0
    np.testing.assert_array_equal(ref.ivf.centroids, port.ivf.centroids)
    assert_bit_identical(ref.query_batch(_queries(entities), k=5),
                         port.query_batch(_queries(entities), k=5))
    # the delta journal carries a retrained state across too
    for i in range(40):
        kb.add_text(f"doc_{i:05d}.txt", f"churned content {i} QQ-{i:04d}")
    port.refresh()
    assert port.retrains == 2
    kb.save_delta(str(tmp_path / "port.ragdb"))
    ref2 = RefEngine(RefKB.load(str(tmp_path / "port.ragdb")), index="ivf",
                     nprobe=2)
    assert ref2.retrains == 0
    np.testing.assert_array_equal(ref2.ivf.centroids, port.ivf.centroids)


@pytest.mark.parametrize("guarantee,nprobe", [("probe", 1), ("probe", 3),
                                              ("exact", 1)])
@pytest.mark.parametrize("beta", [1.0, 0.0])
def test_same_state_gives_the_jax_engines_results(guarantee, nprobe, beta):
    """Same adopted state, same probe order (the host f64 probe plane is
    the JAX package's code), same candidates, map-path bits."""
    kb, ref_kb, entities = _both_kbs()
    ref = RefEngine(ref_kb, beta=beta, index="ivf", guarantee=guarantee,
                    nprobe=nprobe)
    kb.set_index_state(ref_kb.index_state)
    port = _eng(kb, beta=beta, index="ivf", guarantee=guarantee,
                nprobe=nprobe)
    assert port.retrains == 0
    queries = _queries(entities)
    for b in (1, 4, len(queries)):
        batch = queries[:b]
        assert_bit_identical(ref.query_batch(batch, k=5),
                             port.query_batch(batch, k=5),
                             label=f"{guarantee} nprobe={nprobe} b={b}")
        rs, ps = ref.index_stats(), port.index_stats()
        for key in ("n_clusters", "probed_fraction", "clusters_probed",
                    "candidate_rows", "rounds"):
            assert rs[key] == ps[key], (key, rs[key], ps[key])


def test_same_state_alpha_not_one_within_one_fma():
    """At α ≠ 1 XLA CPU fuses α·cos + β·ind into one FMA (ROADMAP
    Queue 3 item 1): ids equal, scores within rtol 1e-6."""
    kb, ref_kb, entities = _both_kbs()
    ref = RefEngine(ref_kb, alpha=0.7, beta=1.3, index="ivf", nprobe=2)
    kb.set_index_state(ref_kb.index_state)
    port = _eng(kb, alpha=0.7, beta=1.3, index="ivf", nprobe=2)
    assert port.retrains == 0
    assert_bit_identical(ref.query_batch(_queries(entities), k=5),
                         port.query_batch(_queries(entities), k=5),
                         score_rtol=1e-6, score_atol=1e-7)


def test_ivf_state_ledger_bytes_equal():
    kb, ref_kb, _ = _both_kbs()
    ref = RefEngine(ref_kb, index="ivf")
    kb.set_index_state(ref_kb.index_state)
    port = _eng(kb, index="ivf")
    got, want = measure_engine_planes(port), ref_planes(ref)
    assert got["ivf_state"] == want["ivf_state"] > 0
    assert got["doc_matrix"] == want["doc_matrix"]


def test_snapshot_pins_the_generations_ivf_index():
    from repro_torch.serving import EngineSnapshot, ServingRuntime

    kb, entities = _kb(n_docs=60)
    with ServingRuntime(kb, index="ivf", nprobe=2, guarantee="exact",
                        device="cpu", scoring_path="map") as runtime:
        snap = runtime.snapshots.current
        assert isinstance(snap, EngineSnapshot)
        assert snap.ivf is runtime.engine.ivf and snap.nprobe == 2
        got = runtime.query_batch(list(entities), k=3)
        assert runtime.index_stats()["index"] == "ivf"
    assert_bit_identical(_eng(kb).query_batch(list(entities), k=3), got)


@pytest.mark.parametrize("prefilter", [False, True])
def test_retriever_matches_jax(prefilter):
    kb, ref_kb, entities = _both_kbs(n_docs=100)
    port = Retriever(kb, prefilter=prefilter, scoring_path="map",
                     device="cpu")
    ref = RefRetriever(ref_kb, prefilter=prefilter, scoring_path="map")
    for q in list(entities) + ["quarterly forecast", "invoice payment"]:
        got, want = port.query(q, k=5), ref.query(q, k=5)
        assert [r.doc_id for r in got] == [r.doc_id for r in want], q
        assert [r.score for r in got] == [r.score for r in want], q


def test_sharded_oracle_matches_jax():
    from repro.core.retrieval import single_device_reference as ref_oracle

    rng = np.random.default_rng(4)
    dv = rng.normal(size=(37, 64)).astype(np.float32)
    ds = rng.integers(0, 2**31, size=(37, 8)).astype(np.int32)
    qv = rng.normal(size=(3, 64)).astype(np.float32)
    qs = (ds[:3] & ds[1:4]).astype(np.int32)
    dvp, dsp, n = pad_corpus(dv, ds, 4)
    assert dvp.shape == (40, 64) and n == 37
    pv, pi = single_device_reference(dvp, dsp, qv, qs, n, 6)
    jv, ji = ref_oracle(dvp, dsp, qv, qs, n, 6)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-5)
    v, i = _stable_top_k(torch.tensor([[1.0, 2.0, 2.0, 0.5]]),
                         torch.tensor([[3, 2, 1, 0]], dtype=torch.int32), 3)
    assert i.tolist() == [[1, 2, 3]] and v.tolist() == [[2.0, 2.0, 1.0]]


# --------------------------------------------------------------------------
# serve.py, both packages
# --------------------------------------------------------------------------

_RESULT = re.compile(r"^  ([* ]) (\S+)\s+score=(\S+)$")


def _printed(out):
    rows, cur = {}, None
    for line in out.splitlines():
        if line.startswith("Q: "):
            cur = line[3:].rsplit("  [generation", 1)[0]
            rows[cur] = []
        elif cur is not None and (m := _RESULT.match(line)):
            rows[cur].append((m.group(2), m.group(1) == "*", m.group(3)))
    return rows


def test_serve_ivf_exact_prints_the_jax_serve_ids_and_scores(tmp_path):
    docs, entities = make_corpus(n_docs=60, n_entities=3, seed=2)
    corpus = str(tmp_path / "corpus")
    write_corpus_dir(corpus, docs)
    args = ["--corpus", corpus, "--dim", "1024", "--top-k", "3",
            "--max-batch", "4", "--max-new-tokens", "0", "--index", "ivf",
            "--guarantee", "exact", "--metrics", "--queries",
            *entities, "other query", "invoice payment"]
    outs = []
    for main, extra in ((serve.main, ["--device", "cpu"]),
                        (ref_serve.main, [])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(args + extra) == 0
        outs.append(buf.getvalue())
    got, want = _printed(outs[0]), _printed(outs[1])
    assert got == want and len(got) == 5
    for code, doc in entities.items():
        assert got[code][0][:2] == (f"doc_{doc:05d}.txt", True)
    assert "index: ivf" in outs[0]
    assert "index stats: index=ivf" in outs[0]
    assert "retrains=1" in outs[0] and "rounds=" in outs[0]


def test_serve_rejects_the_unported_sharded_index(tmp_path):
    """The sharded plane is ported: ``--index ivf-sharded`` serves the
    ids and scores of the JAX package's serve.py, and rejects an
    explicit scoring path other than map as that serve.py does;
    ``--index ivf --shards 2`` ignores ``--shards``, as it does."""
    docs, entities = make_corpus(n_docs=40, n_entities=2, seed=5)
    corpus = str(tmp_path / "corpus")
    write_corpus_dir(corpus, docs)
    base = ["--corpus", corpus, "--dim", "512", "--top-k", "3",
            "--max-new-tokens", "0", "--queries", *entities, "other query"]
    with pytest.raises(ValueError, match="map"):
        serve.main(base + ["--device", "cpu", "--index", "ivf-sharded",
                           "--scoring-path", "gemm"])
    outs = []
    for main, extra in (
            (serve.main, ["--device", "cpu", "--index", "ivf",
                          "--shards", "2"]),
            (ref_serve.main, ["--index", "ivf", "--shards", "2"]),
            (serve.main, ["--device", "cpu", "--index", "ivf-sharded"]),
            (ref_serve.main, ["--index", "ivf-sharded"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(base + extra) == 0
        outs.append(buf.getvalue())
    got = [_printed(o) for o in outs]
    assert got[0] == got[1] and got[2] == got[3] and len(got[0]) == 3
    assert "shards: 1 logical" in outs[2]


def test_index_plane_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import repro_torch.index, repro_torch.index.ivf\n"
        "import repro_torch.core.retrieval, repro_torch.kernels.topk.ops\n"
        "import repro_torch.kernels.hsf_score.ops\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
