"""The port's multi-device retrieval planes on the CPU
(`repro_torch.launch.mesh`, `core.retrieval.build_sharded_retrieve`,
`index.sharded`, `QueryEngine(index="ivf-sharded")`, the row-sharded
recsys lookup), against the JAX package on the same inputs.

- ``build_sharded_retrieve`` (gemm and kernel legs) is held to the JAX
  package's 8-device ``shard_map`` mesh, run in one subprocess with
  ``--xla_force_host_platform_device_count=8`` (tests/test_sharded.py's
  helper): ids exactly, scores within 1e-6 (gemm) and 1e-5 (kernel).
- The contracts of tests/test_index_sharded.py run through the port's
  sharded plane at S ∈ {1, 2, 3, 4, 8} logical shards and are held bit
  for bit to the flat map path of both packages; the JAX package's
  sharded plane on a real 4-device mesh gives the port's logical S = 4
  bits too.  Containers carry the sharded state across packages and
  shard counts with no retrain.
- The local rerank in query chunks equals one query at a time bit for
  bit; the row-sharded lookup equals the unsharded one and the JAX
  package's sharded lookup.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from conftest import assert_bit_identical
from repro.core.engine import QueryEngine as RefEngine
from repro.core.ingest import KnowledgeBase as RefKB
from repro.core.retrieval import single_device_reference as ref_oracle
from repro.data.corpus import make_corpus, write_corpus_dir
from repro.index import partition_clusters as ref_partition
from repro.launch import serve as ref_serve
from repro.obs.ledger import measure_engine_planes as ref_planes
from repro_torch.core import hsf
from repro_torch.core import signature as sigmod
from repro_torch.core.engine import QueryEngine, pack_query_arrays
from repro_torch.core.ingest import KnowledgeBase
from repro_torch.core.retrieval import (
    build_sharded_retrieve,
    pad_corpus,
    shard_corpus,
    single_device_reference,
)
from repro_torch.index import ShardedIVFIndex, partition_clusters
from repro_torch.index import sharded as sharded_mod
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import serve
from repro_torch.launch import steps
from repro_torch.models.recsys import embedding
from repro_torch.obs.ledger import measure_engine_planes

from test_sharded import run_with_devices
from test_torch_index import _printed

# the suite runs test files in parallel workers: keep this file's torch
# ops on one thread so they do not starve the other workers
torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SHARD_COUNTS = (1, 2, 3, 4, 8)


def _kb(cls=KnowledgeBase, n_docs=80, dim=512, n_entities=6, seed=0):
    docs, entities = make_corpus(n_docs=n_docs, n_entities=n_entities,
                                 seed=seed)
    kb = cls(dim=dim)
    for i, d in enumerate(docs):
        kb.add_text(f"doc_{i:05d}.txt", d)
    return kb, list(entities)


def _eng(kb, **kw):
    return QueryEngine(kb, scoring_path="map", device="cpu", **kw)


def _sharded(kb, n_shards, **kw):
    return _eng(kb, index="ivf-sharded", guarantee="exact",
                n_shards=n_shards, **kw)


def _pack(kb, texts):
    pairs = [
        (kb.vectorizer.query_vector(t),
         sigmod.query_signature(t, width_words=kb.sig_words))
        for t in texts
    ]
    return pack_query_arrays(pairs, kb.vectorizer.dim, kb.sig_words)


# --------------------------------------------------------------------------
# the JAX package's real mesh legs, one subprocess for the whole file
# --------------------------------------------------------------------------

_MESH_LEGS = """
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    assert jax.device_count() == 8, jax.device_count()
    from repro.core import retrieval
    from repro.core.engine import QueryEngine
    from repro.core.ingest import KnowledgeBase
    from repro.data.corpus import make_corpus
    from repro.models.recsys import embedding as E

    out = {}
    mesh = jax.make_mesh((4, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,)*2)
    for seed, use_kernel in ((1, False), (2, True)):
        rng = np.random.default_rng(seed)
        n, D, W = 173, 512, 128
        vecs = rng.normal(size=(n, D)).astype(np.float32)
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
        sigs = rng.integers(0, 2**31, size=(n, W)).astype(np.int32)
        pv, ps, nd = retrieval.pad_corpus(vecs, sigs, 8)
        qv = rng.normal(size=(5, D)).astype(np.float32)
        qs = np.stack([sigs[i] for i in [0, 50, 100, 150, 172]]).astype(
            np.int32)
        ret = retrieval.build_sharded_retrieve(
            mesh, ("data", "model"), nd, k=7, use_kernel=use_kernel)
        sh = NamedSharding(mesh, P(("data", "model"), None))
        vals, ids = jax.jit(ret)(jax.device_put(pv, sh),
                                 jax.device_put(ps, sh),
                                 jnp.asarray(qv), jnp.asarray(qs))
        out[f"retrieve_{use_kernel}"] = {
            "pv": pv.tolist(), "ps": ps.tolist(), "n": nd,
            "qv": qv.tolist(), "qs": qs.tolist(),
            "vals": np.asarray(vals).tolist(), "ids": np.asarray(ids).tolist()}

    docs, ents = make_corpus(n_docs=61, n_entities=4, seed=7)
    kb = KnowledgeBase(dim=512)
    for i, d in enumerate(docs):
        kb.add_text(f"doc_{i:05d}.txt", d)
    eng = QueryEngine(kb, scoring_path="map", index="ivf-sharded",
                      guarantee="exact", n_shards=4)
    assert eng.ivf.mesh is not None
    rows = []
    for res in eng.query_batch(list(ents) + ["misc words"], k=5):
        rows.append([[r.doc_id, r.score, r.cosine, r.boosted] for r in res])
    out["engine_mesh4"] = {"queries": list(ents) + ["misc words"],
                           "rows": rows}

    lmesh = jax.make_mesh((2, 4), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,)*2)
    vocabs = (100, 200, 50)
    table = E.init_tables(jax.random.PRNGKey(0), vocabs, 16)["table"]
    offs = E.field_offsets(vocabs)
    idx = np.random.default_rng(0).integers(0, 50, size=(24, 3)).astype(
        np.int32)
    q = np.random.default_rng(1).normal(size=(16,)).astype(np.float32)
    with E.sharding_ctx(lmesh, "model"):
        rows = jax.jit(lambda t, i: E.lookup(t, offs, i))(table,
                                                           jnp.asarray(idx))
        scores = E.lookup_scores(table, jnp.asarray(idx).reshape(-1) +
                                 jnp.tile(offs, 24), jnp.asarray(q))
    out["lookup"] = {"table": np.asarray(table).tolist(),
                     "idx": idx.tolist(), "q": q.tolist(),
                     "rows": np.asarray(rows).tolist(),
                     "scores": np.asarray(scores).tolist()}
    with open(OUT, "w") as f:
        json.dump(out, f)
    print("OK")
"""


@pytest.fixture(scope="module")
def mesh_legs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh") / "legs.json")
    run_with_devices(f"OUT = {path!r}\n" + _MESH_LEGS.replace(
        "\n    ", "\n"), n_devices=8)
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_build_sharded_retrieve_matches_the_jax_mesh(mesh_legs, use_kernel):
    leg = mesh_legs[f"retrieve_{use_kernel}"]
    pv = np.asarray(leg["pv"], np.float32)
    ps = np.asarray(leg["ps"], np.int32)
    qv = np.asarray(leg["qv"], np.float32)
    qs = np.asarray(leg["qs"], np.int32)
    mesh = meshlib.make_shard_mesh(8, "cpu")
    ret = build_sharded_retrieve(mesh, meshlib.all_axes(mesh), leg["n"],
                                 k=7, use_kernel=use_kernel)
    vals, ids = ret(*(torch.from_numpy(x) for x in (pv, ps, qv, qs)))
    want = (np.asarray(leg["vals"], np.float32),
            np.asarray(leg["ids"], np.int32))
    tol = dict(score_rtol=1e-5, score_atol=1e-6) if use_kernel \
        else dict(score_rtol=1e-6)
    assert_bit_identical((vals.numpy(), ids.numpy()), want, **tol)
    rv, ri = single_device_reference(pv, ps, qv, qs, leg["n"], 7)
    assert_bit_identical((vals, ids), (rv, ri), **tol)


def test_the_jax_mesh_engine_gives_the_ports_logical_shards(mesh_legs):
    """The JAX package's sharded plane on a real 4-device mesh and the
    port's 4 logical shards: the same ids, score and cosine bits."""
    leg = mesh_legs["engine_mesh4"]
    docs, _ = make_corpus(n_docs=61, n_entities=4, seed=7)
    kb = KnowledgeBase(dim=512)
    for i, d in enumerate(docs):
        kb.add_text(f"doc_{i:05d}.txt", d)
    eng = _sharded(kb, 4)
    assert eng.ivf.mesh is None and eng.ivf.placement == "logical"
    got = [[[r.doc_id, r.score, r.cosine, r.boosted] for r in res]
           for res in eng.query_batch(leg["queries"], k=5)]
    assert got == leg["rows"]


def test_row_sharded_lookup_matches_the_jax_mesh(mesh_legs):
    leg = mesh_legs["lookup"]
    table = torch.tensor(leg["table"], dtype=torch.float32)
    idx = torch.tensor(leg["idx"], dtype=torch.int32)
    q = torch.tensor(leg["q"], dtype=torch.float32)
    offs = embedding.field_offsets((100, 200, 50))
    flat = (idx + offs[None, :]).reshape(-1)
    plain = embedding.lookup(table, offs, idx)
    plain_scores = embedding.lookup_scores(table, flat, q)
    with embedding.sharding_ctx(meshlib.make_shard_mesh(4, "cpu")):
        rows = embedding.lookup(table, offs, idx)
        scores = embedding.lookup_scores(table, flat, q)
    assert torch.equal(rows, plain) and torch.equal(scores, plain_scores)
    np.testing.assert_array_equal(rows.numpy(),
                                  np.asarray(leg["rows"], np.float32))
    np.testing.assert_allclose(scores.numpy(),
                               np.asarray(leg["scores"], np.float32),
                               rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# mesh and build_sharded_retrieve, in the port
# --------------------------------------------------------------------------

def test_make_shard_mesh_and_placement():
    mesh = meshlib.make_shard_mesh(4, "cpu")
    assert mesh == (torch.device("cpu"),) * 4
    assert meshlib.placement(mesh) == "logical"
    assert meshlib.placement((torch.device("cuda", 0),
                              torch.device("cuda", 1))) == "mesh"
    assert meshlib.placement(meshlib.make_shard_mesh(1, "cpu")) == "logical"
    assert meshlib.default_shards("cpu") == 1
    assert meshlib.all_axes(mesh) == ("shards",)
    with pytest.raises(ValueError, match="n_shards"):
        meshlib.make_shard_mesh(0, "cpu")


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_build_sharded_retrieve_ragged_corpus(n_shards, use_kernel):
    """A corpus that does not divide: the last shards mask their padding
    (the kernel leg through its host ``n_valid``, 0 on a shard of
    padding alone); ids equal the oracle's, and the kernel leg's
    unfillable slots never surface."""
    rng = np.random.default_rng(n_shards)
    n, d, w = 19, 64, 8
    dv = rng.normal(size=(n, d)).astype(np.float32)
    dv /= np.linalg.norm(dv, axis=1, keepdims=True)
    ds = rng.integers(-2**31, 2**31, size=(n, w)).astype(np.int32)
    qv = rng.normal(size=(3, d)).astype(np.float32)
    qs = (ds[:3] & ds[1:4]).astype(np.int32)
    pv, ps, nd = pad_corpus(dv, ds, n_shards)
    mesh = meshlib.make_shard_mesh(n_shards, "cpu")
    for k in (1, 5, 19):
        ret = build_sharded_retrieve(mesh, ("shards",), nd, k=k,
                                     use_kernel=use_kernel)
        vals, ids = ret(*(torch.from_numpy(x) for x in (pv, ps, qv, qs)))
        rv, ri = single_device_reference(pv, ps, qv, qs, nd, k)
        assert_bit_identical((vals, ids), (rv, ri), score_rtol=1e-5,
                             score_atol=1e-6, label=f"S={n_shards} k={k}")
        assert int(ids.max()) < nd
        jv, ji = ref_oracle(pv, ps, qv, qs, nd, k)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))


def test_build_sharded_retrieve_takes_per_shard_blocks_and_checks():
    rng = np.random.default_rng(0)
    dv = torch.from_numpy(rng.normal(size=(16, 32)).astype(np.float32))
    ds = torch.from_numpy(rng.integers(0, 2**31, size=(16, 4)).astype(
        np.int32))
    qv, qs = dv[:2].clone(), ds[:2].clone()
    mesh = meshlib.make_shard_mesh(4, "cpu")
    ret = build_sharded_retrieve(mesh, ("shards",), 16, k=3)
    blocks = shard_corpus(dv, ds, mesh)
    assert blocks[0][1].data_ptr() == dv[4:8].data_ptr()  # views, no copy
    a = ret(dv, ds, qv, qs)
    b = ret(*blocks, qv, qs)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="pad_corpus"):
        ret(dv[:15], ds[:15], qv, qs)
    with pytest.raises(ValueError, match="shards"):
        build_sharded_retrieve(mesh, ("data", "model"), 16, k=3)


# --------------------------------------------------------------------------
# the sharded plane ≡ flat, bit for bit, in both packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_docs", [7, 83])  # 83 ∤ 2,3,4,8; 7 < clusters
@pytest.mark.parametrize("beta", [1.0, 0.0])  # β=0: pure cosine ranking
def test_sharded_exact_bit_identical_to_flat_sweep(n_docs, beta):
    n_ent = min(4, max(1, n_docs // 4))
    kb, entities = _kb(n_docs=n_docs, n_entities=n_ent)
    ref_kb, _ = _kb(RefKB, n_docs=n_docs, n_entities=n_ent)
    queries = (entities + [f"lookup {c} record" for c in entities[:2]]
               + ["quarterly forecast", "unrelated text", ""])
    flat = _eng(kb, beta=beta)
    ref_flat = RefEngine(ref_kb, beta=beta, scoring_path="map")
    ref_sh = RefEngine(ref_kb, beta=beta, scoring_path="map",
                       index="ivf-sharded", guarantee="exact", nprobe=1,
                       n_shards=3)
    want = {}
    for b in (1, 3, 8):
        batch = (queries * 3)[:b]
        want[b] = flat.query_batch(batch, k=5)
        assert_bit_identical(ref_flat.query_batch(batch, k=5), want[b])
        assert_bit_identical(ref_sh.query_batch(batch, k=5), want[b],
                             label=f"JAX S=3 b={b}")
    for shards in SHARD_COUNTS:
        sh = _sharded(kb, shards, beta=beta, nprobe=1)
        for b in (1, 3, 8):
            assert_bit_identical(
                want[b], sh.query_batch((queries * 3)[:b], k=5),
                label=f"n_docs={n_docs} beta={beta} S={shards} b={b}")


def test_sharded_exact_k_exceeds_n_clamps():
    kb, entities = _kb(n_docs=23, n_entities=3)
    ref_kb, _ = _kb(RefKB, n_docs=23, n_entities=3)
    queries = entities[:2] + ["filler text"]
    got = _sharded(kb, 4).query_batch(queries, k=500)
    assert all(len(r) == kb.n_docs for r in got)  # clamped, full ranking
    assert_bit_identical(_eng(kb).query_batch(queries, k=500), got)
    assert_bit_identical(
        RefEngine(ref_kb, scoring_path="map").query_batch(queries, k=500),
        got)


def test_sharded_exact_with_duplicate_ties():
    """12 identical docs tie exactly at the k-th score; the merge must
    reproduce the flat scan's global-id tie order when the tied rows
    land on different shards."""
    kbs = []
    for cls in (KnowledgeBase, RefKB):
        kb = cls(dim=512)
        for i in range(12):
            kb.add_text(f"dup_{i:02d}", "identical tie content INV-7777")
        for i in range(20):
            kb.add_text(f"filler_{i:02d}", f"unrelated filler number {i}")
        kbs.append(kb)
    want = RefEngine(kbs[1], scoring_path="map").query_batch(["INV-7777"],
                                                             k=6)
    assert len({r.score for r in want[0]}) == 1  # genuinely tied
    assert_bit_identical(want, _eng(kbs[0]).query_batch(["INV-7777"], k=6))
    for shards in (2, 3, 4, 8):
        assert_bit_identical(
            want, _sharded(kbs[0], shards, nprobe=1).query_batch(
                ["INV-7777"], k=6), label=f"S={shards}")


def test_degenerate_partition_all_clusters_on_one_shard():
    """Every cluster owned by shard 0, three empty shards: the empty
    shards contribute only sentinel rows, which the merge drops."""
    kb, entities = _kb(n_docs=60)
    eng = _sharded(kb, 4)
    base = eng.ivf.base
    deg = ShardedIVFIndex.from_base(
        base, eng.doc_vecs, eng.doc_sigs, n_shards=4,
        shard_of_cluster=np.zeros(base.n_clusters, np.int32))
    assert deg.shard_sizes()[1:] == [0, 0, 0]
    queries = entities[:3] + ["plain filler prose"]
    qv, qs = _pack(kb, queries)
    kw = dict(b=len(queries), k=5, nprobe=2, guarantee="exact",
              scoring_path="map", alpha=eng.alpha, beta=eng.beta)
    v1, i1, *_ = deg.search(eng.doc_vecs, eng.doc_sigs, qv, qs, **kw)
    v2, i2, *_ = eng.ivf.search(eng.doc_vecs, eng.doc_sigs, qv, qs, **kw)
    assert_bit_identical((v1, i1), (v2, i2))
    with pytest.raises(ValueError, match="shard_of_cluster"):
        ShardedIVFIndex.from_base(base, eng.doc_vecs, eng.doc_sigs,
                                  n_shards=2, shard_of_cluster=np.full(
                                      base.n_clusters, 2, np.int32))


def test_partition_clusters_equals_the_jax_package():
    rng = np.random.default_rng(0)
    sizes = rng.integers(1, 200, size=37).astype(np.int64)
    for n_shards in (1, 2, 3, 4, 8):
        soc = partition_clusters(sizes, n_shards)
        np.testing.assert_array_equal(soc, ref_partition(sizes, n_shards))
        assert soc.shape == (37,) and soc.dtype == np.int32
        loads = np.bincount(soc, weights=sizes, minlength=n_shards)
        # greedy LPT bound: no shard exceeds mean + max item
        assert loads.max() <= sizes.sum() / n_shards + sizes.max()
    soc = partition_clusters(np.array([5, 3]), 8)
    np.testing.assert_array_equal(soc, ref_partition(np.array([5, 3]), 8))


def test_sharded_engine_validation_errors():
    kb, _ = _kb(n_docs=10, dim=256, n_entities=2)
    with pytest.raises(ValueError, match="n_shards"):
        QueryEngine(kb, index="flat", n_shards=2, device="cpu")
    with pytest.raises(ValueError, match="n_shards"):
        QueryEngine(kb, index="ivf-sharded", n_shards=0, device="cpu")
    with pytest.raises(ValueError, match="map"):
        QueryEngine(kb, index="ivf-sharded", scoring_path="gemm",
                    device="cpu")
    with pytest.raises(ValueError, match="map"):
        QueryEngine(kb, index="ivf-sharded", use_kernel=True, device="cpu")
    with pytest.raises(ValueError, match="alpha"):
        QueryEngine(kb, index="ivf-sharded", beta=-1.0, device="cpu")
    auto = QueryEngine(kb, index="ivf-sharded", device="cpu")
    assert auto.scoring_path == "map" and auto.n_shards == 1


def test_sharded_index_stats_equal_the_jax_engines():
    """Same adopted state: the port's and the JAX package's sharded
    engines probe, widen and scan the same, and report it the same."""
    kb, entities = _kb(n_docs=90)
    ref_kb, _ = _kb(RefKB, n_docs=90)
    for guarantee, nprobe in (("exact", 1), ("probe", 2)):
        ref = RefEngine(ref_kb, scoring_path="map", index="ivf-sharded",
                        guarantee=guarantee, nprobe=nprobe, n_shards=4)
        kb.set_index_state(ref_kb.index_state)
        port = _eng(kb, index="ivf-sharded", guarantee=guarantee,
                    nprobe=nprobe, n_shards=4)
        assert port.retrains == 0
        np.testing.assert_array_equal(port.ivf.shard_of_cluster,
                                      ref.ivf.shard_of_cluster)
        assert port.ivf.shard_sizes() == ref.ivf.shard_sizes()
        assert port.ivf.block_len == ref.ivf.block_len
        queries = entities[:3] + ["quarterly forecast"]
        assert_bit_identical(ref.query_batch(queries, k=4),
                             port.query_batch(queries, k=4), label=guarantee)
        rs, ps = ref.index_stats(), port.index_stats()
        for key in ("index", "n_clusters", "probed_fraction",
                    "clusters_probed", "candidate_rows", "rounds",
                    "n_shards"):
            assert rs[key] == ps[key], (guarantee, key, rs[key], ps[key])
        assert ps["n_shards"] == 4 and ps["merge_seconds"] >= 0.0
        assert 0.0 < ps["probed_fraction"] <= 1.0
        assert measure_engine_planes(port)["ivf_state"] \
            == ref_planes(ref)["ivf_state"] > 0


# --------------------------------------------------------------------------
# the chunked local rerank
# --------------------------------------------------------------------------

def test_chunked_rerank_equals_one_query_at_a_time(monkeypatch):
    rng = np.random.default_rng(3)
    mat = torch.from_numpy(rng.normal(size=(37, 100)).astype(np.float32))
    vecs = torch.from_numpy(rng.normal(size=(6, 100)).astype(np.float32))
    batched = sharded_mod.batched_rowdot(mat, vecs)
    for i in range(6):
        assert torch.equal(batched[i], hsf.stable_rowdot(mat, vecs[i])), i
    sigs = torch.from_numpy(rng.integers(-2**31, 2**31, size=(37, 4)).astype(
        np.int32))
    qs = sigs[:6] & sigs[1:7]
    gids = torch.arange(100, 137, dtype=torch.int32)
    whole = sharded_mod._shard_topk_core(mat, sigs, gids, vecs, qs, kk=5,
                                         alpha=1.0, beta=1.0)
    # a budget of one query's products per chunk: six chunks
    monkeypatch.setattr(sharded_mod, "RERANK_CHUNK_BYTES", 4 * 37 * 100)
    chunked = sharded_mod._shard_topk_core(mat, sigs, gids, vecs, qs, kk=5,
                                           alpha=1.0, beta=1.0)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)
    for i in range(6):
        one = sharded_mod._shard_topk_core(mat, sigs, gids, vecs[i:i + 1],
                                           qs[i:i + 1], kk=5, alpha=1.0,
                                           beta=1.0)
        for a, b in zip(whole, one):
            assert torch.equal(a[i], b[0]), i
    scores = hsf.stable_rowdot(mat, vecs[0]) + hsf.containment(sigs, qs[0])
    v, i = hsf.top_k(scores[None], 5)
    assert torch.equal(whole[0][0], v[0])
    assert torch.equal(whole[1][0], gids[i[0]])


# --------------------------------------------------------------------------
# incremental maintenance: dirty rows route to their owning shard
# --------------------------------------------------------------------------

def test_sharded_restack_maintenance_parity(tmp_path):
    """touch 2 / delete 1 / add 2 through kb.sync: the restacked plane
    stays bit-identical to the flat engines of both packages."""
    docs, ents = make_corpus(n_docs=90, n_entities=6, seed=3)
    entities = list(ents)
    src = str(tmp_path / "corpus")
    write_corpus_dir(src, docs)
    kbs = [cls(dim=512) for cls in (KnowledgeBase, KnowledgeBase, RefKB)]
    for kb in kbs:
        kb.sync(src)
    flat = _eng(kbs[0])
    sharded = _sharded(kbs[1], 4)
    ref = RefEngine(kbs[2], scoring_path="map")
    queries = entities[:3] + ["quarterly forecast"]
    assert_bit_identical(flat.query_batch(queries, k=6),
                         sharded.query_batch(queries, k=6), label="cold")

    for i in (4, 9):
        with open(f"{src}/doc_{i:05d}.txt", "a") as f:
            f.write(f" appended about {entities[1]}")
    os.unlink(f"{src}/doc_00010.txt")
    with open(f"{src}/doc_90000.txt", "w") as f:
        f.write(f"entirely new corpus member about {entities[2]} QQ-7777")
    with open(f"{src}/doc_90001.txt", "w") as f:
        f.write("another fresh arrival ZZ-8888 plain prose")
    for kb in kbs:
        st = kb.sync(src)
        assert (st.updated, st.removed, st.added) == (2, 1, 2)

    q2 = queries + ["QQ-7777 fresh", f"{entities[1]} appended"]
    got = sharded.query_batch(q2, k=6)
    assert_bit_identical(flat.query_batch(q2, k=6), got, label="restacked")
    assert_bit_identical(ref.query_batch(q2, k=6), got, label="JAX flat")
    assert len(sharded.ivf.base.assign) == kbs[1].n_docs


def test_sharded_inplace_rewrite_reweighted_parity():
    """An in-place rewrite moves idf → every doc vector is rebuilt, so
    the per-shard blocks regather in full; parity after the rewrite."""
    kb_f, entities = _kb(n_docs=50, seed=5)
    kb_s, _ = _kb(n_docs=50, seed=5)
    flat = _eng(kb_f)
    sharded = _sharded(kb_s, 4)
    queries = entities[:3]
    assert_bit_identical(flat.query_batch(queries, k=5),
                         sharded.query_batch(queries, k=5), label="cold")
    old = sharded.ivf
    for kb in (kb_f, kb_s):  # same id, brand-new terms → idf moves
        kb.add_text("doc_00007.txt", "rewritten with a new code RW-4242")
    q2 = queries + ["RW-4242"]
    got = sharded.query_batch(q2, k=5)
    assert_bit_identical(flat.query_batch(q2, k=5), got, label="rewritten")
    assert got[-1][0].doc_id == "doc_00007.txt"
    assert sharded.ivf is not old  # a new plane; the pinned one untouched


def test_sharded_reassign_patches_a_clone_and_regathers_crossed_shards():
    """The O(U) path with idf held still: a patched row lands in a clone
    of its shard's block (the old plane keeps its bits), rows that move
    across shards regather both shards, and the plane equals one built
    from scratch over the same state."""
    kb, _ = _kb(n_docs=64)
    eng = _sharded(kb, 4)
    old = eng.ivf
    dv, ds = eng.doc_vecs, eng.doc_sigs
    before = [b.clone() for b in old.dv_blocks]
    soc, assign = old.shard_of_cluster, old.assign
    # row 0 moves onto the centroid of a cluster of another shard; a row
    # of a third shard gets its own centroid as new content and stays
    a = int(soc[assign[0]])
    t0 = int(np.nonzero(soc != a)[0][0])
    b = int(soc[t0])
    keep = int(np.nonzero((soc[assign] != a) & (soc[assign] != b))[0][0])
    c = int(soc[assign[keep]])
    rows = np.array([0, keep], np.int32)
    new_vecs = torch.from_numpy(old.centroids[[t0, assign[keep]]].copy())
    dv2 = dv.clone()
    dv2[torch.from_numpy(rows.astype(np.int64))] = new_vecs
    new = old.reassign(rows, new_vecs, ds[rows], dv2, ds)
    assert int(soc[new.assign[0]]) == b and new.assign[keep] == assign[keep]
    for s_old, s_before in zip(old.dv_blocks, before):
        assert torch.equal(s_old, s_before)  # the pinned plane unwritten
    assert new.dv_blocks[c] is not old.dv_blocks[c]  # a patched clone
    untouched = ({0, 1, 2, 3} - {a, b, c}).pop()
    assert new.dv_blocks[untouched] is old.dv_blocks[untouched]
    fresh = ShardedIVFIndex.from_base(new.base, dv2, ds, n_shards=4,
                                      shard_of_cluster=soc)
    assert new.shard_sizes() == fresh.shard_sizes()
    for a, b in zip(new.dv_blocks + new.ds_blocks + new.gid_blocks,
                    fresh.dv_blocks + fresh.ds_blocks + fresh.gid_blocks):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# persistence: delta journal → load → sharded adopt, across packages
# --------------------------------------------------------------------------

def _spy_kmeans(monkeypatch, module):
    calls = []
    orig = module.spherical_kmeans
    monkeypatch.setattr(module, "spherical_kmeans",
                        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    return calls


def test_sharded_state_survives_delta_load_and_adopts(tmp_path,
                                                      monkeypatch):
    import repro.index.ivf as ref_ivf_mod
    from repro_torch.index import ivf as ivf_mod

    kb, entities = _kb(n_docs=70, seed=4)
    eng = _sharded(kb, 4)
    p = str(tmp_path / "kb.ragdb")
    kb.save(p)
    kb.add_text("late.txt", f"late doc about {entities[0]} LATE-1212")
    eng.refresh()  # reassigns + writes the sharded index state back
    kb.save_delta(p, compact_ratio=None)

    calls = _spy_kmeans(monkeypatch, ivf_mod)
    ref_calls = _spy_kmeans(monkeypatch, ref_ivf_mod)
    kb2 = KnowledgeBase.load(p)
    assert int(kb2.index_state["n_shards"]) == 4
    queries = entities[:3] + ["LATE-1212"]
    want = eng.query_batch(queries, k=5)
    eng2 = _sharded(kb2, 4)
    assert_bit_identical(want, eng2.query_batch(queries, k=5))
    np.testing.assert_array_equal(eng2.ivf.shard_of_cluster,
                                  eng.ivf.shard_of_cluster)
    # the same state adopts across planes, shard counts and packages
    for kwargs in (dict(index="ivf"), dict(index="ivf-sharded", n_shards=2)):
        eng3 = _eng(KnowledgeBase.load(p), guarantee="exact", **kwargs)
        assert_bit_identical(want, eng3.query_batch(queries, k=5),
                             label=str(kwargs))
        ref = RefEngine(RefKB.load(p), scoring_path="map",
                        guarantee="exact", **kwargs)
        assert ref.retrains == 0
        assert_bit_identical(want, ref.query_batch(queries, k=5),
                             label=f"JAX {kwargs}")
    ref4 = RefEngine(RefKB.load(p), scoring_path="map", index="ivf-sharded",
                     guarantee="exact", n_shards=4)
    np.testing.assert_array_equal(ref4.ivf.shard_of_cluster,
                                  eng.ivf.shard_of_cluster)
    assert calls == [] and ref_calls == []


def test_jax_sharded_container_is_adopted_by_the_port(tmp_path,
                                                      monkeypatch):
    from repro_torch.index import ivf as ivf_mod

    ref_kb, entities = _kb(RefKB, n_docs=70, seed=6)
    ref = RefEngine(ref_kb, scoring_path="map", index="ivf-sharded",
                    guarantee="exact", n_shards=3)
    p = str(tmp_path / "jax.ragdb")
    ref_kb.save(p)
    calls = _spy_kmeans(monkeypatch, ivf_mod)
    port = _sharded(KnowledgeBase.load(p), 3)
    flat_ivf = _eng(KnowledgeBase.load(p), index="ivf", guarantee="exact")
    assert calls == [] and port.retrains == 0 and flat_ivf.retrains == 0
    np.testing.assert_array_equal(port.ivf.shard_of_cluster,
                                  ref.ivf.shard_of_cluster)
    queries = entities[:3] + ["plain prose"]
    want = ref.query_batch(queries, k=5)
    assert_bit_identical(want, port.query_batch(queries, k=5))
    assert_bit_identical(want, flat_ivf.query_batch(queries, k=5))


def test_sharded_stale_ids_sha_rejected(monkeypatch):
    """Persisted sharded state whose content digest no longer matches
    the live docs is rejected → retrain, never a silent adoption."""
    from repro_torch.index import ivf as ivf_mod

    kb, _ = _kb(n_docs=40)
    _eng(kb, index="ivf-sharded", n_shards=4)  # writes kb.index_state
    kb.add_text("doc_00012.txt", "rewritten with a brand new code PJ-3131")
    calls = _spy_kmeans(monkeypatch, ivf_mod)
    fresh = _sharded(kb, 4)
    assert calls == [1] and fresh.retrains == 1
    assert_bit_identical(fresh.query_batch(["PJ-3131"], k=4),
                         _eng(kb).query_batch(["PJ-3131"], k=4))


# --------------------------------------------------------------------------
# serving: the runtime under live sync, serve.py, the ragdb cell
# --------------------------------------------------------------------------

def test_serving_runtime_sharded_live_sync_bit_identical(tmp_path):
    """Reader threads against a ServingRuntime on the sharded plane while
    the writer syncs and publishes: every served result equals the flat
    engine over the KB frozen at its generation, bit for bit (no
    throughput floor: the count of requests is whatever the threads
    got through)."""
    from repro_torch.serving import ServingRuntime

    docs, ents = make_corpus(n_docs=60, n_entities=5, seed=2)
    entities = list(ents)
    src = str(tmp_path / "corpus")
    write_corpus_dir(src, docs)
    kb = KnowledgeBase(dim=512)
    kb.sync(src)
    runtime = ServingRuntime(kb, max_batch=4, flush_deadline=0.002,
                             scoring_path="map", index="ivf-sharded",
                             guarantee="exact", n_shards=4, device="cpu",
                             result_cache_size=0)  # force real scoring
    containers = {}

    def save_generation(gen):
        path = str(tmp_path / f"gen_{gen}.ragdb")
        kb.save(path, generation=gen)
        containers[gen] = path

    save_generation(runtime.generation)
    queries = entities + ["escalation runbook", "LIVE-7777"]
    served, lock = [], threading.Lock()
    with runtime:
        stop = threading.Event()

        def reader(rid):
            i = rid
            while not stop.is_set():
                q = queries[i % len(queries)]
                k = 3 if (i % 2) else 5
                i += 1
                res = runtime.submit(q, k=k).result(timeout=120)
                with lock:
                    served.append((q, k, res))

        threads = [threading.Thread(target=reader, args=(r,))
                   for r in range(3)]
        for t in threads:
            t.start()
        for rnd in range(4):
            with open(os.path.join(src, f"doc_{rnd:05d}.txt"), "a") as f:
                f.write(f" LIVE-7777 edit round {rnd}")
            if rnd == 2:
                os.unlink(os.path.join(src, "doc_00030.txt"))
            kb.sync(src)
            save_generation(kb.version)
            assert runtime.publish() == kb.version
            # the snapshot pins the engine's plane of its generation
            assert runtime.snapshots.current.ivf is runtime.engine.ivf
            with lock:
                n_before = len(served)
            deadline = time.monotonic() + 60
            while len(served) <= n_before + 2:  # some served at this gen
                assert time.monotonic() < deadline, "readers stalled"
                time.sleep(0.005)
        stop.set()
        for t in threads:
            t.join()
    observed = {res.generation for _, _, res in served}
    assert observed <= set(containers) and len(observed) >= 2
    references = {gen: _eng(KnowledgeBase.load(containers[gen]))
                  for gen in observed}
    for q, k, res in served:
        want = references[res.generation].query_batch([q], k=k)[0]
        assert_bit_identical([res.results], [want], label=(
            f"{q!r}@k={k} at generation {res.generation}"))


def test_serve_ivf_sharded_prints_the_jax_serve_ids_and_scores(tmp_path):
    docs, entities = make_corpus(n_docs=60, n_entities=3, seed=2)
    corpus = str(tmp_path / "corpus")
    write_corpus_dir(corpus, docs)
    args = ["--corpus", corpus, "--dim", "1024", "--top-k", "3",
            "--max-batch", "4", "--max-new-tokens", "0",
            "--guarantee", "exact", "--metrics", "--queries", *entities,
            "other query", "invoice payment"]
    outs = []
    for main, extra in (
            (serve.main, ["--device", "cpu", "--index", "ivf-sharded",
                          "--shards", "4"]),
            (ref_serve.main, ["--index", "ivf-sharded", "--shards", "4"]),
            (serve.main, ["--device", "cpu", "--index", "flat",
                          "--scoring-path", "map"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(args + extra) == 0
        outs.append(buf.getvalue())
    got, want, flat = (_printed(o) for o in outs)
    assert got == want == flat and len(got) == 5
    assert "shards: 4 logical" in outs[0]
    assert "index stats: index=ivf-sharded" in outs[0]


def test_ragdb_smoke_cell_on_the_cpu():
    """The edge_1k SMOKE cell at 2 logical shards: both legs give the
    JAX package's oracle's ids on the cell's arrays, and a second call
    through the same static buffers gives the same bits."""
    for use_kernel in (False, True):
        cell = steps.build_cell("ragdb", "edge_1k", smoke=True, device="cpu",
                                n_shards=2, use_kernel=use_kernel)
        assert cell.meta["n_shards"] == 2 and cell.meta["n_docs"] == 2048
        assert cell.meta["placement"] == "logical"
        vals, ids = cell.fn(*cell.args)
        again = cell.fn()
        assert torch.equal(vals, again[0]) and torch.equal(ids, again[1])
        rv, ri = ref_oracle(*(a.numpy() for a in cell.args), 2048, 4)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ri))
        np.testing.assert_allclose(vals.numpy(), np.asarray(rv), rtol=1e-5,
                                   atol=1e-6)


def test_sharded_planes_import_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import repro_torch.index.sharded, repro_torch.launch.mesh\n"
        "import repro_torch.core.retrieval, repro_torch.launch.steps\n"
        "import repro_torch.models.recsys.embedding\n"
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
