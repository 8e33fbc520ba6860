"""Quickstart: the paper's core loop in PyTorch, on the card.

Builds a synthetic corpus with injected entity codes (§5.1), ingests it
into a single-file knowledge container, runs hybrid queries through the
batched serving entry point (``QueryEngine.query_batch``), compares the
clustered IVF index against the flat scan (probed fraction + recall),
checks the IVF plane's exact mode and the sharded cluster plane against
the flat scan bit for bit, then shows the O(U) incremental sync (§3.3) and the container round
trip.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import os
import tempfile

from repro_torch.core.engine import QueryEngine
from repro_torch.core.ingest import KnowledgeBase
from repro_torch.data.corpus import make_corpus, write_corpus_dir
from repro_torch.examples import device_arg


def main(argv=None):
    device = device_arg(__doc__.splitlines()[0], argv)
    with tempfile.TemporaryDirectory() as work:
        corpus_dir = os.path.join(work, "docs")
        docs, entities = make_corpus(n_docs=500, n_entities=5, seed=42)
        write_corpus_dir(corpus_dir, docs)

        # --- cold ingestion -------------------------------------------
        kb = KnowledgeBase(dim=4096)
        stats = kb.sync(corpus_dir)
        print(f"cold ingest : {stats.added} docs in {stats.seconds:.2f}s "
              f"({stats.added / stats.seconds:.0f} docs/s)")

        # --- hybrid retrieval (HSF: α·cos + β·substring), batched ------
        # QueryEngine is the serving entry point: one dispatch scores
        # the whole query batch (scoring_path="auto" picks the fused
        # CUDA kernel on the card, the bit-stable map path on the CPU)
        engine = QueryEngine(kb, alpha=1.0, beta=1.0, device=device)
        print(f"\nengine on {engine.device}, scoring path "
              f"{engine.scoring_path}")
        code, target = next(iter(entities.items()))
        print(f"query: {code!r}")
        for r in engine.query_batch([code], k=3)[0]:
            mark = "BOOSTED" if r.boosted else "       "
            print(f"  {mark} {r.doc_id:22s} score={r.score:.4f} "
                  f"cos={r.cosine:.4f}")
        assert engine.query_batch([code], k=1)[0][0].doc_id == \
            f"doc_{target:05d}.txt"

        # --- one dispatch, many queries --------------------------------
        codes = list(entities)[:3]
        for code_, results in zip(codes, engine.query_batch(codes, k=1)):
            print(f"batched query {code_!r} → {results[0].doc_id}")

        # --- clustered index: probe √N centroids, rerank exactly -------
        # index="ivf" scores ~√N centroids, probes the top-nprobe
        # clusters, and reranks the gathered rows with the exact HSF —
        # sublinear scan cost
        ivf = QueryEngine(kb, alpha=1.0, beta=1.0, index="ivf", nprobe=2,
                          device=device)
        codes = list(entities)
        flat_top = engine.query_batch(codes, k=1)
        ivf_top = ivf.query_batch(codes, k=1)
        recall = sum(
            f[0].doc_id == v[0].doc_id for f, v in zip(flat_top, ivf_top)
        ) / len(codes)
        stats = ivf.index_stats()
        print(f"\nivf index   : {stats['n_clusters']} clusters, "
              f"probed {stats['probed_fraction']:.0%} of the corpus "
              f"(nprobe=2), Recall@1 vs flat scan: {recall:.0%}")

        # --- exact mode: widen probes until the top-k is provably the ---
        # flat scan's.  The map path scores each row alone, so the
        # rerank of a probed subset gives the flat scan's bits.
        exact = QueryEngine(kb, alpha=1.0, beta=1.0, index="ivf",
                            guarantee="exact", scoring_path="map",
                            device=device)
        flat_map = QueryEngine(kb, alpha=1.0, beta=1.0, scoring_path="map",
                               device=device)
        a = flat_map.query_batch(codes, k=3)
        b = exact.query_batch(codes, k=3)
        assert all(
            [(r.doc_id, r.score) for r in x]
            == [(r.doc_id, r.score) for r in y]
            for x, y in zip(a, b)
        )
        st = exact.index_stats()
        print(f"ivf exact   : {st['rounds']} probe round(s), "
              f"exact top-k bit-identical to the flat scan ✓")

        # --- sharded index: the cluster plane across the shard mesh ----
        # index="ivf-sharded" gives each shard (a card of its own, or a
        # logical shard on one card) its own clusters' resident rows;
        # only per-shard [B, k] top-k candidates leave a shard, and
        # guarantee="exact" keeps the merged answer bit-identical to
        # the flat scan at any shard count
        sharded = QueryEngine(kb, alpha=1.0, beta=1.0,
                              index="ivf-sharded", guarantee="exact",
                              n_shards=4, device=device)
        b = sharded.query_batch(codes, k=3)
        assert all(
            [(r.doc_id, r.score) for r in x]
            == [(r.doc_id, r.score) for r in y]
            for x, y in zip(a, b)
        )
        st = sharded.index_stats()
        print(f"sharded     : {st['n_shards']} shards "
              f"({sharded.ivf.placement}), exact top-k bit-identical to "
              f"the flat scan ✓ (merge {st['merge_seconds'] * 1e3:.2f} ms)")

        # --- incremental sync: O(U), not O(N) --------------------------
        with open(os.path.join(corpus_dir, "doc_00007.txt"), "a") as f:
            f.write(" freshly added INV-2026 reference")
        stats = kb.sync(corpus_dir)
        refresh = engine.refresh()  # patches 1 device row, not 500
        print(f"\nincremental : {stats.updated} updated, "
              f"{stats.skipped} skipped in {stats.seconds:.3f}s "
              f"(engine refresh: {refresh.changed} row, "
              f"{refresh.seconds * 1e3:.1f} ms)")
        top = engine.query_batch(["INV-2026"], k=1)[0][0]
        print(f"query INV-2026 → {top.doc_id} (score {top.score:.3f})")

        # --- single-file container (§3.1) -------------------------------
        path = os.path.join(work, "knowledge.ragdb")
        kb.save(path)
        print(f"\ncontainer   : {os.path.getsize(path) / 1e6:.2f} MB "
              f"(single file, SHA-256 verified segments)")
        kb2 = KnowledgeBase.load(path)
        assert QueryEngine(kb2, device=device).query_batch(
            [code], k=1)[0][0].doc_id == f"doc_{target:05d}.txt"
        print("restore     : retrieval identical after round-trip ✓")


if __name__ == "__main__":
    main()
