"""'Live Sync' (paper §3.3) under real concurrency, in PyTorch: a single ingest
thread watches a directory and republishes the serving snapshot after
every delta, while concurrent reader threads keep querying through the
micro-batching scheduler the whole time.  Readers are pinned to
immutable generations (docs/ARCHITECTURE.md §7), so continuous ingest
never blocks serving and no query ever observes a half-refreshed
matrix — the script verifies zero torn reads at the end.

Publishes are **durable** (docs/ARCHITECTURE.md §8): each one appends
an O(changed docs) delta record to the container's journal, so a crash
never loses a published generation.  The script finishes by simulating
that crash — reloading the knowledge base purely from disk and
checking it matches the live writer's final state.

    PYTHONPATH=src python -m repro_torch.examples.live_sync [--device cpu]

The engine's doc tensors live on the card unless ``--device cpu`` is
given.
"""
import os
import tempfile
import threading
import time

from repro_torch.core.container import journal_size
from repro_torch.core.ingest import KnowledgeBase
from repro_torch.data.corpus import make_corpus, write_corpus_dir
from repro_torch.examples import device_arg
from repro_torch.serving import ServingRuntime

N_READERS = 4


def main(argv=None):
    device = device_arg(__doc__.splitlines()[0], argv)
    with tempfile.TemporaryDirectory() as work:
        corpus_dir = os.path.join(work, "docs")
        docs, entities = make_corpus(n_docs=400, seed=0)
        write_corpus_dir(corpus_dir, docs)
        kb = KnowledgeBase(dim=2048)
        container = os.path.join(work, "kb.ragdb")
        runtime = ServingRuntime(kb, max_batch=16, flush_deadline=0.002,
                                 container_path=container, device=device)
        published = {runtime.generation}
        queries = [*entities, "escalation runbook", "quarterly forecast"]

        events = [
            ("initial scan", lambda: None),
            ("no changes", lambda: None),
            ("edit 2 files", lambda: [
                open(os.path.join(corpus_dir, f"doc_{i:05d}.txt"), "a")
                .write(f" EDIT_{i}") for i in (3, 9)
            ]),
            ("add a file", lambda: open(
                os.path.join(corpus_dir, "new_note.txt"), "w"
            ).write("TICKET-4821 escalation runbook")),
            ("delete a file", lambda: os.unlink(
                os.path.join(corpus_dir, "doc_00000.txt"))),
        ]

        stop = threading.Event()
        observed: list[int] = []  # generations readers were served from
        obs_lock = threading.Lock()

        def reader(seed: int):
            i = seed
            while not stop.is_set():
                q = queries[i % len(queries)]
                i += 1
                served = runtime.submit(q, k=1).result(timeout=60)
                with obs_lock:
                    observed.append(served.generation)

        with runtime:
            threads = [threading.Thread(target=reader, args=(i,), daemon=True)
                       for i in range(N_READERS)]
            for t in threads:
                t.start()

            # the single writer: mutate → sync → publish, atomically
            # swapping the snapshot readers pin — they never wait
            for label, mutate in events:
                mutate()
                s = kb.sync(corpus_dir)
                gen = runtime.publish(durable=True)
                published.add(gen)
                print(f"{label:15s} → scanned={s.scanned:4d} "
                      f"skipped={s.skipped:4d} +{s.added} ~{s.updated} "
                      f"-{s.removed}  (sync {s.seconds * 1e3:.1f} ms, "
                      f"published generation {gen})")
                time.sleep(0.05)  # let readers overlap this generation

            top = runtime.submit("TICKET-4821", k=1).result(timeout=60)
            stop.set()
            for t in threads:
                t.join()

        print(f"\nquery TICKET-4821 → {top.results[0].doc_id} "
              f"(boosted={top.results[0].boosted}, "
              f"generation {top.generation}) — the live delta is queryable")
        torn = [g for g in observed if g not in published]
        print(f"{N_READERS} readers served {len(observed)} queries across "
              f"generations {sorted(set(observed))}; "
              f"torn reads: {len(torn)}")
        assert not torn, "a query observed an unpublished generation"
        assert top.results[0].doc_id == "new_note.txt"
        print(f"metrics: {runtime.metrics.format()}")

        # simulated crash: rebuild purely from base + journal on disk.
        # The first durable publish full-saved the base; every later one
        # appended an O(changed docs) delta record, and replay restores
        # exactly the last published generation.
        recovered = KnowledgeBase.load(container)
        assert set(recovered.records) == set(kb.records)
        assert recovered.loaded_generation == kb.loaded_generation
        assert "TICKET-4821" in recovered.texts["new_note.txt"]
        print(f"durable: base={os.path.getsize(container)}B "
              f"journal={journal_size(container)}B — crash recovery "
              f"restored {recovered.n_docs} docs at container generation "
              f"{recovered.loaded_generation}")


if __name__ == "__main__":
    main()
