"""End-to-end RAG serving through the concurrent runtime, in PyTorch:
many independent callers submit single requests; the micro-batching
scheduler coalesces them into batched scoring dispatches against a
generation-pinned snapshot (docs/ARCHITECTURE.md §7), then the
generation plane decodes per request.

    PYTHONPATH=src python -m repro_torch.examples.rag_serve [--device cpu]

The generator is the gemma2-9b SMOKE config (local + global layers,
both softcaps) with random weights from seed 0, on the card unless
``--device cpu`` is given.  Asserts that the scheduler coalesced a
batch and that every entity request retrieves its doc first (the
paper's RQ2).
"""
import os
import tempfile
import threading
import time

import torch

from repro_torch.configs import ARCHS
from repro_torch.core.engine import resolve_device
from repro_torch.core.ingest import KnowledgeBase
from repro_torch.core.rag import RAGPipeline
from repro_torch.data.corpus import make_corpus, write_corpus_dir
from repro_torch.examples import device_arg
from repro_torch.models import transformer as T
from repro_torch.serving import ServingRuntime


def main(argv=None):
    device = resolve_device(device_arg(__doc__.splitlines()[0], argv))
    with tempfile.TemporaryDirectory() as work:
        corpus_dir = os.path.join(work, "docs")
        docs, entities = make_corpus(n_docs=300, n_entities=6, seed=7)
        write_corpus_dir(corpus_dir, docs)
        kb = KnowledgeBase(dim=2048)
        kb.sync(corpus_dir)

        cfg = ARCHS["gemma2-9b"].smoke_config  # local+global, softcaps
        model = T.init(cfg, torch.Generator(device).manual_seed(0), device)
        runtime = ServingRuntime(kb, max_batch=8, flush_deadline=0.002,
                                 device=device)
        rag = RAGPipeline(kb, model, cfg, max_context_tokens=128,
                          engine=runtime.engine)

        requests = [f"lookup {code} status" for code in entities] + [
            "quarterly revenue forecast",
            "kubernetes deployment latency",
        ]
        print(f"serving {len(requests)} concurrent requests through the "
              f"micro-batching scheduler ({cfg.name}, "
              f"{cfg.param_count() / 1e6:.1f} M params, on {device})\n")

        served = {}
        with runtime:
            t0 = time.perf_counter()

            # each request arrives from its own caller thread — the
            # scheduler, not the callers, decides the batch shapes
            def call(q):
                served[q] = runtime.submit(q, k=2).result(timeout=60)

            threads = [threading.Thread(target=call, args=(q,))
                       for q in requests]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

            outs = [
                (q, rag.generate(q, served[q].results, max_new_tokens=6))
                for q in requests
            ]
            for q, out in outs:
                top = out.retrieved[0]
                print(f"  {q[:40]:42s} → {top.doc_id} "
                      f"(score {top.score:.3f}"
                      f"{'*' if top.boosted else ''}) "
                      f"tokens={out.token_ids}")
            dt = time.perf_counter() - t0
        print(f"\n{len(requests)} requests in {dt:.1f}s "
              f"({dt / len(requests) * 1e3:.0f} ms/request, {device})")
        print(f"metrics: {runtime.metrics.format()}")
        occupancy = runtime.metrics.snapshot()["batch_occupancy_mean"]
        assert occupancy > 1.0, "scheduler never coalesced a batch"

        # entity queries must hit their documents (paper RQ2)
        for code, idx in entities.items():
            top = rag.answer(code, max_new_tokens=1, top_k_docs=1)
            assert top.retrieved[0].doc_id == f"doc_{idx:05d}.txt"
        print("RQ2 check: all entity requests retrieved their doc ✓")


if __name__ == "__main__":
    main()
