"""RAGdb's retrieval core in PyTorch:

- hashing / tokenizer / vectorizer : sublinear hashed TF-IDF (paper §4.1)
- signature                        : Bloom n-gram substring indicator (§4.2)
- hsf                              : Hybrid Scoring Function (§4)
- container                        : Single-File Knowledge Container (§3.1)
- ingest                           : O(U) incremental multimodal ingestion (§3.2-3.3)
- engine                           : batched query engine (flat and IVF index)
- retrieval                        : single-query Retriever (+ postings prefilter)
- rag                              : retrieve → pack → generate orchestration

The clustered index plane lives in ``repro_torch.index``.
"""

from repro_torch.core.hsf import hsf_scores, hsf_scores_batched  # noqa: F401
from repro_torch.core.ingest import IngestStats, KnowledgeBase  # noqa: F401
from repro_torch.core.retrieval import Retriever  # noqa: F401
