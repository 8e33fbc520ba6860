"""Per-family input-shape sets (the JAX package's ``configs/shapes.py``):
``ShapeSpec`` and the shape tables as plain dicts.  The JAX package's
``input_specs`` (abstract stand-ins for its dry-run lowering) has no
counterpart here."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeSpec:
    shape_id: str
    kind: str  # which step function serves it
    meta: dict


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "lm_train",
                          {"seq": 4096, "batch": 256}),
    "prefill_32k": ShapeSpec("prefill_32k", "lm_prefill",
                             {"seq": 32768, "batch": 32}),
    "decode_32k": ShapeSpec("decode_32k", "lm_decode",
                            {"seq": 32768, "batch": 128}),
    "long_500k": ShapeSpec("long_500k", "lm_decode",
                           {"seq": 524288, "batch": 1}),
}

# minibatch_lg slot geometry: 1024 seeds, fanout 15 then 10
#   nodes 1024·(1 + 15 + 150) = 169,984;  edges 1024·(15 + 150) = 168,960
_MB_NODES = 1024 * (1 + 15 + 150)
_MB_EDGES = 1024 * (15 + 150)


def _pad512(n: int) -> int:
    """Graph slots are padded to a multiple of 512 (masks carry
    validity; logical sizes stay exact)."""
    return n + (-n) % 512


GNN_SHAPES = {
    "full_graph_sm": ShapeSpec(
        "full_graph_sm", "gnn_train",
        {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433, "n_graphs": 1,
         "pad_nodes": _pad512(2708), "pad_edges": _pad512(10556)},
    ),
    "minibatch_lg": ShapeSpec(
        "minibatch_lg", "gnn_train_sampled",
        {"n_nodes": _MB_NODES, "n_edges": _MB_EDGES, "d_feat": 602,
         "batch_nodes": 1024, "fanout": (15, 10), "n_graphs": 1,
         "pad_nodes": _pad512(_MB_NODES), "pad_edges": _pad512(_MB_EDGES)},
    ),
    "ogb_products": ShapeSpec(
        "ogb_products", "gnn_train",
        {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100,
         "n_graphs": 1,
         "pad_nodes": _pad512(2449029), "pad_edges": _pad512(61859140)},
    ),
    "molecule": ShapeSpec(
        "molecule", "gnn_train_batched",
        {"n_nodes": 30 * 128, "n_edges": 64 * 128, "d_feat": 32,
         "batch": 128, "n_graphs": 128,
         "pad_nodes": _pad512(30 * 128), "pad_edges": _pad512(64 * 128)},
    ),
}

RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "recsys_train", {"batch": 65536}),
    "serve_p99": ShapeSpec("serve_p99", "recsys_serve", {"batch": 512}),
    "serve_bulk": ShapeSpec("serve_bulk", "recsys_serve", {"batch": 262144}),
    "retrieval_cand": ShapeSpec(
        "retrieval_cand", "recsys_retrieval",
        {"batch": 1, "n_candidates": 1_000_000, "top_k": 16,
         # candidate array padded to a multiple of 512; padding scores
         # are masked to -inf before the top-k
         "pad_candidates": 1_000_000 + (-1_000_000) % 512},
    ),
}

# The paper's own plane: sharded corpus retrieval.
RAGDB_SHAPES = {
    "edge_1k": ShapeSpec("edge_1k", "ragdb_retrieve",
                         {"docs_per_device": 1024, "query_batch": 4}),
    "pod_16m": ShapeSpec("pod_16m", "ragdb_retrieve",
                         {"docs_per_device": 65536, "query_batch": 64}),
}


def shapes_for_family(family: str) -> dict[str, ShapeSpec]:
    return {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES,
            "ragdb": RAGDB_SHAPES}[family]
