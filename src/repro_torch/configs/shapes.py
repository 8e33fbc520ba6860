"""Per-family input-shape sets (the JAX package's ``configs/shapes.py``):
``ShapeSpec``, the shape tables as plain dicts, and ``input_specs``:
the data inputs of each cell's step as tensors on the ``meta`` device
(shape and dtype, no storage) — torch's counterpart of the reference's
``jax.ShapeDtypeStruct`` stand-ins."""
from __future__ import annotations

from dataclasses import dataclass

import torch


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


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(arch, spec: ShapeSpec) -> dict:
    """The data inputs of ``spec``'s step for the arch config ``arch``,
    as meta tensors (parameters and caches are not data inputs)."""
    m = spec.meta
    i32, f32 = torch.int32, torch.float32
    if spec.kind == "lm_train":
        return {"tokens": _spec((m["batch"], m["seq"]), i32),
                "targets": _spec((m["batch"], m["seq"]), i32)}
    if spec.kind == "lm_prefill":
        return {"tokens": _spec((m["batch"], m["seq"]), i32)}
    if spec.kind == "lm_decode":
        return {"tokens": _spec((m["batch"], 1), i32),
                "lengths": _spec((m["batch"],), i32)}
    if spec.kind in ("gnn_train", "gnn_train_sampled", "gnn_train_batched"):
        nn, ne = m["pad_nodes"], m["pad_edges"]
        specs = {
            "node_feats": _spec((nn, m["d_feat"]), f32),
            "positions": _spec((nn, 3), f32),
            "senders": _spec((ne,), i32),
            "receivers": _spec((ne,), i32),
            "labels": _spec((nn,), i32),
            "edge_mask": _spec((ne,), f32),
            "node_mask": _spec((nn,), f32),
        }
        if spec.kind == "gnn_train_sampled":
            specs["seed_mask"] = _spec((nn,), f32)
        if spec.kind == "gnn_train_batched":
            specs["graph_ids"] = _spec((nn,), i32)
            specs["energy_targets"] = _spec((m["n_graphs"],), f32)
        return specs
    if spec.kind in ("recsys_train", "recsys_serve"):
        specs = {"sparse_idx": _spec((m["batch"], arch.n_sparse), i32)}
        if arch.n_dense:
            specs["dense"] = _spec((m["batch"], arch.n_dense), f32)
        if spec.kind == "recsys_train":
            specs["labels"] = _spec((m["batch"],), f32)
        return specs
    if spec.kind == "recsys_retrieval":
        specs = {"candidate_ids": _spec((m["pad_candidates"],), i32)}
        specs["query"] = (_spec((m["batch"], arch.n_dense), f32)
                          if arch.n_dense
                          else _spec((m["batch"], arch.n_sparse), i32))
        return specs
    if spec.kind == "ragdb_retrieve":
        # per-device doc shard sizes are multiplied by the shard count
        # when the cell is built (launch/steps.py)
        return {"query_vecs": _spec((m["query_batch"], arch.dim), f32),
                "query_sigs": _spec((m["query_batch"], arch.sig_words), i32)}
    raise ValueError(spec.kind)
