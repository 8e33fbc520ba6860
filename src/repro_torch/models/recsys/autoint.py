"""AutoInt (arXiv:1810.11921): multi-head self-attention over field
embeddings with residual connections, then a linear scoring head (the
JAX package's ``models/recsys/autoint.py``).  The attention over a
sample's 39 fields is plain einsum and softmax there too, not a kernel.

Parameters are a plain dict: ``table`` [rows, E], ``layers`` (a list of
``w_q``, ``w_k``, ``w_v``, ``w_res``) and ``head``.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers
from repro_torch.models.recsys import embedding
from repro_torch.models.recsys.base import RecsysConfig


def init(cfg: RecsysConfig, generator: torch.Generator, device=None) -> dict:
    """Random weights with the reference's distributions (table
    N(0, 1) · E^-½, matrices N(0, 1) · d_in^-½)."""
    device = generator.device if device is None else torch.device(device)
    table = embedding.init_tables(generator, cfg.vocab_sizes, cfg.embed_dim,
                                  device)["table"]
    params = {"table": table, "layers": []}
    d_in = cfg.embed_dim
    for _ in range(cfg.n_attn_layers):
        params["layers"].append({
            name: layers.dense_init(generator, d_in, cfg.d_attn,
                                    device=device)
            for name in ("w_q", "w_k", "w_v", "w_res")
        })
        d_in = cfg.d_attn
    params["head"] = layers.dense_init(generator, cfg.n_sparse * d_in, 1,
                                       device=device)
    return params


def forward(params, dense, sparse_idx: torch.Tensor,
            cfg: RecsysConfig) -> torch.Tensor:
    dt = cfg.compute_dtype
    offs = embedding.cached_offsets(cfg.vocab_sizes, sparse_idx.device)
    x = embedding.lookup(params["table"], offs, sparse_idx).to(dt)
    b, f, _ = x.shape
    h = cfg.n_attn_heads
    dh = cfg.d_attn // h
    for lp in params["layers"]:
        q = (x @ lp["w_q"].to(dt)).reshape(b, f, h, dh)
        k = (x @ lp["w_k"].to(dt)).reshape(b, f, h, dh)
        v = (x @ lp["w_v"].to(dt)).reshape(b, f, h, dh)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, f, cfg.d_attn)
        x = torch.relu(o + x @ lp["w_res"].to(dt))
    return (x.reshape(b, -1) @ params["head"].to(dt))[:, 0]


def retrieval_scores(params, dense_query, candidate_ids, cfg: RecsysConfig,
                     field: int = 0) -> torch.Tensor:
    dt = cfg.compute_dtype
    offs = embedding.cached_offsets(cfg.vocab_sizes, candidate_ids.device)
    q_emb = embedding.lookup_rows(
        params["table"], dense_query.to(torch.int32) + offs[None, :]
    ).to(dt).mean(dim=1)  # [1, D]
    return embedding.lookup_scores(params["table"],
                                   candidate_ids + offs[field], q_emb[0])
