"""DeepFM (arXiv:1703.04247): shared embeddings feeding an FM branch and
a deep MLP branch; logit = first_order + fm + deep (the JAX package's
``models/recsys/deepfm.py``).

Parameters are a plain dict: ``table`` [rows, E], ``first_order``
[rows], ``deep`` (``w{i}``, ``b{i}``) and the scalar ``bias``.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers
from repro_torch.models.recsys import embedding
from repro_torch.models.recsys.base import RecsysConfig


def init(cfg: RecsysConfig, generator: torch.Generator, device=None) -> dict:
    """Random weights with the reference's distributions (table
    N(0, 1) · E^-½, first order N(0, 1) · 0.01, matrices
    N(0, 1) · d_in^-½, zero biases)."""
    device = generator.device if device is None else torch.device(device)
    table = embedding.init_tables(generator, cfg.vocab_sizes, cfg.embed_dim,
                                  device)["table"]
    first = torch.empty((embedding.padded_rows(cfg.vocab_sizes),),
                        dtype=torch.float32, device=device)
    return {
        "table": table,
        "first_order": embedding.normal_(first, 0.01, generator),
        "deep": layers.dense_mlp_init(
            generator, (cfg.n_sparse * cfg.embed_dim,) + cfg.mlp_dims + (1,),
            device),
        "bias": torch.zeros((), dtype=torch.float32, device=device),
    }


def forward(params, dense, sparse_idx: torch.Tensor,
            cfg: RecsysConfig) -> torch.Tensor:
    """sparse_idx [B, F] int → logits [B] (dense unused: 39-field form)."""
    dt = cfg.compute_dtype
    offs = embedding.cached_offsets(cfg.vocab_sizes, sparse_idx.device)
    flat = sparse_idx.to(torch.int32) + offs[None, :]
    emb = embedding.lookup_rows(params["table"], flat).to(dt)  # [B, F, D]
    first = embedding.lookup_rows(params["first_order"], flat).to(dt).sum(-1)

    # FM second order: ½ Σ_d [(Σ_f v)² − Σ_f v²]
    sum_v = emb.sum(dim=1)
    sum_sq = emb.square().sum(dim=1)
    fm = 0.5 * (sum_v.square() - sum_sq).sum(dim=-1)

    deep = layers.dense_mlp_apply(
        params["deep"], emb.reshape(emb.shape[0], -1), len(cfg.mlp_dims) + 1
    )[:, 0]
    return first + fm + deep + params["bias"].to(dt)


def retrieval_scores(params, dense_query, candidate_ids, cfg: RecsysConfig,
                     field: int = 0) -> torch.Tensor:
    """Score candidates by FM affinity with a fixed query field-context:
    dot of candidate embedding against the query's summed field vector."""
    dt = cfg.compute_dtype
    offs = embedding.cached_offsets(cfg.vocab_sizes, candidate_ids.device)
    q_emb = embedding.lookup_rows(
        params["table"], dense_query.to(torch.int32) + offs[None, :]
    ).to(dt).sum(dim=1)  # [1, D]
    return embedding.lookup_scores(params["table"],
                                   candidate_ids + offs[field], q_emb[0])
