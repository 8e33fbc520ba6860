"""DLRM (arXiv:1906.00091): bottom MLP ∥ embedding lookups → dot
interaction → top MLP.  Covers dlrm-rm2 and dlrm-mlperf via config (the
JAX package's ``models/recsys/dlrm.py``).

Parameters are a plain dict: ``table`` [rows, E], ``bot`` and ``top``
(``w{i}``, ``b{i}``).  Rows are gathered before any cast to the compute
dtype, so no forward copies the table.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers
from repro_torch.models.recsys import embedding
from repro_torch.models.recsys.base import RecsysConfig


def init(cfg: RecsysConfig, generator: torch.Generator, device=None) -> dict:
    """Random weights with the reference's distributions (table
    N(0, 1) · E^-½, matrices N(0, 1) · d_in^-½, zero biases), drawn from
    ``generator`` on ``device`` (the generator's own by default)."""
    device = generator.device if device is None else torch.device(device)
    table = embedding.init_tables(generator, cfg.vocab_sizes, cfg.embed_dim,
                                  device)["table"]
    n_inter = cfg.n_sparse + 1  # sparse fields + bottom output
    d_top_in = n_inter * (n_inter - 1) // 2 + cfg.bot_mlp[-1]
    return {
        "table": table,
        "bot": layers.dense_mlp_init(generator, (cfg.n_dense,) + cfg.bot_mlp,
                                     device),
        "top": layers.dense_mlp_init(generator, (d_top_in,) + cfg.top_mlp,
                                     device),
    }


def _interact_dot(feats: torch.Tensor) -> torch.Tensor:
    """Pairwise dot interaction: feats [B, F, D] → [B, F(F-1)/2], the
    pairs (i < j) in row-major order, as ``jnp.triu_indices(f, k=1)``."""
    f = feats.shape[1]
    z = torch.bmm(feats, feats.transpose(1, 2))
    iu, ju = torch.triu_indices(f, f, 1, device=feats.device)
    return z[:, iu, ju]


def forward(params, dense: torch.Tensor, sparse_idx: torch.Tensor,
            cfg: RecsysConfig) -> torch.Tensor:
    """dense [B, n_dense] f32, sparse_idx [B, F] int → logits [B]."""
    dt = cfg.compute_dtype
    bot = layers.dense_mlp_apply(params["bot"], dense.to(dt),
                                 len(cfg.bot_mlp), final_activation=True)
    offs = embedding.cached_offsets(cfg.vocab_sizes, sparse_idx.device)
    emb = embedding.lookup(params["table"], offs, sparse_idx).to(dt)
    feats = torch.cat([bot[:, None, :], emb], dim=1)
    inter = _interact_dot(feats)
    top_in = torch.cat([inter, bot], dim=-1)
    out = layers.dense_mlp_apply(params["top"], top_in, len(cfg.top_mlp))
    return out[:, 0]


def retrieval_scores(params, dense_query: torch.Tensor,
                     candidate_ids: torch.Tensor, cfg: RecsysConfig,
                     field: int = 0) -> torch.Tensor:
    """retrieval_cand shape: one query against n candidates — the query
    tower (bottom MLP) dotted with candidate embedding rows."""
    dt = cfg.compute_dtype
    q = layers.dense_mlp_apply(params["bot"], dense_query.to(dt),
                               len(cfg.bot_mlp), final_activation=True)
    offs = embedding.cached_offsets(cfg.vocab_sizes, candidate_ids.device)
    return embedding.lookup_scores(params["table"],
                                   candidate_ids + offs[field], q[0])
