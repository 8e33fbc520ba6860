"""Row-wise Adagrad for huge embedding tables (the JAX package's
``optim/rowwise.py``; FBGEMM/DLRM-standard).

AdamW keeps two float32 moments per parameter; row-wise Adagrad keeps
one float32 scalar per row (the running sum of the row's mean squared
gradient), a 2·dim× smaller state — the production split of Criteo-scale
DLRM training: dense towers on AdamW, tables on row-wise Adagrad.

A row whose gradient is zero keeps its bits: ``g2 + 0 = g2`` and
``table − lr·0/(√g2 + ε) = table``.  So ``rowwise_update_rows`` updates
only the rows a batch touched, from their gradient alone, and gives
what ``rowwise_update`` gives over the whole table — without the
table-sized gradient (48 GB for dlrm-rm2) that one card cannot hold
beside the table.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

TABLE_KEYS = ("table", "first_order")


@dataclass(frozen=True)
class RowwiseAdagradConfig:
    lr: float = 0.02
    eps: float = 1e-8


def rowwise_init(table: torch.Tensor) -> dict:
    return {"g2": torch.zeros((table.shape[0],), dtype=torch.float32,
                              device=table.device)}


@torch.no_grad()
def rowwise_update(grad: torch.Tensor, state: dict, table: torch.Tensor,
                   cfg: RowwiseAdagradConfig):
    """One step, as the reference: grad and table [V, E], state["g2"]
    [V]; returns (new table, {"g2": new g2}), new tensors."""
    g = grad.to(torch.float32)
    g2 = state["g2"] + torch.mean(torch.square(g), dim=-1)
    step = cfg.lr * g / (torch.sqrt(g2)[:, None] + cfg.eps)
    return (table - step).to(table.dtype), {"g2": g2}


@torch.no_grad()
def rowwise_update_rows(rows: torch.Tensor, grad_rows: torch.Tensor,
                        state: dict, table: torch.Tensor,
                        cfg: RowwiseAdagradConfig) -> None:
    """``rowwise_update`` on the rows ``rows`` (distinct int64 ids) of
    ``table`` [V, E] and ``state["g2"]`` [V], in place, given their
    gradient grad_rows [len(rows), E]; every other row and its g2 keep
    their bits."""
    new_rows, new = rowwise_update(grad_rows, {"g2": state["g2"][rows]},
                                   table[rows], cfg)
    table.index_copy_(0, rows, new_rows)
    state["g2"].index_copy_(0, rows, new["g2"])


def split_tree(params: dict) -> tuple[dict, dict]:
    """(table leaves, everything else) — tables go to row-wise Adagrad,
    the dense remainder to AdamW."""
    tables = {k: v for k, v in params.items() if k in TABLE_KEYS}
    dense = {k: v for k, v in params.items() if k not in tables}
    return tables, dense
