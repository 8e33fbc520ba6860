"""Shared recsys config, loss and weight carrying (the JAX package's
``models/recsys/base.py``, plus ``params_from_numpy``, which is
``optim.tree.from_numpy``, and ``opt_state_from_numpy``)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.optim.tree import from_numpy as params_from_numpy  # noqa: F401

# Criteo 1TB per-field vocabulary sizes (MLPerf DLRM reference;
# facebookresearch/dlrm README).  dlrm archs use these 26 directly.
CRITEO_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)

# 39-field layout (deepfm/autoint convention): 13 bucketized dense
# fields (small vocabs) + the 26 categorical fields, capped per the
# usual Criteo-Kaggle preprocessing (hash-capped at 1e6 rows/field).
DEEPFM_VOCABS = tuple([101] * 13) + tuple(
    min(v, 1_000_000) for v in CRITEO_VOCABS
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class RecsysConfig:
    name: str
    vocab_sizes: tuple[int, ...]
    embed_dim: int
    n_dense: int = 0
    bot_mlp: tuple[int, ...] = ()
    top_mlp: tuple[int, ...] = ()
    mlp_dims: tuple[int, ...] = ()  # deepfm deep tower
    n_attn_layers: int = 0  # autoint
    n_attn_heads: int = 0
    d_attn: int = 0
    interaction: str = "dot"  # dot | fm | self-attn
    dtype: str = "float32"

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    def param_count(self) -> int:
        n = sum(self.vocab_sizes) * self.embed_dim
        if self.interaction == "fm":
            n += sum(self.vocab_sizes)  # first-order weights
        dims_chains = []
        if self.bot_mlp:
            dims_chains.append((self.n_dense,) + self.bot_mlp)
        if self.top_mlp:
            n_inter = self.n_sparse + (1 if self.bot_mlp else 0)
            d_top_in = n_inter * (n_inter - 1) // 2 + (
                self.bot_mlp[-1] if self.bot_mlp else 0
            )
            dims_chains.append((d_top_in,) + self.top_mlp)
        if self.mlp_dims:
            dims_chains.append(
                (self.n_sparse * self.embed_dim,) + self.mlp_dims + (1,)
            )
        for dims in dims_chains:
            for i in range(len(dims) - 1):
                n += dims[i] * dims[i + 1] + dims[i + 1]
        if self.n_attn_layers:
            per = 3 * self.embed_dim * self.d_attn + self.embed_dim * self.d_attn
            d = self.d_attn
            per += 3 * d * d + d * d  # subsequent layers operate at d_attn
            n += per * self.n_attn_layers  # approximate (first layer differs)
        return n


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """Numerically stable binary cross entropy."""
    z = logits.clamp(-30.0, 30.0)
    return (z.clamp_min(0.0) - z * labels
            + torch.log1p(torch.exp(-z.abs()))).mean()


def opt_state_from_numpy(state: dict, device) -> dict:
    """The JAX package's recsys train state (AdamW's ``m``, ``v`` and
    ``step`` over the dense towers, and row-wise Adagrad's per-row
    ``g2`` of each table), as numpy arrays, as the port's
    (``launch.steps.recsys_opt_init``'s layout): float32 tensors on
    ``device``, ``step`` an int32 scalar."""
    out = {k: params_from_numpy(state[k], device, torch.float32)
           for k in ("m", "v", "g2")}
    out["step"] = torch.tensor(int(np.asarray(state["step"])),
                               dtype=torch.int32, device=device)
    return out
