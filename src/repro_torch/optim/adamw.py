"""AdamW over trees of tensors (the JAX package's ``optim/adamw.py``).

The state mirrors the parameter tree leaf for leaf: ``m`` and ``v``
float32, ``step`` an int32 scalar.  ``adamw_update`` does the
reference's arithmetic in its order — global-norm clipping, the moment
updates, bias correction, the decoupled weight decay — one leaf at a
time, and writes the new moments and parameters into the tensors it was
given (the port's counterpart of the reference's buffer donation: a
3 B-parameter state is never held twice).  It returns them all the same,
so a call reads as the reference's ``params, state = adamw_update(...)``.
``torch.optim.AdamW`` orders its operations differently and is not used.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.optim import tree as tree_lib


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params) -> dict:
    """Zero moments (float32, on each leaf's device) and step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    first = tree_lib.leaves(params)[0]
    return {"m": tree_lib.map_(zeros, params),
            "v": tree_lib.map_(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ x²), each leaf's sum in float32."""
    with torch.no_grad():
        return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                              for x in tree_lib.leaves(tree)))


@torch.no_grad()
def adamw_update(grads, state, params, cfg: AdamWConfig, lr=None):
    """One step; returns (params, state), both updated in place but
    ``state["step"]``, which is a new tensor.  ``lr`` (a float or a
    float32 scalar tensor; schedules pass the step's value) overrides
    ``cfg.lr``."""
    lr = cfg.lr if lr is None else lr
    step = state["step"] + 1
    gn = global_norm(grads)
    clip = torch.clamp_max(cfg.grad_clip / (gn + 1e-9), 1.0)
    bc1 = 1.0 - cfg.b1 ** step.to(torch.float32)
    bc2 = 1.0 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * clip
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        del g
        mhat = m / bc1
        denom = torch.sqrt(v / bc2) + cfg.eps
        new_p = p - lr * (mhat / denom + cfg.weight_decay * p)
        p.copy_(new_p.to(p.dtype))

    tree_lib.map_(upd, params, grads, state["m"], state["v"])
    return params, {"m": state["m"], "v": state["v"], "step": step}
