"""The MoE decode layer's plain version: what the port's decode step
computed in PyTorch for the routed experts (``models/moe.route`` then
``models/moe.dispatch``: the float32 router, the softmax, the top k by a
stable sort, the sorted grouped products and the gated combine), without
the aux loss, which the decode step drops.  The kernel
(``csrc/moe_decode.cu``) is held to it."""
from __future__ import annotations

import torch

from repro_torch.models import moe


def moe_decode_ref(x: torch.Tensor, params: dict,
                   cfg: moe.MoEConfig) -> torch.Tensor:
    """x [T, D] → the routed experts' output [T, D] in x's dtype (no
    shared experts)."""
    _, gates, ids = moe.route(params, x, cfg)
    return moe.dispatch(x, ids, gates, params, cfg)
