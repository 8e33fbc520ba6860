"""Weights made from ``--seed``: one generator on the run's device, one
draw per leaf kind for all layers at once, in the type the leaf is
served in.  A reference module lists its leaves with ``weight_specs``
as (name, shape, dtype, init) in a fixed order; ``init`` is a float
(normal × that scale) or ``"gamma"`` (a norm's gain, 1 + 0.1 · normal,
float32).  The same seed gives the same weights to the program and to
the reference."""
from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def make(specs: list[tuple], seed: int, device) -> dict[str, torch.Tensor]:
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(int(seed) % (1 << 64))
    out = {}
    for name, shape, dtype, init in specs:
        if init == "gamma":
            t = torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device).mul_(0.1).add_(1.0)
        else:
            t = torch.randn(shape, generator=gen, dtype=DTYPES[dtype],
                            device=device).mul_(init)
        out[name] = t
    return out

