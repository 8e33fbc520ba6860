"""Step builders (the JAX package's ``launch/steps.py``, recsys serving).

``make_recsys_step(arch_id, cfg, kind, device=None)`` returns the step
function of one recsys shape kind on one device (the JAX package's
step takes a mesh; the multi-device planes are ROADMAP Queue 1 item 8):

- ``recsys_serve``: ``step(params, batch)`` → logits [B];
- ``recsys_retrieval``: ``step(params, batch)`` → the top 16 (values
  f32, ids int32) of the candidate scores, positions
  ``>= batch["n_real_candidates"]`` masked to -inf first, ordered
  (score desc, id asc) by the port's top-k kernel (``jax.lax.top_k``'s
  order; ``torch.topk`` has no tie rule on CUDA);
- ``recsys_train`` raises: it needs the optimizers (ROADMAP Queue 1
  item 10).

A batch holds numpy arrays or tensors (``dense``, ``sparse_idx``;
``query``, ``candidate_ids``, ``n_real_candidates``); the step moves
them to its device.  The params must already be there.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.kernels.topk import ops as topk_ops
from repro_torch.models.recsys import autoint as autoint_mod
from repro_torch.models.recsys import deepfm as deepfm_mod
from repro_torch.models.recsys import dlrm as dlrm_mod

RECSYS_MODULES = {
    "dlrm-rm2": dlrm_mod, "dlrm-mlperf": dlrm_mod,
    "deepfm": deepfm_mod, "autoint": autoint_mod,
    "dlrm-rm2-smoke": dlrm_mod, "dlrm-mlperf-smoke": dlrm_mod,
    "deepfm-smoke": deepfm_mod, "autoint-smoke": autoint_mod,
}
RETRIEVAL_TOP_K = 16


def _on(x, device):
    if x is None:
        return None
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device, non_blocking=True)


def make_recsys_step(arch_id: str, cfg, kind: str, device=None):
    mod = RECSYS_MODULES[cfg.name if cfg.name in RECSYS_MODULES else arch_id]
    device = resolve_device(device)
    # full f32 in the towers on the card: a TF32 product keeps ~3 digits
    torch.backends.cuda.matmul.allow_tf32 = False

    if kind == "recsys_serve":
        def serve(params, batch):
            return mod.forward(params, _on(batch.get("dense"), device),
                               _on(batch["sparse_idx"], device), cfg)

        return serve

    if kind == "recsys_retrieval":
        def retrieve(params, batch):
            scores = mod.retrieval_scores(
                params, _on(batch["query"], device),
                _on(batch["candidate_ids"], device), cfg)
            n = scores.shape[0]
            n_real = int(batch.get("n_real_candidates", n))
            if n_real < n:
                pos = torch.arange(n, device=scores.device)
                scores = scores.masked_fill(pos >= n_real, float("-inf"))
            return topk_ops.top_k(scores.to(torch.float32).contiguous(),
                                  RETRIEVAL_TOP_K)

        return retrieve

    if kind == "recsys_train":
        raise NotImplementedError(
            "recsys_train needs the optimizers (optim/rowwise.py, AdamW) "
            "of the PyTorch port; it comes with ROADMAP Queue 1 item 10 "
            "(training and generation substrate)")
    raise ValueError(f"unknown recsys step kind {kind!r}")
