from repro_torch.kernels.hsf_score.ops import (  # noqa: F401
    hsf_score,
    hsf_score_batched,
)
