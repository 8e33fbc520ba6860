from repro_torch.kernels.hsf_score.ops import hsf_score_batched  # noqa: F401
