from repro_torch.kernels.topk.ops import top_k  # noqa: F401
