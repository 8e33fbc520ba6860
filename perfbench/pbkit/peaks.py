"""Published peaks of the cards the benchmark knows (dense rates, no
sparsity), by the name ``torch.cuda.get_device_name()`` gives.
NVIDIA H100 SXM data sheet: 989 TFLOP/s bf16, 495 TFLOP/s TF32,
67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM3, at the
full 700 W."""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bfloat16": 989e12, "tf32": 495e12, "float32": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peaks(device_kind: str) -> dict | None:
    return PEAKS.get(device_kind)
