"""``prefill_ms.p50`` (``metrics/prefill_ms.p50.py``) in the
DeepSeek-V2-Lite cell: the median ``RAGOutput.prefill_s`` of the
window's answers (ms)."""
from pathlib import Path

from pbkit import spec

_PREFILL = spec.load_module(Path(__file__).with_name("prefill_ms.p50.py"),
                            "pb_metric_prefill_ms_p50_for_dsv2lite")


def read(run):
    return _PREFILL.read(run)
