"""``decode_ms_per_token.p50`` (``metrics/decode_ms_per_token.p50.py``)
in the DeepSeek-V2-Lite cell: the median over the window's answers of
``RAGOutput.decode_s`` over the answer's tokens (ms a token)."""
from pathlib import Path

from pbkit import spec

_DECODE = spec.load_module(
    Path(__file__).with_name("decode_ms_per_token.p50.py"),
    "pb_metric_decode_ms_per_token_p50_for_dsv2lite")


def read(run):
    return _DECODE.read(run)
