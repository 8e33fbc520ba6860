"""``mfu`` (``metrics/mfu.py``) in the DeepSeek-V2-Lite cell: model
FLOPs of the window's answers, counted from the published
configuration, over the window's time and the card's bf16 peak (%)."""
from pathlib import Path

from pbkit import spec

_MFU = spec.load_module(Path(__file__).with_name("mfu.py"),
                        "pb_metric_mfu_for_dsv2lite")


def read(run):
    return _MFU.read(run)
