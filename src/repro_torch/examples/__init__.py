"""Runnable examples of the PyTorch port, each a module:

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.live_sync [--device cpu]
    python -m repro_torch.examples.multi_tenant [--device cpu]
    python -m repro_torch.examples.rag_serve [--device cpu]
    python -m repro_torch.examples.train_lm [--device cpu]

Each runs on the card unless ``--device cpu`` is given, and asserts what
it shows.
"""
import argparse


def device_arg(description: str, argv=None):
    """The examples' one option: ``--device`` (default: the card)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; pass cpu to run on "
                    "the host)")
    return ap.parse_args(argv).device
