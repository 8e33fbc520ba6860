"""Train a small LM for a few hundred steps with the production train
step (gradient accumulation, remat, AdamW), including a mid-run
checkpoint + kill + exact restart-replay.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cpu]

The llama3.2-3b SMOKE config, on the card unless ``--device cpu`` is
given.  Asserts that the restarted run resumed at the last checkpoint
and that training lowered the loss.
"""
import tempfile

from repro_torch.examples import device_arg
from repro_torch.launch import train


def main(argv=None):
    device = device_arg(__doc__.splitlines()[0], argv)
    common = ["--arch", "llama3.2-3b", "--smoke", "--batch", "8",
              "--seq", "64", "--ckpt-every", "20"]
    if device is not None:
        common += ["--device", device]
    with tempfile.TemporaryDirectory() as work:
        print("=== phase 1: train 60 steps (checkpoint every 20) ===")
        first = train.run(train.parse_args(
            common + ["--steps", "60", "--ckpt-dir", work]))
        print("\n=== phase 2: 'failure' — restart from checkpoint, "
              "train to 100 ===")
        second = train.run(train.parse_args(
            common + ["--steps", "100", "--ckpt-dir", work]))
        assert second["start"] == 60, second["start"]
        loss = second["losses"][99]
        assert loss < first["losses"][0], (loss, first["losses"][0])
        print(f"\nfinal loss {loss:.4f} — deterministic replay from the "
              "DataCursor means this equals an uninterrupted 100-step run")
    return loss


if __name__ == "__main__":
    main()
