"""One LM arch's 512-bucket prefill on several trees of this repository,
in turns, on one card.

    python3 tools/prefill_ab.py [--arch ID] TREE [TREE ...]

Each TREE is a checkout (e.g. ``git archive`` of the parent commit
unpacked into a directory that ``.gitignore`` lists); each runs in a
process of its own, in the order given (parent, change, change, parent
compares two trees within one call), importing that tree's ``src/`` and
building its kernels there.  A run initialises the arch's FULL config
in bf16 with seed-0 weights, prefills a 475-token prompt right-padded to
512 (``launch/steps.make_lm_prefill_step``), counts the flash launches
of one eager step, captures the step in a CUDA graph, and prints one
JSON line: the eager and replayed step's ms (CUDA events, two medians
each, of 5 and 20 calls) and the logits' sum and argmax.  Needs a card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

PROMPT, BUCKET = 475, 512


def _median_ms(torch, fn, runs):
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def run_one(arch: str, tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import torch

    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get(arch).config
    model = T.init(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
    max_len = BUCKET + 9
    prefill = steps.make_lm_prefill_step(cfg, max_len)
    caches = T.init_cache(cfg, 1, max_len, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(16)
    tokens = torch.randint(0, cfg.vocab, (1, BUCKET), device="cuda",
                           generator=gen)
    tokens[:, PROMPT:] = 0
    plen = torch.tensor([PROMPT], dtype=torch.int32, device="cuda")

    def step():
        return prefill(model, tokens, plen, caches)

    with torch.no_grad():
        fa_ops.reset_counts()
        step()
        torch.cuda.synchronize()
        launches = dict(fa_ops.counts)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            logits = step()[0]
        eager = [_median_ms(torch, step, 5) for _ in range(2)]
        replay = [_median_ms(torch, graph.replay, 20) for _ in range(2)]
        graph.replay()
        torch.cuda.synchronize()
    return {"tree": str(tree), "arch": arch, "launches": launches,
            "eager_ms": eager, "replay_ms": replay,
            "logit_sum": logits.float().sum().item(),
            "logit_argmax": logits.argmax(-1).tolist()}


def main(argv: list[str]) -> int:
    arch = "deepseek-v2-lite-16b"
    if argv[:1] == ["--arch"]:
        arch, argv = argv[1], argv[2:]
    if argv[:1] == ["--one"]:
        print(json.dumps(run_one(arch, Path(argv[1]).resolve())), flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    for tree in argv:
        run = subprocess.run(
            [sys.executable, __file__, "--arch", arch, "--one", tree],
            capture_output=True, text=True, timeout=600)
        sys.stderr.write(run.stderr[-4000:])
        assert run.returncode == 0, (tree, run.stdout[-2000:])
        print(run.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
