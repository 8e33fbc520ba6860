"""The DeepSeek-V2-Lite cell's files on the CPU: its readers against
hand counts on made-up runs (and nothing where the program recorded
nothing for them, as a program without MLA's route counts), and the
harness end to end on a SMOKE-size DeepSeek-V2 file with the published
YaRN group, judged against the YaRN reference."""
from __future__ import annotations

import json
import subprocess
import sys
import types
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))

from pbkit import smoke, spec  # noqa: E402
from pbkit.profiling import Profile  # noqa: E402

CELL = "dsv2lite.factoid_1u"
PEAKS = {"bfloat16": 989e12, "hbm_bytes_per_s": 3.35e12}
SEED = 2 ** 31 + 31


def _reader(name: str):
    return spec.metric_reader(BENCH_DIR, name)


def _cell_config() -> dict:
    return json.loads((BENCH_DIR / "configs"
                       / "rag.deepseek-v2-lite-16b.json").read_text())


def _counts() -> dict:
    ref = spec.load_module(BENCH_DIR / "reference" / "deepseek_v2.py",
                           "pb_test_dsv2lite_reference")
    return ref.counts(_cell_config())


def _span(name, span_id, parent, t0_s, dur_s, **args):
    return types.SimpleNamespace(name=name, span_id=span_id,
                                 parent_id=parent, t0_ns=int(t0_s * 1e9),
                                 dur_ns=int(dur_s * 1e9), args=args)


def _run(answers, spans, peaks=PEAKS, profile=None):
    """A made-up ``RunData``: each answer (prompt_len, tokens, decode_s,
    t_gen_start, t_done) in a window of [0, 100) s."""
    reqs = [types.SimpleNamespace(
        out=types.SimpleNamespace(prompt_len=p, token_ids=[0] * n,
                                  decode_s=d, prefill_s=0.05),
        t_gen_start=t0, t_done=t1, t_submit=t0)
        for p, n, d, t0, t1 in answers]
    cell = types.SimpleNamespace(config=_cell_config(), name=CELL)

    def spans_named(name):
        return [s for s in spans if s.name == name]

    return types.SimpleNamespace(cell=cell, counts=_counts(), peaks=peaks,
                                 answers=reqs, spans=spans,
                                 spans_named=spans_named, profile=profile,
                                 t0=0.0, t_end=100.0,
                                 t_last_done=max(a[4] for a in answers))


def _answer_spans(span_id, t0, steps, decode_layers):
    gen = _span("generate", span_id, 0, t0 + 0.001, 0.09, tokens=8,
                mla_prefill_unpadded=27, mla_prefill_padded=0,
                mla_decode_layers=decode_layers)
    kids = [_span("step_launch", 1000 * span_id + j, span_id,
                  t0 + 0.01 * (j + 1), 0.001, step="decode")
            for j in range(steps)]
    return [gen, _span("step_launch", 999, span_id, t0 + 0.002, 0.001,
                       step="prefill")] + kids


def test_decode_roofline_counts_the_configuration_bytes():
    c, cfg = _counts(), _cell_config()
    layers = len(c["layer_params"])
    spans = _answer_spans(1, 1.0, 8, layers * 8) \
        + _answer_spans(2, 2.0, 8, layers * 8)
    run = _run([(1950, 8, 0.080, 1.0, 1.1), (1900, 8, 0.079, 2.0, 2.1)],
               spans)
    weights = 2 * (sum(c["layer_params"]) + 2048 * 102400)
    slot = 2 * (512 + 64) * 27
    need = sum(weights + slot * (p + j) for p in (1950, 1900)
               for j in range(1, 8)) / PEAKS["hbm_bytes_per_s"]
    got = _reader("dsv2lite_decode_roofline")(run)
    assert got == pytest.approx(100 * need / 0.159, rel=1e-12)
    # the active weights a step reads: ~4.9 GB, ~1.46 ms at 3.35 TB/s
    assert weights == pytest.approx(4.9e9, rel=0.01)
    assert 0 < got < 100


@pytest.mark.parametrize("decode_layers,steps", [(27 * 7, 8), (26 * 8, 8),
                                                 (0, 8), (27 * 8, 0)])
def test_decode_roofline_reads_only_the_absorbed_path(decode_layers, steps):
    spans = _answer_spans(1, 1.0, steps, decode_layers)
    run = _run([(1950, 8, 0.080, 1.0, 1.1)], spans)
    assert _reader("dsv2lite_decode_roofline")(run) is None


def test_new_readers_read_nothing_where_the_program_recorded_nothing():
    """A program without the generate span's route args (the parent's),
    and a run with no card: nothing, and nothing raised."""
    spans = [_span("generate", 1, 0, 1.001, 0.09, tokens=8)]
    run = _run([(1950, 8, 0.080, 1.0, 1.1)], spans)
    assert _reader("dsv2lite_decode_roofline")(run) is None
    assert _reader("dsv2lite_flash_roofline")(run) is None
    cpu = _run([(1950, 8, 0.080, 1.0, 1.1)], _answer_spans(1, 1.0, 8, 216),
               peaks=None)
    for name in ("dsv2lite_decode_roofline", "dsv2lite_mfu",
                 "dsv2lite_flash_roofline"):
        assert _reader(name)(cpu) is None, name


def test_flash_roofline_reads_the_192_128_design_only():
    answers = [(1950, 8, 0.080, 1.0, 1.1)]
    base = _run(answers, [])
    prof = Profile(kernels=[
        ("void (anonymous namespace)::flash_fwd_wgmma<192, 128>(CUtensorMap_st"
         ", CUtensorMap_st, CUtensorMap_st, FlashParams)", 0.0, 600.0),
        ("void (anonymous namespace)::flash_fwd_wgmma<128, 128>(x)", 0.0,
         9000.0),
        ("void (anonymous namespace)::flash_fwd_ws<256, 256>(x)", 0.0,
         9000.0)], answers=base.answers)
    run = _run(answers, [], profile=prof)
    from pbkit import counting
    bound = 27 * counting.flash_bound_s(run.counts, 1950, PEAKS)
    got = _reader("dsv2lite_flash_roofline")(run)
    assert got == pytest.approx(100 * bound / 600e-6, rel=1e-12)
    padded = _run(answers, [], profile=Profile(
        kernels=prof.kernels[1:], answers=base.answers))
    assert _reader("dsv2lite_flash_roofline")(padded) is None


def test_shared_readers_give_the_accepted_readers_numbers():
    answers = [(1950, 8, 0.080, 1.0, 1.1), (1900, 8, 0.090, 2.0, 2.12)]
    run = _run(answers, [])
    for mine, theirs in (("dsv2lite_mfu", "mfu"),
                         ("dsv2lite_prefill_ms.p50", "prefill_ms.p50"),
                         ("dsv2lite_decode_ms_per_token.p50",
                          "decode_ms_per_token.p50")):
        got = _reader(mine)(run)
        assert got is not None and got == _reader(theirs)(run), mine


def test_cell_entries_list_the_cell():
    bench = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())
    (cell,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "rag.deepseek-v2-lite-16b", "factoid_1u", 1)
    (cfg,) = [c for c in bench["configs"]
              if c["name"] == "rag.deepseek-v2-lite-16b"]
    assert cfg["source"] == ("https://huggingface.co/deepseek-ai/"
                             "DeepSeek-V2-Lite/blob/main/config.json")
    assert cfg["reduced"] == ["n_docs"]
    mine = [m for m in bench["per_layer"] if m["name"].startswith("dsv2lite_")]
    assert len(mine) == 5
    for m in mine:
        assert m["workloads"] == [CELL]
        assert m["moves"] == "answer_tokens_per_s"


def test_yarn_smoke_cell_runs_correct_through_the_harness(tmp_path):
    """The harness on a SMOKE-size DeepSeek-V2 file with the published
    YaRN group: the adapter hands the group to the program, which serves
    what the YaRN reference computes."""
    bench_json = smoke.bench_dir(tmp_path, BENCH_DIR)
    pb = tmp_path / "perfbench"
    path = pb / "configs" / "smoke.deepseek.json"
    cfg = json.loads(path.read_text())
    cfg["rope_scaling"] = _cell_config()["rope_scaling"]
    path.write_text(json.dumps(cfg))
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(BENCH_DIR)!r})\n"
        "import run\n"
        "rc = run.main(['--workload', 'smoke.deepseek.smoke_1u', '--seed', "
        f"'{SEED}', '--seconds', '2', '--trace', '1'], "
        f"bench_json=__import__('pathlib').Path({str(bench_json)!r}), "
        "device='cpu')\n"
        "sys.exit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    assert result["metrics"]["dsv2lite_prefill_ms.p50"]["value"] > 0
