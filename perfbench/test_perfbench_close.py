"""The window's close: an answer in progress at the close neither counts
nor dilutes, but a generator that stalled before the close, and a
question left open longer than the slowest answer, are not hidden."""
from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))

from pbkit import spec  # noqa: E402
from pbkit.harness import RunData  # noqa: E402
from pbkit.loop import Request  # noqa: E402

TOKENS = 8


def _answer(t_submit: float, t_done: float) -> Request:
    r = Request(0, "q", t_submit, t_retrieved=t_submit + 0.01,
                t_gen_start=t_submit + 0.01, t_done=t_done)
    r.out = SimpleNamespace(token_ids=[1] * TOKENS)
    return r


def _run(requests, t_end=10.0) -> RunData:
    return RunData(None, {}, None, 0.0, t_end, 0.0, requests)


def _read(name: str, run: RunData):
    return spec.metric_reader(BENCH_DIR, name)(run)


def _steady(n=9):
    """An answer a second, the last at ``n`` s, one open at the close."""
    reqs = [_answer(i, i + 1.0) for i in range(n)]
    reqs.append(Request(0, "q", float(n), t_gen_start=n + 0.01))
    return reqs


def test_an_answer_in_progress_at_the_close_neither_counts_nor_dilutes():
    run = _run(_steady())
    assert not run.stalled
    assert _read("answer_tokens_per_s", run) == pytest.approx(9 * TOKENS / 9.0)
    assert _read("answer_p95_ms", run) == pytest.approx(1000.0)
    close = run.close()
    assert close["open"] == 1 and close["stalled"] is False
    assert close["tail_gap_ms"] == pytest.approx(1000.0)
    assert close["open_age_max_ms"] == pytest.approx(1000.0)


@pytest.mark.parametrize("t_end", [14.0, 30.0])
def test_a_stall_before_the_close_counts(t_end):
    reqs = [_answer(i, i + 1.0) for i in range(5)]
    reqs.append(Request(0, "q", 5.0, t_gen_start=5.01))  # never answered
    run = _run(reqs, t_end)
    assert run.stalled
    assert _read("answer_tokens_per_s", run) == pytest.approx(
        5 * TOKENS / t_end)
    # the open question's age enters the tail: 6 latencies, p95 near it
    lat = sorted([1000.0] * 5 + [(t_end - 5.0) * 1e3])
    assert _read("answer_p95_ms", run) == pytest.approx(
        lat[4] + (lat[5] - lat[4]) * 0.75)
    assert run.close()["open_age_max_ms"] == pytest.approx((t_end - 5) * 1e3)


def test_a_failed_question_is_not_open():
    reqs = _steady()
    reqs[-1].error = "TimeoutError: retrieval"
    run = _run(reqs)
    assert run.open_ages == [] and not run.stalled
