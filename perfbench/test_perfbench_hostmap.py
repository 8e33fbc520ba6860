"""``pbkit/hostmap.py`` on a synthetic profiled slice: the program's
spans on the host clock and the profiler's phases and device activities
on a clock of its own, with a planted offset and drift between them.
The offset is recovered within each answer's half-width; an idle gap is
charged to the generator thread's state around it; the three shares add
up to the mapped slice's idle share; where an answer cannot be mapped,
or its half-width could move too much idle between states, there is no
split.  The readers of the generation spans read them."""
from __future__ import annotations

import sys
from dataclasses import dataclass, field
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))

from pbkit import hostmap, spec  # noqa: E402
from pbkit.profiling import Profile  # noqa: E402

H0_US = 5_000_000_000.0       # the slice's start on the host clock (µs)
OFFSET_US = -4_999_876_543.21  # profiler time = host time + offset + drift
ENTER_US, EXIT_US = 3.0, 4.5   # the phase's ends outside the span's
WAIT_US, PACK_US, LAUNCH_US = 8_000.0, 1_000.0, 250.0
PREFILL_US, DECODE_US, GAP_US = 80_000.0, 20_000.0, 10.0


@dataclass
class Span:
    name: str
    trace_id: int
    span_id: int
    parent_id: int
    t0_ns: int
    dur_ns: int
    args: dict = field(default_factory=dict)


@dataclass
class Run:
    """What a metric reader is handed (``harness.RunData``'s fields)."""
    spans: list
    profile: Profile
    t0: float = 0.0
    t_end: float = 1e12

    def spans_named(self, name):
        return [s for s in self.spans if s.name == name]


@dataclass
class Slice:
    run: Run
    stages: dict          # name -> [(host start µs, host end µs)]
    generates: list       # [(host start µs, host end µs)]
    to_prof: object

    def gap(self, *gaps: tuple[float, float]) -> None:
        """Device busy over the whole slice but for each (host time,
        length) of ``gaps`` (µs), given in time order."""
        t = self.to_prof(H0_US) - 1e4
        kernels = []
        for t_us, length_us in gaps:
            a = self.to_prof(t_us)
            kernels.append((f"k{len(kernels)}", t, a - t))
            t = self.to_prof(t_us + length_us)
        hi = self.to_prof(self.run.profile.t_stop * 1e6) + 1e4
        kernels.append((f"k{len(kernels)}", t, hi - t))
        self.run.profile.kernels = kernels


def make_slice(n_answers=5, decode_steps=3, drift=2e-6, enter=ENTER_US,
               exit_=EXIT_US) -> Slice:
    def to_prof(h_us):
        return h_us + OFFSET_US + drift * (h_us - H0_US)

    spans, phases, generates = [], [], []
    stages = {"pack_context": [], "step_launch": [], "token_readback": []}
    ids = iter(range(1, 10_000))
    t = H0_US + 500.0
    for _ in range(n_answers):
        t += WAIT_US
        g0 = t
        sid, tid = next(ids), next(ids)
        kids = []
        t += GAP_US
        for name, length, step in (
                [("pack_context", PACK_US, None),
                 ("step_launch", LAUNCH_US, "prefill"),
                 ("token_readback", PREFILL_US, "prefill")]
                + [("step_launch", LAUNCH_US, "decode"),
                   ("token_readback", DECODE_US, "decode")] * decode_steps):
            kids.append(Span(name, tid, next(ids), sid, round(t * 1e3),
                             round(length * 1e3),
                             {} if step is None else {"step": step}))
            stages[name].append((t, t + length))
            t += length + GAP_US
        spans += kids
        spans.append(Span("generate", tid, sid, 0, round(g0 * 1e3),
                          round((t - g0) * 1e3)))
        generates.append((g0, t))
        phases.append(("pb.generate", to_prof(g0) - enter,
                       to_prof(t) + exit_))
    prof = Profile(t_start=H0_US / 1e6, t_stop=(t + 300.0) / 1e6,
                   phases=phases)
    return Slice(Run(spans, prof), stages, generates, to_prof)


def test_offset_recovered_within_the_half_width():
    """The phase's ends lie ``ENTER_US`` and ``EXIT_US`` outside the
    span's: each answer's offset within its half-width of the planted
    one, at that answer's time."""
    for drift in (0.0, 2e-6, -5e-6):
        sl = make_slice(drift=drift)
        hm = hostmap.host_map(sl.run)
        assert len(hm.answers) == len(sl.generates)
        for a, (g0, g1) in zip(hm.answers, sl.generates):
            true = sl.to_prof((g0 + g1) / 2) - (g0 + g1) / 2
            assert abs(a.offset_us - true) <= a.half_width_us
            assert a.half_width_us == pytest.approx(
                (ENTER_US + EXIT_US) / 2, abs=abs(drift) * 4e5 + 1e-3)
            assert abs(a.start - sl.to_prof(g0)) <= a.half_width_us


@pytest.mark.parametrize("half_us,split", [(10.0, True), (50.0, False)])
def test_no_split_where_the_half_width_could_move_too_much_idle(half_us,
                                                               split):
    """Idle within one half-width of a state boundary could lie on
    either side of it: where it is over ``MAX_UNCERTAIN_SHARE`` of the
    smallest share, there is no split."""
    sl = make_slice(n_answers=2, enter=half_us, exit_=half_us)
    # idle across the end of the first answer's second readback, into
    # the middle of the launch after it (host: GAP_US + LAUNCH_US / 2),
    # and in the middle of the second answer's wait
    _, b = sl.stages["token_readback"][1]
    host_us = GAP_US + LAUNCH_US / 2
    wait = (sl.generates[1][0] - WAIT_US / 2, 2_000.0)
    sl.gap((b - 1_000.0, 1_000.0 + host_us), wait)
    hm = hostmap.host_map(sl.run)
    assert all(a.half_width_us == pytest.approx(half_us, abs=1.0)
               for a in hm.answers)
    got = hostmap.idle_split(sl.run)
    window = hm.t_stop - hm.t_start
    uncertain = 100 * 2 * half_us / window
    assert (uncertain <= hostmap.MAX_UNCERTAIN_SHARE * 100 * host_us / window
            ) == split
    if split:
        assert got["uncertain"] == pytest.approx(uncertain, rel=0.1)
        for state, us in (("in_step", 1_000.0), ("host", host_us),
                          ("between_answers", 2_000.0)):
            assert got[state] == pytest.approx(100 * us / window, rel=1e-3)
    else:
        assert got is None


@pytest.mark.parametrize("where,state", [
    ("token_readback", "in_step"),
    ("pack_context", "host"),
    ("step_launch", "host"),
    ("between", "between_answers"),
])
def test_a_gap_goes_to_the_state_around_it(where, state):
    sl = make_slice()
    length = 120.0
    if where == "between":  # inside the third answer's wait
        start = sl.generates[2][0] - WAIT_US / 2
    else:
        a, b = sl.stages[where][4]
        start = (a + b) / 2 - length / 2
    sl.gap((start, length))
    split = hostmap.idle_split(sl.run)
    hm = hostmap.host_map(sl.run)
    window = hm.t_stop - hm.t_start
    assert split[state] == pytest.approx(100 * length / window, rel=1e-4)
    for other in {"in_step", "host", "between_answers"} - {state}:
        assert split[other] == 0.0


def test_the_shares_add_up_to_the_mapped_slice_idle_share():
    sl = make_slice(n_answers=4, decode_steps=5)
    # the card busy for 70 % of every stage, from 20 % into it, and for
    # a stretch of each wait between answers
    kernels = []
    for spans in sl.stages.values():
        for a, b in spans:
            s = sl.to_prof(a + 0.2 * (b - a))
            kernels.append(("k", s, 0.7 * (b - a)))
    for g0, _ in sl.generates:
        kernels.append(("copy", sl.to_prof(g0 - 6_000.0), 2_000.0))
    sl.run.profile.kernels = kernels
    split = hostmap.idle_split(sl.run)
    assert all(split[k] > 0 for k in ("in_step", "host", "between_answers"))
    assert split["in_step"] + split["host"] + split["between_answers"] == \
        pytest.approx(split["idle"], abs=1e-9)
    # the mapped slice's idle share counted plainly, as device_idle does
    hm = hostmap.host_map(sl.run)
    busy = sum(min(s + d, hm.t_stop) - max(s, hm.t_start)
               for _, s, d in kernels)  # no two overlap here
    window = hm.t_stop - hm.t_start
    assert split["idle"] == pytest.approx(100 * (1 - busy / window),
                                          abs=1e-6)


@pytest.mark.parametrize("fault", ["phase_inside_span", "phase_missing",
                                   "phase_starts_late", "no_spans",
                                   "no_profile"])
def test_no_map_no_split(fault):
    sl = make_slice()
    sl.gap((sl.generates[1][0] + 100.0, 50.0))
    phases = sl.run.profile.phases
    if fault == "phase_inside_span":  # the phase does not enclose it
        name, a, b = phases[2]
        phases[2] = (name, a + 20.0, b - 20.0)
    elif fault == "phase_missing":
        del phases[3]
    elif fault == "phase_starts_late":  # after its span has begun
        name, a, b = phases[1]
        phases[1] = (name, a + 30.0, b)
    elif fault == "no_spans":  # a program without the generation spans
        sl.run.spans = []
    else:
        sl.run.profile = None
    assert hostmap.host_map(sl.run) is None
    assert hostmap.idle_split(sl.run) is None


def test_readers_read_the_split_and_the_spans():
    sl = make_slice(n_answers=3, decode_steps=4)
    a, b = sl.stages["token_readback"][5]
    sl.gap(((a + b) / 2, 200.0))
    split = hostmap.idle_split(sl.run)
    hm = hostmap.host_map(sl.run)
    assert split["in_step"] == pytest.approx(
        100 * 200.0 / (hm.t_stop - hm.t_start), rel=1e-4)
    assert split["host"] == split["between_answers"] == 0
    got = {n: spec.metric_reader(BENCH_DIR, n)(sl.run)
           for n in ("pack_ms.p50", "step_launch_ms.p50")}
    assert got["pack_ms.p50"] == pytest.approx(PACK_US / 1e3)
    assert got["step_launch_ms.p50"] == pytest.approx(LAUNCH_US / 1e3)
    # the decode launches alone: a longer prefill launch moves nothing
    for s in sl.run.spans:
        if s.args.get("step") == "prefill" and s.name == "step_launch":
            s.dur_ns *= 100
    assert spec.metric_reader(BENCH_DIR, "step_launch_ms.p50")(sl.run) == \
        pytest.approx(LAUNCH_US / 1e3)
    # a parent program: no generation spans, no numbers, no error
    sl.run.spans = []
    assert spec.metric_reader(BENCH_DIR, "pack_ms.p50")(sl.run) is None
    assert spec.metric_reader(BENCH_DIR, "step_launch_ms.p50")(sl.run) is None
