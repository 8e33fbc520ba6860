"""One clock for the program's spans and the profiled slice, and the
slice's idle time split by what the generator thread was doing.

The program's spans (``repro_torch.obs.trace``) are on
``time.perf_counter``; the slice's device activities and the loop's
phases (``pbkit/profiling.Profile``) are on the profiler's clock, in µs
from its trace's start.  Every ``generate`` span lies inside the
``pb.generate`` phase that ``pbkit/loop.py`` opens around the call, so
each pair, taken in time order, bounds the offset (profiler time =
host time + offset) to [phase start − span start, phase end − span
end].  Each answer's spans are mapped with the midpoint of its own
interval, which absorbs a slow drift between the two clocks over the
slice; a time between answers (the slice's ends) takes the nearest
answer's offset.  The interval's half-width is the profiler's own cost
of opening and closing a phase with device tracing on, with the Python
call between phase and span: 46–122 µs on the H100's host.  A state
boundary may then lie anywhere within one half-width of where it is
mapped, so the idle time there could belong to either side.  Where that
time could move the smallest share by more than ``MAX_UNCERTAIN_SHARE``
of itself, or an answer has no enclosing phase, or an interval is empty,
there is no split: None, never a guess.

Idle is what ``metrics/device_idle.py`` counts: no kernel, copy or
memset on the card.  Each idle µs of the mapped slice goes to one state
of the generator thread: ``in_step``, inside a ``token_readback`` (the
card idle between the step's own kernels while the host waits for its
token); ``host``, inside ``generate`` but not in a readback (packing,
launching, Python between steps); ``between_answers``, outside
``generate`` (waiting on retrieval).  The three add up to the mapped
slice's idle share by construction.

No metric reads the split yet: under device tracing a decode graph's
launch takes 15.6–27.0 ms against 0.37–0.57 ms in the window outside
the profiled slice (H100), so the slice's ``host`` share is mostly the profiler's own cost.
It is a diagnosis: call ``idle_split`` on the ``harness.RunData`` of a
``--trace 1`` run, as a metric reader is handed it.
"""
from __future__ import annotations

from dataclasses import dataclass

PHASE = "pb.generate"
SPAN = "generate"
READBACK = "token_readback"
# the most that the idle near a state boundary may be, as a fraction of
# the smallest share: each share is then known to within a quarter of
# itself, which still tells apart readings that differ twofold
MAX_UNCERTAIN_SHARE = 0.25

Intervals = list[tuple[float, float]]


@dataclass
class Answer:
    """One ``generate`` span on the profiler's clock (µs)."""
    start: float
    end: float
    readbacks: Intervals
    offset_us: float
    half_width_us: float


@dataclass
class HostMap:
    answers: list[Answer]
    t_start: float   # the slice's ends on the profiler's clock (µs)
    t_stop: float


def host_map(run) -> HostMap | None:
    """The program's ``generate`` spans of the profiled slice and their
    readbacks, and the slice's ends, on the profiler's clock; None where
    the run has no slice, no such span, or an answer whose phase does
    not enclose its span."""
    prof = run.profile
    if prof is None or prof.window_s <= 0:
        return None
    lo, hi = prof.t_start * 1e9, prof.t_stop * 1e9
    spans = sorted((s for s in run.spans if s.name == SPAN
                    and lo <= s.t0_ns and s.t0_ns + s.dur_ns <= hi),
                   key=lambda s: s.t0_ns)
    phases = sorted((a, b) for name, a, b in prof.phases if name == PHASE)
    if not spans or len(spans) != len(phases):
        return None
    readbacks: dict[int, Intervals] = {s.span_id: [] for s in spans}
    for s in run.spans:
        if s.name == READBACK and s.parent_id in readbacks:
            readbacks[s.parent_id].append((s.t0_ns / 1e3,
                                           (s.t0_ns + s.dur_ns) / 1e3))
    answers = []
    for s, (p0, p1) in zip(spans, phases):
        s0, s1 = s.t0_ns / 1e3, (s.t0_ns + s.dur_ns) / 1e3
        below, above = p0 - s0, p1 - s1
        half = (above - below) / 2
        if half < 0:
            return None
        off = below + half
        answers.append(Answer(s0 + off, s1 + off,
                              [(a + off, b + off)
                               for a, b in readbacks[s.span_id]],
                              off, half))
    return HostMap(answers, prof.t_start * 1e6 + answers[0].offset_us,
                   prof.t_stop * 1e6 + answers[-1].offset_us)


def idle_split(run) -> dict | None:
    """Shares (%) of the mapped slice in which the card is idle, by the
    generator thread's state: ``in_step``, ``host`` and
    ``between_answers``; ``idle``, their sum; and ``uncertain``, the idle
    within one half-width of a state boundary, the most that any share
    can be off by.  None without a map, or where ``uncertain`` exceeds
    ``MAX_UNCERTAIN_SHARE`` of the smallest of the three shares."""
    hm = host_map(run)
    if hm is None or hm.t_stop <= hm.t_start:
        return None
    window = [(hm.t_start, hm.t_stop)]
    busy = _intersect(_merge((s, s + d) for _, s, d in run.profile.kernels),
                      window)
    idle = _complement(busy, hm.t_start, hm.t_stop)
    in_generate = _length(_intersect(
        idle, _merge((a.start, a.end) for a in hm.answers)))
    in_step = _length(_intersect(
        idle, _merge(r for a in hm.answers for r in a.readbacks)))
    edges = _merge((t - a.half_width_us, t + a.half_width_us)
                   for a in hm.answers
                   for t in (a.start, a.end, *(t for r in a.readbacks
                                                for t in r)))
    total = _length(idle)
    share = 100.0 / (hm.t_stop - hm.t_start)
    split = {"in_step": in_step * share,
             "host": (in_generate - in_step) * share,
             "between_answers": (total - in_generate) * share,
             "idle": total * share,
             "uncertain": _length(_intersect(idle, edges)) * share}
    smallest = min(split[k] for k in ("in_step", "host", "between_answers"))
    return (None if split["uncertain"] > MAX_UNCERTAIN_SHARE * smallest
            else split)


def _merge(intervals) -> Intervals:
    """The union of intervals, as sorted disjoint intervals."""
    out: Intervals = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _intersect(xs: Intervals, ys: Intervals) -> Intervals:
    """The intersection of two lists of sorted disjoint intervals."""
    out: Intervals = []
    i = j = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def _complement(xs: Intervals, lo: float, hi: float) -> Intervals:
    """[lo, hi] less sorted disjoint intervals that lie inside it."""
    out: Intervals = []
    t = lo
    for a, b in xs:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out


def _length(xs: Intervals) -> float:
    return sum(b - a for a, b in xs)
