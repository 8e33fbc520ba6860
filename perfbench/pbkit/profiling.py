"""The trace run's profiler: ``torch.profiler`` over a slice just past
the window, in which the closed loop runs on as it ran in it; the slice
starts and ends between two answers, so that every prefill and every
retrieval in it is whole.  What it keeps: each device
activity's name and interval, the host phase around each idle gap, and
the answers and flushes the slice holds."""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from pbkit.loop import Hooks


@dataclass
class Profile:
    t_start: float = 0.0                 # host clock, perf_counter
    t_stop: float = 0.0
    kernels: list = field(default_factory=list)   # (name, start_us, dur_us)
    phases: list = field(default_factory=list)    # (name, start_us, end_us)
    answers: list = field(default_factory=list)   # loop.Request

    @property
    def window_s(self) -> float:
        return self.t_stop - self.t_start

    def busy_s(self) -> float:
        """Seconds in which some device activity ran (their union)."""
        spans = sorted((s, s + d) for _, s, d in self.kernels)
        total, end = 0.0, None
        for s, e in spans:
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e6

    def idle_gaps(self, min_us: float = 20.0) -> list[tuple[str, float, float]]:
        """(host phase, start_us, length_us) of every gap between device
        activities longer than ``min_us``, the phase being the generator's
        annotation at the gap's middle."""
        spans = sorted((s, s + d) for _, s, d in self.kernels)
        gaps, end = [], None
        for s, e in spans:
            if end is not None and s - end > min_us:
                gaps.append((end, s - end))
            end = e if end is None else max(end, e)
        out = []
        for start, length in gaps:
            mid = start + length / 2
            label = next((n for n, a, b in self.phases if a <= mid <= b),
                         "pb.outside_phases")
            out.append((label, start, length))
        return out


class ProfilerHooks(Hooks):
    """Profiles a slice of ``length_s`` just past the window: the loop
    keeps running as it ran in the window (``active``), the profiler is
    started at its first answer boundary after the window's end (its
    start, seconds of device-tracing set-up, falls between two answers
    and outside the window) and stopped at the first boundary
    ``length_s`` later with an answer in the slice.  Nothing in the
    window itself runs under the profiler."""

    LIMIT_S = 60.0  # the extension ends by then whatever happened

    def __init__(self, length_s: float):
        self.length_s = length_s
        self.t_end = float("inf")  # set by ``window``
        self.recording = False
        self.finished = False
        self.profile = Profile()
        self.prof = None

    def window(self, t_end: float) -> None:
        self.t_end = t_end

    def active(self, now: float) -> bool:
        return not self.finished and now < self.t_end + self.LIMIT_S

    def between(self, now: float) -> None:
        if self.finished or now < self.t_end:
            return
        if self.prof is None:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            torch.cuda.synchronize()
            self.recording = True
            self.profile.t_start = time.perf_counter()
        elif (now - self.profile.t_start >= self.length_s
              and self.profile.answers):
            self.stop()

    def phase(self, name: str):
        if not self.recording:
            return super().phase(name)
        return torch.profiler.record_function(name)

    def answered(self, req) -> None:
        if self.recording:
            self.profile.answers.append(req)

    def stop(self) -> None:
        """Stop recording (at a boundary, or when the loop has ended) and
        keep the slice's device activities and phases."""
        self.finished = True
        if self.prof is None:
            return
        torch.cuda.synchronize()
        self.profile.t_stop = time.perf_counter()
        self.recording = False
        self.prof.stop()
        for e in self.prof.events():
            name = e.name
            start, end = e.time_range.start, e.time_range.end
            if e.device_type == torch.autograd.DeviceType.CPU:
                if name.startswith("pb."):
                    self.profile.phases.append((name, start, end))
            elif not name.startswith("pb."):
                self.profile.kernels.append((name, start, end - start))
        self.prof = None
