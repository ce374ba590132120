"""The measured window and, in a traced run, its device trace.

``Window`` times the window on the host clock between two synchronizes
and, with ``trace``, runs one ``torch.profiler`` profile of CUDA
activity alone around it: with host activity on, the profiler's work on
every operator slows the host, and a host-bound path then reads idler
than it runs. The profile's raw Kineto events are read directly
(``prof.events()`` would first build a Python tree of every row): every
kernel, memset and copy on the card. The window's ends and the
benchmark's own host spans (``Window.span``) are taken on the host's
wall clock, ``time.time_ns()``, the clock Kineto stamps its events with;
a trace whose rows do not fall inside the window on that clock is
refused, as is one with no device row: an idle share or a roofline
share read from it would mean nothing.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch


class NoDeviceRows(RuntimeError):
    pass


class Trace:
    """What a traced window recorded: ``kernels`` [(name, start_ns,
    end_ns)] sorted by start, ``spans`` [(name, start_ns, end_ns)], and
    the window ``(t0_ns, t1_ns)`` on the same clock."""

    def __init__(self, kernels, spans, window):
        if not kernels:
            raise NoDeviceRows(
                "the profiler recorded no device row in the window: no "
                "device metric can be read from this run")
        self.kernels = sorted(kernels, key=lambda k: k[1])
        self.spans = spans
        self.t0, self.t1 = window
        inside = sum(1 for _, s, e in self.kernels
                     if self.t0 - 1e9 <= s and e <= self.t1 + 1e9)
        if inside < len(self.kernels) / 2:
            raise NoDeviceRows(
                "the device rows do not fall inside the window on the host "
                "clock: the trace's clock is not the host's")

    def edges_ms(self):
        """(first row's start after the window opened, last row's end
        before it closed), in ms: how the two clocks sit."""
        return ((self.kernels[0][1] - self.t0) / 1e6,
                (self.t1 - max(e for _, _, e in self.kernels)) / 1e6)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device rows, clipped to the window."""
        out: List[Tuple[int, int]] = []
        for _, s, e in self.kernels:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                if e > out[-1][1]:
                    out[-1] = (out[-1][0], e)
            else:
                out.append((s, e))
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_s(self, *needles: str) -> float:
        """Summed device seconds of the rows whose name holds any of
        ``needles``, inside the window."""
        return sum(min(e, self.t1) - max(s, self.t0)
                   for n, s, e in self.kernels
                   if any(x in n for x in needles)
                   and min(e, self.t1) > max(s, self.t0)) / 1e9

    def device_ops(self, n: int = 10):
        """The n device operations that took most time: [[name, s]]."""
        tot: Dict[str, int] = defaultdict(int)
        for name, s, e in self.kernels:
            tot[name] += max(0, min(e, self.t1) - max(s, self.t0))
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10):
        """The device's idle time inside the window, by what the host was
        doing when each gap began (the benchmark span open then, which
        do not nest; ``host`` outside any): [[span, s]], longest total
        first."""
        busy = self.busy_intervals()
        gaps, t = [], self.t0
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.t1 > t:
            gaps.append((t, self.t1))
        spans = sorted(self.spans, key=lambda x: x[1])
        starts = [s[1] for s in spans]
        tot: Dict[str, int] = defaultdict(int)
        for gs, ge in gaps:
            i = bisect.bisect_right(starts, gs) - 1
            label = spans[i][0] if i >= 0 and spans[i][2] > gs else "host"
            tot[label] += ge - gs
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]


def read_trace(prof, window, spans) -> Trace:
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda and not e.is_user_annotation()]
    return Trace(kernels, spans, window)


class Window:
    """``with Window(trace, sync) as w:`` the measured window;
    ``w.elapsed()`` is the host time since it opened, ``w.seconds`` its
    length once closed (both ends after a synchronize of the device),
    ``w.trace`` the traced run's ``Trace``."""

    def __init__(self, trace: bool, sync):
        self.traced = trace
        self.sync = sync
        self.trace = None
        self.spans = []
        self._prof = None

    def __enter__(self):
        if self.traced:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        self.sync()
        self.t0_ns = time.time_ns()
        self.t0 = time.perf_counter()
        return self

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def __exit__(self, *exc):
        self.sync()
        self.seconds = time.perf_counter() - self.t0
        t1_ns = time.time_ns()
        if self.traced:
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self.trace = read_trace(self._prof, (self.t0_ns, t1_ns),
                                        self.spans)
            self._prof = None
        return False

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span of the traced window, by which its idle gaps are
        labelled (nothing untraced)."""
        if not self.traced:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))
