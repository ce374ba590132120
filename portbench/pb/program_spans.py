"""The program's own spans and counters (``neuray_tpu_torch/utils/
profiling.py: recorded``, kept while the traced window's profiler ran)
read against the window's device rows.

- busy: a span's busy time is the overlap of its device interval (a pair
  of CUDA events on the stream, placed on the host clock by the
  recorder's anchor) with the union of the window's device rows.
- idle: each idle gap of the device in the window (as ``Trace.idle_gaps``
  finds them) goes to the innermost program span open on the host when
  the gap began, and through it to every span around that one; a gap
  that began outside any program span is ``outside``.

Only spans that overlap the window on the host clock are kept. A program
without the recorder (an earlier commit) gives None, and each reader
then leaves its metric out of the line, as it does where the window
recorded no span or counter of its name.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from pb import counts


def recorded():
    """The program's ``Recorded`` (spans, counters), or None where the
    program has no recorder."""
    try:
        from neuray_tpu_torch.utils.profiling import recorded as read
    except ImportError:
        return None
    return read()


class ProgramSpans:
    """The recorded spans and counters of one traced window, and the
    busy and idle time they account for."""

    def __init__(self, rec, trace):
        self.trace = trace
        self.counters: Dict[str, float] = dict(rec.counters)
        self.spans = rec.spans
        self.kept = [i for i, s in enumerate(rec.spans)
                     if s.host[1] > trace.t0 and s.host[0] < trace.t1]
        self.busy = trace.busy_intervals()
        self.starts = [s for s, _ in self.busy]
        self.ends = [e for _, e in self.busy]
        self.cum = [0]
        for s, e in self.busy:
            self.cum.append(self.cum[-1] + e - s)
        self.innermost, self.within, self.outside = self._idle()

    def names(self) -> set:
        return {self.spans[i].name for i in self.kept}

    def overlap_ns(self, a: int, b: int) -> int:
        """The device's busy ns inside [a, b]."""
        i = bisect.bisect_right(self.ends, a)
        j = bisect.bisect_left(self.starts, b)
        if i >= j:
            return 0
        return (self.cum[j] - self.cum[i] - max(0, a - self.starts[i])
                - max(0, self.ends[j - 1] - b))

    def busy_ns(self, name: str) -> Optional[int]:
        """The busy ns of the device intervals of the spans ``name``;
        None where none has a device interval."""
        intervals = [self.spans[i].device for i in self.kept
                     if self.spans[i].name == name
                     and self.spans[i].device is not None]
        if not intervals:
            return None
        return sum(self.overlap_ns(a, b) for a, b in intervals)

    def gaps(self) -> List[Tuple[int, int]]:
        out, t = [], self.trace.t0
        for s, e in self.busy:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.trace.t1 > t:
            out.append((t, self.trace.t1))
        return out

    def _idle(self):
        """(ns by innermost span, ns by every span open at the gap's
        start, ns outside any span)."""
        events = sorted(
            [(self.spans[i].host[0], 1, i) for i in self.kept]
            + [(self.spans[i].host[1], 0, i) for i in self.kept])
        innermost: Dict[str, int] = defaultdict(int)
        within: Dict[str, int] = defaultdict(int)
        outside, k = 0, 0
        # the open spans by (start, index): a thread's spans nest, so the
        # last begun is the innermost
        open_: Dict[int, Tuple[int, int]] = {}
        for gs, ge in self.gaps():
            while k < len(events) and events[k][0] <= gs:
                t, starts, i = events[k]
                if starts:
                    open_[i] = (t, i)
                else:
                    open_.pop(i, None)
                k += 1
            if not open_:
                outside += ge - gs
                continue
            inner = max(open_, key=open_.get)
            innermost[self.spans[inner].name] += ge - gs
            chain, p = set(), inner
            while p is not None:
                chain.add(self.spans[p].name)
                p = self.spans[p].parent
            for name in chain:
                within[name] += ge - gs
        return dict(innermost), dict(within), outside

    def idle_ns(self, name: str) -> Optional[int]:
        """The device's idle ns in gaps that began while a span ``name``
        was open; None where the window kept no such span."""
        if name not in self.names():
            return None
        return self.within.get(name, 0)


def read(readout) -> Optional[ProgramSpans]:
    """The window's ``ProgramSpans``, made once a run; None where the
    program recorded nothing."""
    if "program_spans" not in readout.__dict__:
        rec = recorded()
        readout.program_spans = (
            ProgramSpans(rec, readout.trace)
            if rec is not None and (rec.spans or rec.counters) else None)
    return readout.program_spans


def per(readout, ns: Optional[int], unit: str) -> Optional[float]:
    """ns over the window's ``unit`` count (``frames``, ``steps``), in
    ms."""
    n = readout.counters.get(unit)
    return None if ns is None or not n else ns / 1e6 / n


def busy_ms(readout, name: str, unit: str) -> Optional[float]:
    ps = read(readout)
    return None if ps is None else per(readout, ps.busy_ns(name), unit)


def idle_ms(readout, name: str, unit: str) -> Optional[float]:
    ps = read(readout)
    return None if ps is None else per(readout, ps.idle_ns(name), unit)


def counted_roofline_pct(readout, key: str, kernels) -> Optional[float]:
    """The bytes the program counted at its launches (counter ``key``)
    over 3.35 TB/s, against the summed device time of the rows whose
    name holds any of ``kernels``, in %."""
    ps = read(readout)
    nbytes = None if ps is None else ps.counters.get(key)
    busy = readout.trace.kernel_s(*kernels)
    if not nbytes or busy <= 0:
        return None
    return 100.0 * nbytes / counts.HBM_BYTES_PER_S / busy
