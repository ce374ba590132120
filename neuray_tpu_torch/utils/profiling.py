"""The stage clock of the port's profilers (port of
``neuray_tpu/utils/profiling.py``), and the recorder of the spans and
counters the port keeps on its main path.

``StageTimer`` keeps the JAX class's totals, counts, ``summary()`` and
``report()``. A stage given a CUDA tensor or device to ``sync`` is ended
by a synchronize of the current stream, as the JAX class blocks on its
``sync_value``, and is also timed on the device:

- ``device_ms``: the span of a pair of CUDA events recorded on the
  current stream at the stage's start and end. Stages follow a
  synchronize, so the stream is idle when the first event is recorded
  and the span runs from there to the end of the stage's last work. It
  is the host time less the host work before the first launch reaches
  the stream and after the last one ends; where the device waits on the
  host's launches inside the stage, the span still counts the wait.
- ``busy_ms`` (a timer built with ``busy=True``): the summed durations
  of the kernels and memory operations the stage ran, from a
  ``torch.profiler`` session around it (CUPTI). The session costs host
  time, so a profiler that wants both runs a busy pass of its own and
  reads the idle share of a stage as ``1 - busy_ms / host ms`` of its
  unprofiled pass: near 1 where the host's launches, readbacks or numpy
  work hold the card back. A session that gave no device rows leaves
  the stage's busy time not measured (``None``), never 0.

A stage on the CPU (``sync`` None or a CPU tensor) has host time only,
and ``report()`` says so.

The recorder (``span``, ``count``, ``recording``, ``recorded``) keeps the
port's spans at its layers' boundaries and its counters, and only where a
``torch.profiler`` session (of any activity) is active: on the thread
that entered it and on the threads that inherit its state, as autograd's
do. Off, ``span`` is one check and hands back a shared null context,
``count`` one check. The first span or count of a session drops the last
session's records and, on CUDA, synchronizes the current stream once and
records an anchor event with its ``time.time_ns()``; a call on that
thread that finds no session active ends it (two sessions with no call
of the recorder between them read as one). A span keeps its name, its parent
(the span open around it on its thread), its host start and end on
``time.time_ns()`` (the clock Kineto stamps its device rows with) and, on
CUDA, a pair of timing events on the current stream, placed on the host
clock after the session as the anchor's time plus their time from the
anchor. Nothing is recorded while the current stream is being captured
into a CUDA graph (a replay runs no Python), with one exception: under a
segmented capture (``utils/graphs.py``) a span cuts the recording into
graphs and is opened again around them at each replay, and ``count`` and
the tallies wrapped by ``per_launch`` (the gather's launch count) are kept
with the graph being captured and made at each of its replays. What reads
them: ``portbench/pb/program_spans.py``.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch


def _cuda(sync) -> bool:
    if sync is None:
        return False
    if isinstance(sync, (str, torch.device)):
        return torch.device(sync).type == "cuda"
    return bool(getattr(sync, "is_cuda", False))


def _busy_ms(prof) -> Optional[float]:
    """The summed durations of a profiler session's device rows
    (kernels, memsets, copies; not ``record_function`` ranges), read from
    its raw Kineto events: ``prof.events()`` would build a Python event
    tree of every row first (a frame's ~400k kernels took ~1 min). None
    where the session gave no device row: its busy time is not
    measured."""
    cuda = torch.autograd.DeviceType.CUDA
    rows = [e.duration_ns() for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and not e.is_user_annotation()]
    return sum(rows) / 1e6 if rows else None


class StageTimer:
    """Accumulating host clock for named pipeline stages, with the device
    span (and, with ``busy``, the kernels' busy time) of the stages that
    end on the card. See the module's doc."""

    def __init__(self, busy: bool = False):
        self.busy = busy
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.device_totals: Dict[str, float] = defaultdict(float)
        # a stage's summed busy ms; None once a session gave no device row
        self.busy_totals: Dict[str, Optional[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Time the block as stage ``name``. ``sync``: a tensor or device
        the stage's work lies on; on CUDA the stage ends with a
        synchronize of the current stream and is timed on the device too.
        """
        cuda = _cuda(sync)
        prof = contextlib.nullcontext()
        if cuda:
            torch.cuda.current_stream().synchronize()
            if self.busy:
                from torch.profiler import ProfilerActivity, profile
                prof = profile(activities=[ProfilerActivity.CUDA])
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        with prof:
            if cuda:
                start.record()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if cuda:
                    end.record()
                    torch.cuda.current_stream().synchronize()
                self.totals[name] += time.perf_counter() - t0
                self.counts[name] += 1
        if cuda:
            self.device_totals[name] += start.elapsed_time(end)
            if self.busy:
                busy, total = _busy_ms(prof), self.busy_totals.get(name, 0.0)
                self.busy_totals[name] = (None if busy is None or total is None
                                          else total + busy)

    def _per_call(self, totals: Dict[str, Optional[float]],
                  k: str) -> Optional[float]:
        return None if totals[k] is None else totals[k] / max(self.counts[k],
                                                               1)

    def summary(self) -> Dict[str, Optional[float]]:
        """Each stage's mean host seconds a call, as the JAX class's;
        beside it, for a stage timed on the card, ``<stage>_device_ms``
        and, with ``busy``, ``<stage>_busy_ms`` (None where a session gave
        no device row: not measured)."""
        out = {k: self._per_call(self.totals, k) for k in self.totals}
        for k in self.device_totals:
            out[f"{k}_device_ms"] = self._per_call(self.device_totals, k)
        for k in self.busy_totals:
            out[f"{k}_busy_ms"] = self._per_call(self.busy_totals, k)
        return out

    def report(self) -> str:
        """The JAX class's lines, each with the stage's device times where
        it ran on the card; a last line where a stage has host time
        only."""
        lines = []
        for k in sorted(self.totals):
            line = (f"{k}: total {self.totals[k]:.3f}s over "
                    f"{self.counts[k]} calls "
                    f"({self._per_call(self.totals, k) * 1e3:.1f} "
                    f"ms/call)")
            if k in self.device_totals:
                line += (f", device span "
                         f"{self._per_call(self.device_totals, k):.1f} "
                         f"ms/call")
            if k in self.busy_totals:
                busy = self._per_call(self.busy_totals, k)
                line += (", kernels busy not measured" if busy is None
                         else f", kernels busy {busy:.1f} ms/call")
            lines.append(line)
        host_only = sorted(set(self.totals) - set(self.device_totals))
        if host_only:
            lines.append("host clock only (no device time): "
                         + ", ".join(host_only))
        return "\n".join(lines)


# ---------------- the recorder of spans and counters ----------------

_profiling = torch._C._autograd._profiler_enabled


def _capturing() -> bool:
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


class Span(NamedTuple):
    """A recorded span: its ``name``, its ``parent`` (an index into
    ``Recorded.spans``, None at the top of its thread), its ``host`` start
    and end and its ``device`` interval (None off CUDA), in ns on the
    ``time.time_ns()`` clock."""
    name: str
    parent: Optional[int]
    host: Tuple[int, int]
    device: Optional[Tuple[int, int]]


class Recorded(NamedTuple):
    """What the last session kept: its finished spans in the order they
    began, and its counters."""
    spans: List[Span]
    counters: Dict[str, float]


class _Row:
    __slots__ = ("name", "parent", "t0", "t1", "e0", "e1")


class _Recorder:
    """The process's records (see the module's doc)."""

    def __init__(self):
        self.live = False
        self.owner = None
        self.lock = threading.Lock()
        self.local = threading.local()
        self.rows: List[_Row] = []
        self.counters: Dict[str, float] = {}
        self.anchor = None

    def begin(self) -> None:
        with self.lock:
            if self.live:
                return
            self.rows, self.counters, self.anchor = [], {}, None
            if torch.cuda.is_initialized():
                torch.cuda.current_stream().synchronize()
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.anchor = (ev, time.time_ns())
            self.owner = threading.get_ident()
            self.live = True

    def end(self) -> None:
        """No profiler on this thread: the session has ended if this is
        the thread that began it."""
        if threading.get_ident() == self.owner:
            self.live = False

    def open(self, name: str) -> Optional[_Row]:
        if _capturing():
            return None
        if not self.live:
            self.begin()
        stack = self.local.__dict__.setdefault("stack", [])
        row = _Row()
        row.name, row.t1, row.e1 = name, None, None
        row.parent = stack[-1] if stack else None
        row.t0 = time.time_ns()
        row.e0 = None
        if self.anchor is not None:
            row.e0 = torch.cuda.Event(enable_timing=True)
            row.e0.record()
        with self.lock:
            self.rows.append(row)
        stack.append(row)
        return row

    def close(self, row: Optional[_Row]) -> None:
        if row is None:
            return
        if row.e0 is not None:
            row.e1 = torch.cuda.Event(enable_timing=True)
            row.e1.record()
        row.t1 = time.time_ns()
        stack = self.local.stack
        if stack and stack[-1] is row:
            stack.pop()
        elif row in stack:
            stack.remove(row)

    def add(self, name: str, n: float) -> None:
        if _capturing():
            return
        if not self.live:
            self.begin()
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def recorded(self) -> Recorded:
        if self.live and not _profiling():
            self.end()
        with self.lock:
            rows = [r for r in self.rows if r.t1 is not None]
            counters = dict(self.counters)
        index = {id(r): i for i, r in enumerate(rows)}
        if self.anchor is not None and rows:
            torch.cuda.synchronize()
        return Recorded([Span(r.name, index.get(id(r.parent)), (r.t0, r.t1),
                              self.device_ns(r)) for r in rows], counters)

    def device_ns(self, row: _Row) -> Optional[Tuple[int, int]]:
        if row.e0 is None or row.e1 is None:
            return None
        ev, ns = self.anchor
        return tuple(ns + round(ev.elapsed_time(e) * 1e6)
                     for e in (row.e0, row.e1))


_RECORDER = _Recorder()
_OFF = contextlib.nullcontext()
# the segmented capture under way (utils/graphs.py: SegmentedGraph), if any
_capture = None


@contextlib.contextmanager
def capturing(graph):
    """Hand spans and ``per_launch`` tallies to ``graph`` (a
    ``SegmentedGraph`` capturing) inside the block."""
    global _capture
    _capture = graph
    try:
        yield
    finally:
        _capture = None


def per_launch(fn):
    """Wrap ``fn``, a host tally of device work (a counter, a launch
    count): called, it tallies now, or, under a segmented capture, at each
    replay of the graph being captured (which launches that work)."""
    @functools.wraps(fn)
    def tally(*args):
        if _capture is not None:
            _capture.tally(fn, args)
        else:
            fn(*args)
    return tally


class _Span:
    __slots__ = ("name", "row")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.row = _RECORDER.open(self.name)
        return self

    def __exit__(self, *exc):
        _RECORDER.close(self.row)
        return False


def span(name: str):
    """``with span(name):`` a span of the port (see the module's doc);
    a shared null context while no profiler session is active; a cut of
    the recording under a segmented capture."""
    if _capture is not None:
        return _capture.boundary(name)
    if _profiling():
        return _Span(name)
    if _RECORDER.live:
        _RECORDER.end()
    return _OFF


@per_launch
def count(name: str, n: float) -> None:
    """Add ``n`` to the counter ``name`` while a profiler session is
    active."""
    if _profiling():
        _RECORDER.add(name, n)
    elif _RECORDER.live:
        _RECORDER.end()


def recording() -> bool:
    """Whether ``span`` and ``count`` record now (a profiler session is
    active): a caller whose count takes work to reckon asks first."""
    return bool(_profiling())


def recorded() -> Recorded:
    """The spans and counters of the last session (its spans begun since
    its first span or count, finished by now)."""
    return _RECORDER.recorded()
