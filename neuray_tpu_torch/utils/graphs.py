"""Eager code replayed from CUDA graphs, cut at the port's spans.

A ``SegmentedGraph`` records a function of CUDA tensors once and replays
it. While it captures (``capture``), every span the function opens or
closes (``utils/profiling.py: span``) ends the graph being captured and
begins the next one, so the recording is the eager code's launches cut
at its spans: graphs sharing one memory pool, with the spans between
them. ``replay`` launches the graphs on the current stream in the order
they were captured, which the shared pool requires, and opens and closes
each span around the graphs inside it: a traced replay records the spans
the eager code records, over the same device work. The host tallies of
that work made while a graph is captured (``profiling.count`` and what
``profiling.per_launch`` wraps, as the gather's launch count) are kept
with the graph and made again at each of its replays, not at the
capture.

The captured code reads and writes fixed addresses: the caller copies
new inputs into the tensors the function read when it was captured,
and copies out what a replay wrote before the next replay overwrites it.
``record`` runs the function once eagerly before its capture, both on a
side stream, as ``torch.cuda.graph`` asks: the lazy set-up (cuBLAS's
workspace for that stream, the gather's library) happens outside the
capture. A graph that captured no work (the stretch after the last span
closes) is dropped.
"""
from __future__ import annotations

import contextlib
import warnings
from typing import Callable, Dict, List

import torch

from neuray_tpu_torch.utils import profiling as P

# the side stream of each device that records run on
_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


@contextlib.contextmanager
def _side_stream():
    """The block on the current device's side stream, after the current
    stream's work so far and before its work after the block."""
    current = torch.cuda.current_stream()
    side = _STREAMS.get(current.device)
    if side is None:
        side = _STREAMS[current.device] = torch.cuda.Stream(current.device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        yield
    current.wait_stream(side)


class _Cut:
    """A span met while capturing: the graph ends where it opens and
    where it closes."""
    __slots__ = ("graph", "name")

    def __init__(self, graph: "SegmentedGraph", name: str):
        self.graph, self.name = graph, name

    def __enter__(self):
        self.graph._cut(self.name)
        return self

    def __exit__(self, *exc):
        self.graph._cut(None)
        return False


class SegmentedGraph:
    """One function's launches as CUDA graphs cut at its spans (see the
    module's doc)."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        # a graph and its tallies, a span's name (it opens), or None (the
        # innermost open span closes)
        self.steps: List = []
        self._graph = None
        self._tally: List = []

    def record(self, fn: Callable[[], Dict[str, torch.Tensor]]):
        """Run ``fn()`` eagerly, then capture it, on the side stream.
        Returns (the eager run's dict of tensors, the captured run's:
        tensors of the pool that each replay writes)."""
        with _side_stream():
            eager = fn()
            static = self.capture(fn)
        current = torch.cuda.current_stream()
        for v in eager.values():
            v.record_stream(current)
        return eager, static

    def capture(self, fn: Callable):
        """Capture ``fn()`` on the current stream (a side stream: the
        default stream cannot be captured); returns its result."""
        with P.capturing(self):
            self._begin()
            try:
                return fn()
            finally:
                self._end()

    def replay(self) -> None:
        """Launch the graphs in order on the current stream, each span
        open around its graphs, and make each graph's tallies."""
        spans = []
        for step in self.steps:
            if isinstance(step, tuple):
                graph, tally = step
                graph.replay()
                for fn, args in tally:
                    fn(*args)
            elif step is None:
                spans.pop().__exit__(None, None, None)
            else:
                spans.append(P.span(step))
                spans[-1].__enter__()

    # ---------------- while capturing ----------------

    def boundary(self, name: str) -> _Cut:
        return _Cut(self, name)

    def tally(self, fn: Callable, args: tuple) -> None:
        self._tally.append((fn, args))

    def _cut(self, step) -> None:
        self._end()
        self.steps.append(step)
        self._begin()

    def _begin(self) -> None:
        self._graph, self._tally = torch.cuda.CUDAGraph(), []
        self._graph.capture_begin(pool=self.pool)

    def _end(self) -> None:
        # torch warns of a graph that captured nothing; it is dropped
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            self._graph.capture_end()
        empty = False
        for w in caught:
            if "empty" in str(w.message):
                empty = True
            else:
                warnings.warn(w.message, w.category)
        if not empty:
            self.steps.append((self._graph, self._tally))
        self._graph = None
