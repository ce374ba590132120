"""The stage clock of the port's profilers, and a device trace (port of
``neuray_tpu/utils/profiling.py``).

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
  work hold the card back.

A stage on the CPU (``sync`` None or a CPU tensor) has host time only,
and ``report()`` says so.

``device_trace(logdir)`` wraps ``torch.profiler.profile`` (the JAX
package's ``jax.profiler`` trace) and writes a Chrome trace into
``logdir``; with ``None`` it does nothing.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


def _cuda(sync) -> bool:
    if sync is None:
        return False
    if isinstance(sync, (str, torch.device)):
        return torch.device(sync).type == "cuda"
    return bool(getattr(sync, "is_cuda", False))


def _busy_ms(prof) -> float:
    """The summed durations of a profiler session's device rows
    (kernels, memsets, copies; not ``record_function`` ranges), read from
    its raw Kineto events: ``prof.events()`` would build a Python event
    tree of every row first (a frame's ~400k kernels took ~1 min)."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda
               and not e.is_user_annotation()) / 1e6


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """``torch.profiler`` trace of the block (host and, with a card,
    device activity), written to ``logdir/trace_<pid>_<ns>.json`` for
    chrome://tracing or Perfetto. No-op when logdir is None. Yields the
    profiler (None without a logdir)."""
    if logdir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StageTimer:
    """Accumulating host clock for named pipeline stages, with the device
    span (and, with ``busy``, the kernels' busy time) of the stages that
    end on the card. See the module's doc."""

    def __init__(self, busy: bool = False):
        self.busy = busy
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.device_totals: Dict[str, float] = defaultdict(float)
        self.busy_totals: Dict[str, float] = defaultdict(float)

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
                self.busy_totals[name] += _busy_ms(prof)

    def _per_call(self, totals: Dict[str, float], k: str) -> float:
        return totals[k] / max(self.counts[k], 1)

    def summary(self) -> Dict[str, float]:
        """Each stage's mean host seconds a call, as the JAX class's;
        beside it, for a stage timed on the card, ``<stage>_device_ms``
        and, with ``busy``, ``<stage>_busy_ms``."""
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
                line += (f", kernels busy "
                         f"{self._per_call(self.busy_totals, k):.1f} "
                         f"ms/call")
            lines.append(line)
        host_only = sorted(set(self.totals) - set(self.device_totals))
        if host_only:
            lines.append("host clock only (no device time): "
                         + ", ".join(host_only))
        return "\n".join(lines)
