"""One run of one cell: find the cell, its configuration and its traffic
generator by name, refuse a machine without the cards it asks for, set up,
measure, check the outputs against the plain reference, read the
per-layer metrics from a traced window, and print the result line.

The cell is ``workloads/<name>.json`` (its configuration, generator, traffic
parameters and the limits of its checks), its configuration
``configs/<config>.json``, its generator ``traffic/<generator>.py`` and each
per-layer metric ``metrics/<metric>.py``, all under this folder; which
metrics a cell reports comes from ``BENCHMARK.json`` at the root of the
checkout. A generator's ``run(ctx)`` returns a ``Measured``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parents[1]          # portbench/
ROOT = HERE.parent                                    # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "neuray_tpu")


class Refused(RuntimeError):
    """A run that must print no result (exit code 2)."""


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


def limited(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> List[Check]:
    """Each number the cell's ``check`` gives a limit, beside it; a
    generator may read more (``control.py`` prints them all)."""
    missing = set(limits) - set(numbers)
    if missing:
        raise Refused(f"the check read no {sorted(missing)}")
    return [Check(k, float(numbers[k]), float(limits[k])) for k in limits]


@dataclasses.dataclass
class Measured:
    """What a generator hands back: its end-to-end values, the attempted and
    failed frames or steps, the set-up seconds, what the per-layer
    readers read (``counters``, ``spans`` of seconds), the window, a
    ``release`` that frees the program's state and a ``check`` that
    then compares its outputs with the reference (-> {number: value})."""
    e2e: Dict[str, float]
    attempted: int
    failed: int
    setup_s: float
    window: object
    counters: Dict[str, float]
    spans: Dict[str, List[float]]
    check: Callable[[], Dict[str, float]]
    release: Callable[[], None] = lambda: None


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise Refused(f"no such file: {path.relative_to(ROOT)}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def sha256(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


class Ctx:
    """What a generator gets: the cell (``workload``), its configuration
    (``config``), the seed, the window's length, whether it is traced,
    and the helpers ``weights_path`` and ``window``."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool,
                 t_start: float, workload: Optional[dict] = None):
        self.name = name
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.t_start = t_start
        self.workload = (workload if workload is not None else
                         load_json(HERE / "workloads" / f"{name}.json"))
        self.config = load_json(HERE / "configs"
                                / f"{self.workload['config']}.json")
        self.marks = [("start", t_start)]

    def mark(self, name: str) -> None:
        """The end of a part of the set-up (printed to standard error)."""
        self.marks.append((name, time.perf_counter()))

    def setup_parts(self) -> str:
        return ", ".join(f"{b[0]} {b[1] - a[1]:.2f} s"
                         for a, b in zip(self.marks, self.marks[1:]))

    def weights_path(self) -> Path:
        """The configuration's weight file, refused unless it is the file
        the configuration names by its hash."""
        path = ROOT / self.config["weights"]
        if not path.exists():
            raise Refused(f"weights {self.config['weights']} not found")
        if sha256(path) != self.config["weights_sha256"]:
            raise Refused(f"{self.config['weights']} is not the file the "
                          "configuration was measured with")
        return path

    def setup_s(self) -> float:
        return time.perf_counter() - self.t_start

    def window(self, sync):
        from pb.trace import Window
        return Window(self.trace, sync)


def power_limit() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return None


def cell_metrics(name: str, trace: bool) -> List[dict]:
    """The metrics BENCHMARK.json asks this cell for: its end-to-end
    metrics untraced, its per-layer metrics traced."""
    spec = load_json(ROOT / "BENCHMARK.json")
    return [m for m in spec["per_layer" if trace else "end_to_end"]
            if name in m.get("workloads", [name])]


class Readout:
    """What a per-layer reader reads: the trace, the generator's counters
    and spans, the cell and its configuration."""

    def __init__(self, ctx: Ctx, measured: Measured):
        self.trace = measured.window.trace
        self.counters = measured.counters
        self.spans = measured.spans
        self.workload = ctx.workload
        self.config = ctx.config


def p95(values: List[float]) -> float:
    return statistics.quantiles(values, n=20, method="inclusive")[-1]


def run(name: str, seed: int, seconds: float, trace: bool,
        t_start: float, need_cuda: bool = True,
        workload: Optional[dict] = None,
        numbers: Optional[dict] = None) -> Tuple[dict, List[Check]]:
    """One run; returns (result line, checks). ``need_cuda`` False and a
    ``workload`` in place of the cell's file (the CPU tests alone) skip
    the look for cards and run at the given sizes on the CPU; ``numbers``
    receives every number the check read (``control.py``)."""
    import torch
    ctx = Ctx(name, seed, seconds, trace, t_start, workload)
    chips = int(ctx.workload.get("chips", 1))
    if need_cuda:
        if not torch.cuda.is_available():
            raise Refused("no CUDA device")
        if torch.cuda.device_count() < chips:
            raise Refused(f"the cell needs {chips} card(s), "
                          f"{torch.cuda.device_count()} present")
    if not (ROOT / "neuray_tpu_torch").is_dir():
        raise Refused("the program (neuray_tpu_torch) is not in this "
                      "checkout")
    wanted = cell_metrics(name, trace)
    generator = load_module(HERE / "traffic" / f"{ctx.workload['generator']}.py",
                         f"traffic_{ctx.workload['generator']}")
    ctx.mark("imports")
    measured: Measured = generator.run(ctx)
    print(f"setup: {ctx.setup_parts()}", file=sys.stderr)
    cuda = need_cuda and torch.cuda.is_available()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    metrics = {}
    if trace:
        readout = Readout(ctx, measured)
        for m in wanted:
            reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                 f"metric_{m['name'].replace('.', '_')}")
            value = reader.read(readout)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        values = dict(measured.e2e, setup_s=measured.setup_s)
        for m in wanted:
            if m["name"] not in values:
                raise Refused(f"the generator gave no {m['name']}")
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    device = {"platform": "gpu" if cuda else "cpu", "kind": kind,
              "count": chips, "memory_peak_bytes": int(peak),
              "power_limit_w": power_limit() if cuda else None}
    result = {"correct": None, "attempted": measured.attempted,
              "failed": measured.failed, "metrics": metrics,
              "device": device}
    if trace:
        tr = measured.window.trace
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        print("trace: first device row %.3f ms after the window opened, "
              "last ends %.3f ms before it closed; %d rows"
              % (*tr.edges_ms(), len(tr.kernels)), file=sys.stderr)
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    measured.window.trace = None
    measured.release()
    read = measured.check()
    if numbers is not None:
        numbers["program"] = read
    checks = limited(read, ctx.workload["check"])
    # what the port loaded in this process, whatever the sources import
    bad = forbidden_modules()
    if bad:
        raise Refused("modules of JAX or the JAX package were loaded: "
                      + ", ".join(bad))
    result["correct"] = bool(measured.failed == 0 and checks
                             and all(c.ok for c in checks))
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result, checks


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse
    from pb.trace import NoDeviceRows
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache of the run lies inside the checkout
    cache = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    try:
        result, checks = run(args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start)
    except (Refused, NoDeviceRows) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
