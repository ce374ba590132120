"""Readings for the limits of a cell's output checks (see PERF.md):

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \
        [--program-seconds 1] [--control tf32] [--frames 1]

For each seed, in one process: the program's readings (a run of the cell
with a short window, its checks' numbers), and the control's (the plain
reference at the lower precision ``--control`` in the program's place,
on the same inputs, frames and rays). Prints one JSON line a seed. The
benchmark's runs never run it."""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(Path(__file__).resolve().parent.parent))

from pb import core  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program-seconds", type=float, default=0.0)
    ap.add_argument("--control", default="")
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    ctx0 = core.Ctx(args.workload, 0, 0, False, time.perf_counter())
    generator = core.load_module(
        core.HERE / "traffic" / f"{ctx0.workload['generator']}.py",
        f"traffic_{ctx0.workload['generator']}")
    for seed in args.seeds:
        line = {"seed": seed}
        if args.program_seconds > 0:
            t = time.perf_counter()
            res, _ = core.run(args.workload, seed, args.program_seconds,
                              False, t, numbers=line)
            line["frames_or_steps"] = res["attempted"]
            line["metrics"] = {k: v["value"]
                               for k, v in res["metrics"].items()}
        ctx = core.Ctx(args.workload, seed, 0, False, time.perf_counter())
        if args.control:
            line["control_" + args.control] = generator.control(
                ctx, args.frames, args.control)
        for fault in filter(None, args.faults.split(",")):
            line["fault_" + fault] = generator.fault(ctx, fault)
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
