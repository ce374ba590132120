"""Run one benchmark cell of the PyTorch / CUDA port once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for. The last line of standard output is the result (JSON); the last
lines of standard error are the output checks, each number beside its
limit. See PERF.md for the cells and their metrics.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(Path(__file__).resolve().parent.parent))

from pb import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(t_start=T_START))
