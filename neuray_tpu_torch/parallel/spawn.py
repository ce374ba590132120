"""Run a function on ``size`` fresh processes, one a rank, joined into one
process group: the tests' and ``chip_smoke.py``'s stand-in for
``torchrun``. Each rank is a spawned process (a parent's CUDA context
cannot be forked); a rank that fails fails the run, and a run that
outlives its timeout has every rank killed and raises, so a rank that
skips a collective cannot hang the caller."""
from __future__ import annotations

import multiprocessing
import os
import socket
import time
import traceback
from typing import Any, Callable, Sequence

# environment a rank must not inherit from a torchrun-launched caller
_RANK_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
             "MASTER_ADDR", "MASTER_PORT")


def free_port() -> int:
    """A free TCP port on 127.0.0.1 (for a ``tcp://127.0.0.1:<port>``
    rendezvous)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, size: int, init_method: str, device, fn, args,
               errors) -> None:
    from neuray_tpu_torch.parallel.sharding import make_mesh
    import torch.distributed as dist

    for k in _RANK_ENV:
        os.environ.pop(k, None)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(size))
    try:
        mesh = make_mesh(device, init_method, rank, size)
        fn(mesh, *args)
        mesh.barrier()
    except BaseException:
        errors.put((rank, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable[..., Any], size: int, args: Sequence = (),
              timeout: float = 300.0, init_method: str | None = None,
              device=None) -> None:
    """Call ``fn(mesh, *args)`` on ``size`` spawned ranks
    (``make_mesh(device, init_method, rank, size)``; ``init_method``
    defaults to a free TCP port on 127.0.0.1, the tests pass
    ``file://<tmp>``). ``fn`` and ``args`` go by pickle: ``fn`` must be a
    module-level function. Results come back the way ``fn`` writes them
    (files). Raises with the failing rank's traceback when a rank fails,
    and after killing every rank when they have not all ended within
    ``timeout`` seconds."""
    init_method = init_method or f"tcp://127.0.0.1:{free_port()}"
    ctx = multiprocessing.get_context("spawn")
    errors = ctx.SimpleQueue()
    # not daemonic: a rank may start DataLoader workers of its own
    procs = [ctx.Process(target=_rank_main,
                         args=(r, size, init_method, device, fn, tuple(args),
                               errors))
             for r in range(size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{size} ranks did not end within "
                                   f"{timeout:.0f} s; killed")
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    failed = [(r, p.exitcode) for r, p in enumerate(procs)
              if p.exitcode != 0]
    if failed:
        reports = []
        while not errors.empty():
            reports.append("rank %d:\n%s" % errors.get())
        raise RuntimeError(f"ranks failed (rank, exit code): {failed}\n"
                           + "\n".join(reports))
