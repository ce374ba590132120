"""One step of the port's bench-weights trainer under ``--init
cost_volume`` against ``tools/make_bench_weights.py``'s, held as
``tests/test_torch_port_bench_weights.py`` holds the depth init's steps
(its module docstring): MVSNet's probability conv sharpened (x1000,
hazard i), JAX's fine depths handed across, every leaf to JAX's at 2e-3
under JAX's masks of every ReLU of the step (the cost volume's branches
included), the ResNets' own steps against their f64 replays. A file of
its own: the cost-volume step compiles apart from the depth init's.
"""
import torch

from tests.test_torch_port_bench_weights import (  # noqa: F401
    JaxTool, PortTool, _highest_precision, check_step)

torch.set_num_threads(1)


def test_cost_volume_step(monkeypatch):
    tool = JaxTool("blobs", "cost_volume")
    port = PortTool(monkeypatch, tool, "blobs", "cost_volume")
    worst = check_step(port, 0)
    _, grads, _ = port.gradients(0)
    # MVSNet takes no gradient in either package
    assert all(not v.any() for k, v in grads.items()
               if k.startswith("init_net.mvsnet"))
    print("cost volume step 1: " + ", ".join(
        f"{k} {v:.3g}" for k, v in worst.items()))
