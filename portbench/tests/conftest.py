"""The benchmark's own tests: ``python -m pytest portbench/tests -q``
(CPU; the ``cuda`` tests run on a card and skip elsewhere)."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
for p in (str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without a CUDA device")


# each cell's traffic at a size a CPU test run holds (every ray checked)
TINY = {
    "exact_frames": dict(views=4, ref_views=3, poses=3, warmup_rays=64,
                         check_rays=10 ** 6),
    # at 64 x 64 the probe keeps 64 rays whose coarse colours are all 0
    "focus_frames": dict(views=4, view_hw=[128, 128], query_hw=[128, 128],
                         ref_views=3, poses=3, check_rays=10 ** 6),
    "train_steps": dict(pool=4, views=3, view_hw=[64, 96], rays=64,
                        depth_pixels=128),
}


def tiny(name):
    """The cell's workload at a CPU test's size."""
    import copy
    from pb import core
    wl = copy.deepcopy(core.load_json(core.HERE / "workloads"
                                      / f"{name}.json"))
    wl["traffic"].update(TINY[wl["generator"]])
    if wl["generator"] == "exact_frames":
        cv = wl["traffic"]["src_nn"] > 0
        wl["traffic"].update(view_hw=[64, 96] if cv else [64, 64],
                             query_hw=[24, 32], src_nn=2 if cv else 0)
    if wl["generator"] != "train_steps":
        wl["route"] = dict(wl.get("route", {}), ray_batch_num=256)
    return wl


def run_tiny(name, seed=2 ** 33 + 3, workload=None):
    import time
    from pb import core
    return core.run(name, seed, 0.1, False, time.perf_counter(),
                    need_cuda=False, workload=workload or tiny(name))
