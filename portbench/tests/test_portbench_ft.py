"""The finetuning cell (``ft_depth.sphere``) at a CPU test's size: a sound
run is correct and its check reads every number the workload file
limits; each planted fault, in the reference put in the program's place
(``ft_steps.fault``) and in the program itself, and the TF32 control
fail at least one limit; the cell's files are found by name and its
configuration is the shipped YAML's; its readers read a hand-built
window and give None where nothing was recorded."""
import copy
import time
import types

import numpy as np
import pytest
import torch

from pb import core, program_spans as PS, trace

MS = 1_000_000
CELL = "ft_depth.sphere"
METRICS = ("idle_share.ft", "mfu.ft", "encode_busy_ms.ft",
           "update_counted_roofline.ft", "gather_bwd_counted_roofline.ft")


def tiny():
    """The cell at a test's size: 8 views of 128x128 (each query's 7
    others its reference views), 64 rays, 16 + 16 samples."""
    wl = copy.deepcopy(core.load_json(core.HERE / "workloads"
                                      / f"{CELL}.json"))
    wl["traffic"].update(train_views=8, size=128)
    wl["route"] = {"train_ray_num": 64, "depth_sample_num": 16,
                   "fine_depth_sample_num": 16}
    return wl


def run_tiny(seed=2 ** 33 + 5):
    numbers = {}
    res, checks = core.run(CELL, seed, 0.1, False, time.perf_counter(),
                           need_cuda=False, workload=tiny(), numbers=numbers)
    return res, checks, numbers["program"]


def generator():
    return core.load_module(core.HERE / "traffic" / "ft_steps.py", "ft")


def test_sound_run_is_correct_and_reads_every_limit():
    res, checks, numbers = run_tiny()
    assert res["correct"], res["checks"]
    assert {c.name for c in checks} == set(tiny()["check"]) <= set(numbers)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"steps_per_s", "setup_s"}
    assert numbers["untouched_change"] == 0.0


@pytest.mark.parametrize("fault", ["no_consist", "frozen_ray_feats",
                                   "shifted_views", "tf32"])
def test_reference_faults_and_control_fail_a_limit(fault):
    wl = tiny()
    ctx = core.Ctx(CELL, 7, 0, False, time.perf_counter(), wl)
    g = generator()
    numbers = (g.control(ctx, 1, fault) if fault == "tf32"
               else g.fault(ctx, fault))
    assert not all(c.ok for c in core.limited(numbers, wl["check"])), numbers


def plant(monkeypatch, fault):
    """The fault in the port: the consistency loss dropped, Adam built
    without ``ray_feats``, or each step's reference views shifted by
    one."""
    from neuray_tpu_torch.models.ft import FtRenderer
    from neuray_tpu_torch.train.ft_trainer import FtTrainer
    if fault == "no_consist":
        real = FtTrainer._losses

        def losses(self, batch):
            return {k: v for k, v in real(self, batch).items()
                    if not k.startswith("loss_prob")}
        monkeypatch.setattr(FtTrainer, "_losses", losses)
    elif fault == "frozen_ray_feats":
        def build(self):
            self.params = [p for n, p in self.model.named_parameters()
                           if n != "ray_feats"]
            self.optimizer = torch.optim.Adam(self.params, lr=1e-4)
            self.opt_count = 0
        monkeypatch.setattr(FtTrainer, "build_optimizer", build)
    else:
        real = FtRenderer.forward

        def forward(self, ref_idx, *args, **kwargs):
            shifted = (np.asarray(ref_idx) + 1) % len(self.ref_ids)
            return real(self, shifted, *args, **kwargs)
        monkeypatch.setattr(FtRenderer, "forward", forward)


@pytest.mark.parametrize("fault", ["no_consist", "frozen_ray_feats",
                                   "shifted_views"])
def test_program_faults_are_caught(monkeypatch, fault):
    plant(monkeypatch, fault)
    res, _, _ = run_tiny()
    assert res["correct"] is False, res["checks"]


def test_the_cells_files_are_found_by_name():
    spec = core.load_json(core.ROOT / "BENCHMARK.json")
    cell = next(w for w in spec["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 1 and cell["traffic"] == "ft_steps"
    assert (core.HERE / "traffic" / "ft_steps.py").exists()
    assert (core.HERE / "configs" / f"{cell['config']}.json").exists()
    declared = [m for m in spec["per_layer"] if CELL in m["workloads"]]
    assert sorted(m["name"] for m in declared) == sorted(METRICS)
    for m in declared:
        assert m["workloads"] == [CELL] and m["moves"] == "steps_per_s"
        assert callable(core.load_module(core.HERE / "metrics"
                                         / f"{m['name']}.py", "m").read)
    e2e = {m["name"] for m in spec["end_to_end"]
           if CELL in m.get("workloads", [CELL])}
    assert e2e == {"steps_per_s", "setup_s"}


def test_the_configuration_is_the_shipped_yaml():
    from neuray_tpu_torch.models.ft import FT_DEFAULT_CFG
    from neuray_tpu_torch.utils.config import load_cfg
    cfg = core.load_json(core.HERE / "configs" / "neuray_ft_depth_lego.json")
    yaml = load_cfg(str(core.ROOT / "configs" / "train" / "ft"
                        / "neuray_ft_depth_lego.yaml"))
    assert cfg["train"] == yaml
    for k, v in cfg["ft_defaults"].items():
        assert FT_DEFAULT_CFG.get(k, v) == v, k
    assert cfg["reduced"] == []


def hand_built():
    """A 20 ms window of two steps: device rows 1-4 (the encode), 6-7 and
    9-12 ms (Adam), 15-19 ms (a backward gather)."""
    from neuray_tpu_torch.utils.profiling import Recorded, Span
    kernels = [("implicit_convolve_sgemm", 1 * MS, 4 * MS),
               ("multi_tensor_apply_kernel", 6 * MS, 7 * MS),
               ("multi_tensor_apply_kernel", 9 * MS, 12 * MS),
               ("bin_points", 15 * MS, 19 * MS)]
    tr = trace.Trace(kernels, [], (0, 20 * MS))
    spans = [Span("step.forward", None, (0, 5 * MS), (0, 5 * MS)),
             Span("ft.encode", 0, (0, 3 * MS), (0, 3 * MS)),
             Span("step.update", None, (5 * MS, 8 * MS), (5 * MS, 8 * MS)),
             Span("step.update", None, (8 * MS, 13 * MS), (8 * MS, 13 * MS))]
    return Recorded(spans, {"adam.bytes": 3.35e12 * 0.002,
                            "gather.bwd_bytes": 3.35e12 * 0.001}), tr


@pytest.mark.parametrize("name,value", [
    ("encode_busy_ms.ft", 1.0), ("update_counted_roofline.ft", 50.0),
    ("gather_bwd_counted_roofline.ft", 25.0), ("idle_share.ft", 45.0)])
def test_readers_read_a_hand_built_window(monkeypatch, name, value):
    rec, tr = hand_built()
    monkeypatch.setattr(PS, "recorded", lambda: rec)
    readout = types.SimpleNamespace(trace=tr, counters={"steps": 2})
    reader = core.load_module(core.HERE / "metrics" / f"{name}.py", "m")
    assert reader.read(readout) == pytest.approx(value)


@pytest.mark.parametrize("name", METRICS[2:])
@pytest.mark.parametrize("what", ["no recorder", "other names"])
def test_readers_give_none_where_nothing_was_recorded(monkeypatch, name,
                                                      what):
    from neuray_tpu_torch.utils.profiling import Recorded, Span
    _, tr = hand_built()
    rec = (None if what == "no recorder" else
           Recorded([Span("step.forward", None, (0, MS), (0, MS))],
                    {"gather.bytes": 1}))
    monkeypatch.setattr(PS, "recorded", lambda: rec)
    readout = types.SimpleNamespace(trace=tr, counters={"steps": 2})
    reader = core.load_module(core.HERE / "metrics" / f"{name}.py", "m")
    assert reader.read(readout) is None


def test_mfu_reads_the_counted_flops():
    _, tr = hand_built()
    readout = types.SimpleNamespace(
        trace=tr, counters={"flops": 67e12 * 0.002},
        workload={}, config={"precision": "f32"})
    reader = core.load_module(core.HERE / "metrics" / "mfu.ft.py", "m")
    assert reader.read(readout) == pytest.approx(10.0)
