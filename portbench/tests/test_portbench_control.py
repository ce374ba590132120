"""The control of each cell at a test's size: the plain reference in the
program's place, its matrix products and convolutions fed in the
precision below the configuration's (TF32 for f32, fp8 for bf16), comes
out not correct against the cell's limits. (On the card, at the cells'
own sizes, ``control.py`` reads it; PERF.md has the readings.)"""
import time

import pytest
from conftest import tiny

from pb import core

CONTROL = {"gen_depth.exact": "tf32", "gen_cv.exact": "tf32",
           "gen_depth.train": "tf32", "gen_depth.focus": "fp8"}


@pytest.mark.parametrize("cell", sorted(CONTROL))
def test_control_is_not_correct(cell):
    wl = tiny(cell)
    ctx = core.Ctx(cell, 7, 0, False, time.perf_counter(), wl)
    generator = core.load_module(core.HERE / "traffic"
                              / f"{wl['generator']}.py", "generator")
    numbers = generator.control(ctx, 1, CONTROL[cell])
    checks = core.limited(numbers, wl["check"])
    assert not all(c.ok for c in checks), numbers


@pytest.mark.parametrize("fault", ["half_batch", "unchanged"])
def test_training_faults_read_above_the_limits(fault):
    wl = tiny("gen_depth.train")
    ctx = core.Ctx("gen_depth.train", 7, 0, False, time.perf_counter(), wl)
    generator = core.load_module(core.HERE / "traffic" / "train_steps.py", "d")
    checks = core.limited(generator.fault(ctx, fault), wl["check"])
    assert not all(c.ok for c in checks)
