"""The plain reference held to the port at a small size on the CPU, by
the harness's own check (the port's output against the reference), at
the port's parity tolerance of 1e-4."""
import pytest
from conftest import run_tiny, tiny

CELLS = ["gen_depth.exact", "gen_cv.exact", "gen_depth.train"]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_holds_the_port(cell):
    wl = tiny(cell)
    # the colours at the port's 1e-4; a training step's gradients at the
    # port's 2e-3 of a leaf's norm (chip_smoke.py's GRAD_BOUND): at three
    # 64x96 views some query rays are nearly empty, whose fine samples
    # move with the coarse pass's rounding (ROADMAP hazard 3; the first
    # step's fine loss differs by 3e-5 of itself), and three Adam steps
    # carry that into the later losses and, divided by the root of the
    # second moment, into the small leaves' change
    wl["check"] = ({"loss_gap": 1e-3, "grad_gap": 2e-3, "change_gap": 2e-2}
                   if cell == "gen_depth.train" else
                   {"coarse_err": 1e-4, "fine_p99_err": 1e-4})
    res, checks = run_tiny(cell, workload=wl)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


def test_reference_holds_the_ports_f32_focus_route():
    """The focus cell's generator on the f32 route: the same keep set, coarse
    colours at 1e-4, the median ray's fine colours at 1e-4 (a ray whose
    coarse hit mass is nearly flat moves its fine samples by rounding)."""
    wl = tiny("gen_depth.focus")
    wl["route"].update(use_bf16=False, gather_quant="none")
    wl["check"] = {"keep_mismatch": 0.0, "coarse_err": 1e-4,
                   "fine_median_err": 1e-4}
    res, _ = run_tiny("gen_depth.focus", 5, wl)
    assert res["correct"], res["checks"]


def test_diff_subgrid_encode_matches_the_port():
    import numpy as np
    import torch
    from neuray_tpu_torch.models import renderer as R
    from neuray_tpu_torch.utils.params import (load_flax_params,
                                               load_params_npz)
    from pb import core, scene
    from reference import model as M
    rng = np.random.default_rng(4)
    ref = scene.make_views(rng, 3, 64, 64, "cpu")
    path = str(core.ROOT / "tools/bench_weights.npz")
    r = R.NeurayRenderer(R.RenderConfig(
        use_vis=False, fine_use_vis=False, init_diff_scale=2,
        use_hierarchical_sampling=True))
    load_flax_params(r, load_params_npz(path))
    got = R.encode_ref(r.eval(), ref)["ray_feats"]
    with torch.no_grad():
        want = M.encode(M.load_weights(path, "cpu"), ref, None, M.F32,
                        2)["ray_feats"]
    assert float((got - want).abs().max()) < 1e-4
