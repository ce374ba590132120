"""The yardstick's counts: the model FLOPs against
``torch.utils.flop_counter.FlopCounterMode`` on the plain reference at a
small size, and the gather bytes against ``chip_smoke.py``'s bounds at
the shapes of PERF.md's kernel table."""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from pb import core, counts, scene
from reference import model as M
from reference import train as T

WEIGHTS = {False: "tools/bench_weights.npz",
           True: "tools/bench_weights_cv.npz"}


def small_frame(cv, h=64, w=96, rays=40):
    rng = np.random.default_rng(1)
    views = scene.make_views(rng, 4, h, w, "cpu")
    poses, Ks, coords = scene.make_queries(rng, 1, h, w, "cpu")
    return scene.frame_inputs(views, poses[0], Ks[0],
                              coords[:, :rays].contiguous(), 3,
                              2 if cv else 0)


@pytest.mark.parametrize("cv", [False, True], ids=["depth", "cost_volume"])
def test_render_flops_match_the_flop_counter(cv):
    W = M.load_weights(str(core.ROOT / WEIGHTS[cv]), "cpu")
    S = counts.shapes_of(W)
    ref, src, que = small_frame(cv)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        ec = M.encode(W, ref, src)
    assert fc.get_total_flops() == counts.encode(S, 3, 64, 96, cv)
    rn = que["coords"].shape[1]
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        M.render_rays(W, ec, que, 64, 64)
    assert fc.get_total_flops() == (counts.render_pass(S, rn, 64, 3, False)
                                    + counts.render_pass(S, rn, 64, 3, True))
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        M.focus_probe(W, ec, que, 16)
        M.focus_render(W, ec, que, *(que["depth_range"][:, i:i + 1].expand(
            1, rn) for i in (0, 1)), 12, 24)
    assert fc.get_total_flops() == (counts.render_pass(S, rn, 16, 3, False)
                                    + counts.render_pass(S, rn, 12, 3, False)
                                    + counts.render_pass(S, rn, 24, 3, True))


def test_training_forward_flops_match_the_flop_counter():
    W = M.load_weights(str(core.ROOT / WEIGHTS[False]), "cpu")
    S = counts.shapes_of(W)
    rng = np.random.default_rng(2)
    from traffic import train_steps
    tr = {"pool": 1, "views": 3, "view_hw": [64, 96], "rays": 32,
          "depth_pixels": 50}
    batch = train_steps.make_pool(rng, tr, "cpu")[0]
    u = torch.rand((1, 32, 64))
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        T.losses(W, batch, u)
    fwd = train_steps.step_counts(S, tr)["flops"] / 3
    assert fc.get_total_flops() == fwd


# PERF.md's kernel table: (map [v, fh, fw, c], points a view, masked)
FORWARD_ROWS = [((8, 200, 200, 64), 65536, False, torch.float32),
                ((8, 200, 200, 64), 12288, True, torch.uint8),
                ((8, 192, 256, 64), 65536, True, torch.float32)]
BACKWARD_ROWS = [((8, 100, 152, 64), 32768, True),
                 ((8, 100, 152, 32), 8192, True),
                 ((8, 200, 200, 64), 32768, True)]


@pytest.mark.parametrize("row", FORWARD_ROWS, ids=str)
def test_forward_bytes_are_chip_smokes_less_the_map(row):
    import chip_smoke
    from neuray_tpu_torch.ops import gather as GA
    (v, fh, fw, c), p, masked, dtype = row
    g = torch.Generator().manual_seed(0)
    feats = torch.zeros((v, fh, fw, c), dtype=dtype)
    pix = torch.rand((v, p, 2), generator=g) * torch.tensor([fw, fh])
    nbytes, touched, _, _ = chip_smoke.gather_bound(GA, feats, pix, masked)
    out = 2 if dtype == torch.uint8 else feats.element_size()
    extra = 2 * c * 4 if dtype == torch.uint8 else 0
    mine = counts.gather_bytes(v * p, c, out, masked)
    assert mine == nbytes - touched * c * feats.element_size() - extra


@pytest.mark.parametrize("row", BACKWARD_ROWS, ids=str)
def test_backward_bytes_are_chip_smokes(row):
    import chip_smoke
    from neuray_tpu_torch.ops import gather as GA
    (v, fh, fw, c), p, masked = row
    pix = torch.rand((v, p, 2)) * torch.tensor([fw, fh])
    nbytes, _, _, _ = chip_smoke.gather_backward_bound(
        GA, torch.zeros((v, p, c)), pix, fh, fw, masked)
    assert counts.gather_backward_bytes(v, p, c, fh, fw, masked) == nbytes
