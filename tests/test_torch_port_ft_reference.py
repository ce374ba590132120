"""The port's finetuning step held to the benchmark's plain reference
(``portbench/reference/ft.py``), on the CPU at a small size:
``FtTrainer.train_step`` on three batches of ``FtTrainer._batches`` from
a state drawn at random (``init_like_flax``, random ``ray_feats``)
against ``reference/ft.py: train`` on the same batches and fine draws,
the scene read by the reference's own reader; the rows no step selected
unchanged; the reference's initial rows from the depth init net against
the port's; and ``portbench/pb/ft_counts.py``'s FLOPs against
``FlopCounterMode`` on the reference step.

Scene: the fabricated NeRF-synthetic sphere of 8 train views at 128x128;
7 reference views a step (the query's other 7), 64 rays, 16 + 16 samples.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from neuray_tpu_torch.data import database as DB
from neuray_tpu_torch.data.synthetic import write_nerf_synthetic_sphere
from neuray_tpu_torch.models.renderer import NeurayRenderer, RenderConfig
from neuray_tpu_torch.train.ft_trainer import FtTrainer
from neuray_tpu_torch.utils.params import init_like_flax, torch_to_flax

BENCH = Path(__file__).resolve().parents[1] / "portbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from pb import counts, ft_counts  # noqa: E402
from reference import ft as FT  # noqa: E402
from reference import model as M  # noqa: E402

torch.set_num_threads(1)
STEPS, RAYS, DN = 3, 64, 16
# the port's f32 bar: the losses relative, each leaf's first gradient
# relative to its own norm (a leaf whose reference gradient is under 1e-3
# of the median leaf's is nought but round-off, a conv bias under an
# instance norm or a bias under a softmax over the views, and is held to
# the median leaf's norm)
BAR = 1e-4
# the three steps' change, relative to each leaf's norm (round-off leaves
# left out): Adam's first update is lr * g / |g| an element, so an element
# whose gradient lies within round-off of zero moves by +-lr on either
# side; on this scene, with every leaf's gradient within 6.5e-5 of the
# reference's, one step's change reads up to 1.6e-3 and three steps' up
# to 8.6e-3 (the benchmark's limit on the median leaf is 2e-2)
CHANGE_BAR = 2e-2


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ft_reference")
    write_nerf_synthetic_sphere(str(root), n_train=8, size=128)
    return root


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = torch.from_numpy(np.array(v))
    return out


def make_trainer(root, out, **over):
    DB.DATA_ROOT = str(root)
    trainer = FtTrainer({
        "name": "ft_reference", "database_name":
            "nerf_synthetic/sphere/black_800", "gen_cfg": None,
        "use_validation": False, "train_ray_num": RAYS,
        "ray_feats_res": [32, 32], "use_self_hit_prob": True,
        "use_hierarchical_sampling": True, "depth_sample_num": DN,
        "fine_depth_sample_num": DN, "dist_decoder_cfg": {"use_vis": False},
        "loss": ["render", "consist"], "use_nr_fine_loss": True,
        "val_metric": ["psnr_ssim"], "output_root": str(out), **over},
        device="cpu")
    trainer._start()
    return trainer


@pytest.fixture(scope="module")
def steps(scene_root, tmp_path_factory):
    """Three port steps and the reference's repeat of them."""
    data_root = DB.DATA_ROOT
    try:
        trainer = make_trainer(scene_root, tmp_path_factory.mktemp("out"))
    finally:
        DB.DATA_ROOT = data_root
    ft = trainer.ft
    W = flat(torch_to_flax(ft.net))
    named = {k[len("net."):]: p for k, p in ft.named_parameters()
             if k != "ray_feats"}
    rows0 = ft.ray_feats.detach().clone()
    batches, record, losses, state = trainer._batches(0), [], [], None
    for i in range(STEPS):
        ref_idx, que, que_i = batch = next(batches)
        if state is None:
            state = trainer.generator.get_state()
        record.append({"ref_idx": np.array(ref_idx), "que_i": int(que_i),
                       "coords": que["coords"].clone()})
        losses.append(trainer.train_step(batch)["loss_total"])
        if i == 0:
            opt = trainer.optimizer.state
            grad = flat(torch_to_flax(ft.net, {
                k: opt[p]["exp_avg"] / 0.1 for k, p in named.items()}))
            rf_grad = opt[ft.ray_feats]["exp_avg"] / 0.1
    after = flat(torch_to_flax(ft.net))
    change = {k: after[k] - W[k] for k in W}
    g = torch.Generator()
    g.set_state(state)
    draws = [torch.rand((1, RAYS, DN), generator=g) for _ in range(STEPS)]
    touched = sorted({int(b["que_i"]) for b in record}
                     | {int(v) for b in record for v in b["ref_idx"]})
    scene = FT.Scene(scene_root, "sphere", "cpu")
    ref = FT.train(W, {v: rows0[v] for v in touched}, scene, record, draws,
                   trainer.cfg["lr_cfg"], STEPS, DN, DN)
    return dict(trainer=trainer, W=W, rows0=rows0,
                record=record, losses=losses, grad=grad, rf_grad=rf_grad,
                change=change, touched=touched, scene=scene, ref=ref)


def round_off(grad):
    """The leaves whose gradient is under 1e-3 of the median leaf's."""
    norms = {k: float(v.norm()) for k, v in grad.items()}
    med = float(np.median(list(norms.values())))
    return {k for k, n in norms.items() if n < 1e-3 * med}, med


def gap(a, b) -> float:
    return float((a - b).norm()) / float(b.norm())


def test_the_reference_reads_the_scene_the_port_reads(steps):
    ft = steps["trainer"].ft
    views = steps["scene"].take(range(len(ft.ref_ids)))
    for k in ("imgs", "poses", "Ks", "depth_range", "depth"):
        assert torch.equal(views[k], ft.ref_store.get(
            k, torch.from_numpy(ft.ref_info[k]))), k
    assert np.array_equal(steps["scene"].nearest(), ft.ref_dist_idx)


def test_losses_are_the_references(steps):
    ref_losses = steps["ref"][0]
    for p, r in zip(steps["losses"], ref_losses):
        assert abs(p - r) <= BAR * abs(r), (steps["losses"], ref_losses)


def test_every_leaf_moves_as_the_references(steps):
    _, grad, change = steps["ref"][:3]
    assert set(grad) == set(steps["grad"]) == set(steps["W"])
    noise, med = round_off(grad)
    assert len(noise) < len(grad) // 10
    for k in grad:
        err = float((steps["grad"][k] - grad[k]).norm())
        assert err <= BAR * (med if k in noise else float(grad[k].norm())), k
        if k not in noise:
            assert gap(steps["change"][k], change[k]) <= CHANGE_BAR, k


def test_ray_feats_move_as_the_references(steps):
    rf_grad, rf_change = steps["ref"][3:5]
    ft = steps["trainer"].ft
    first = {int(steps["record"][0]["que_i"]),
             *map(int, steps["record"][0]["ref_idx"])}
    for v in steps["touched"]:
        if v in first:
            assert gap(steps["rf_grad"][v], rf_grad[v]) <= BAR, v
        else:
            assert not steps["rf_grad"][v].any() and not rf_grad[v].any()
        change = ft.ray_feats.detach()[v] - steps["rows0"][v]
        assert gap(change, rf_change[v]) <= CHANGE_BAR, v


def test_untouched_rows_do_not_move(scene_root, tmp_path, monkeypatch):
    """Two steps from 3 of each query's 6 nearest views: every row no
    step selected stays exactly as it was (its Adam moments stay 0)."""
    monkeypatch.setattr(DB, "DATA_ROOT", str(scene_root))
    trainer = make_trainer(scene_root, tmp_path, neighbor_view_num=3)
    ft = trainer.ft
    rows0 = ft.ray_feats.detach().clone()
    batches, touched = trainer._batches(0), set()
    for _ in range(2):
        ref_idx, que, que_i = batch = next(batches)
        touched |= {int(que_i), *map(int, ref_idx)}
        trainer.train_step(batch)
    moved = (ft.ray_feats.detach() != rows0).flatten(1).any(1)
    assert set(torch.nonzero(moved).flatten().tolist()) == touched
    assert len(touched) < len(ft.ref_ids)


def test_initial_rows_are_the_depth_init_nets(steps, tmp_path):
    """The port's init from a generalization model (its depth init net on
    each view and its 7 nearest) against the reference's."""
    torch.manual_seed(0)
    gen = NeurayRenderer(RenderConfig(use_vis=False, fine_use_vis=False,
                                      use_hierarchical_sampling=True))
    init_like_flax(gen)
    ft = steps["trainer"].ft
    port = ft.init_ray_feats_from_gen(gen)
    W = flat(torch_to_flax(gen))
    views = [0, 5]
    ref = FT.init_ray_feats(W, steps["scene"], views, 8)
    for v in views:
        assert float((port[v] - ref[v]).norm()) <= BAR * float(
            ref[v].norm()), v


def test_step_flops_are_the_flop_counters(steps):
    W = M.load_weights(str(BENCH.parent / "tools" / "bench_weights.npz"),
                       "cpu")
    rec = steps["record"][0]
    rows = {v: torch.randn(32, 32, 32) for v in steps["touched"]}
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        FT.losses(W, lambda idx: torch.stack([rows[int(i)] for i in idx]),
                  steps["scene"], rec, torch.rand(1, RAYS, DN), DN, DN)
    want = ft_counts.forward(counts.shapes_of(W), len(rec["ref_idx"]), 128,
                             128, RAYS, DN, DN)
    assert fc.get_total_flops() == want
