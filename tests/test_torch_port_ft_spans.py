"""The finetuning step's span and the optimizer's counter
(``neuray_tpu_torch/utils/profiling.py``), on the CPU: ``ft.encode``
opens once a step, inside ``step.forward``, around both encodes (the
reference views' and the query's own); ``adam.bytes`` counts 24 bytes a
parameter stepped in both trainers; neither records outside a profiler
session. The benchmark's readers of them are in
``portbench/tests/test_portbench_ft.py``.

Scene: the fabricated NeRF-synthetic sphere at 32x32, 6 train views; 3
reference views a step, 16 rays, 4 + 4 samples.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from neuray_tpu_torch.data import database as DB
from neuray_tpu_torch.data.synthetic import write_nerf_synthetic_sphere
from neuray_tpu_torch.train import trainer as TR
from neuray_tpu_torch.train.ft_trainer import FtTrainer
from neuray_tpu_torch.utils import profiling as P

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ft_spans"))
    write_nerf_synthetic_sphere(root, n_train=6, size=32)
    return root


@pytest.fixture
def ft_trainer(scene_root, tmp_path, monkeypatch):
    monkeypatch.setattr(DB, "DATA_ROOT", scene_root)
    trainer = FtTrainer({
        "name": "ft_spans", "database_name": "nerf_synthetic/sphere/black_800",
        "gen_cfg": None, "use_validation": False, "neighbor_view_num": 3,
        "train_ray_num": 16, "ray_feats_res": [8, 8],
        "use_self_hit_prob": True, "use_hierarchical_sampling": True,
        "depth_sample_num": 4, "fine_depth_sample_num": 4,
        "dist_decoder_cfg": {"use_vis": False}, "loss": ["render", "consist"],
        "use_nr_fine_loss": True, "val_metric": ["psnr_ssim"],
        "output_root": str(tmp_path)}, device="cpu")
    trainer._start()
    return trainer


@pytest.fixture
def gen_trainer(tmp_path):
    trainer = TR.Trainer({
        "name": "spans", "total_step": 2, "loss": ["render", "depth"],
        "use_nr_fine_loss": True, "val_metric": ["psnr_ssim"],
        "train_dataset_type": "synthetic",
        "train_dataset_cfg": {"rfn": 3, "h": 32, "w": 32,
                              "train_ray_num": 16,
                              "depth_loss_coords_num": 8},
        "output_root": str(tmp_path), "worker_num": 0,
        "use_hierarchical_sampling": True, "depth_sample_num": 4,
        "fine_depth_sample_num": 4, "use_depth_loss": True,
        "dist_decoder_cfg": {"use_vis": False},
        "fine_dist_decoder_cfg": {"use_vis": False}}, device="cpu")
    return trainer


def session():
    return profile(activities=[ProfilerActivity.CPU])


def tree(rec):
    return [(s.name, None if s.parent is None else rec.spans[s.parent].name)
            for s in rec.spans]


def test_ft_encode_opens_once_a_step_around_both_encodes(ft_trainer,
                                                        monkeypatch):
    """Each call of the renderer's ``encode_scene`` opens a marker span:
    both of a step's (the reference views', the query's own) fall inside
    its one ``ft.encode``, which lies inside ``step.forward``."""
    net = ft_trainer.ft.net
    real = net.encode_scene

    def marked(*args):
        with P.span("encode_scene"):
            return real(*args)

    monkeypatch.setattr(net, "encode_scene", marked)
    batches = ft_trainer._batches(0)
    with session():
        for _ in range(2):
            ft_trainer.train_step(next(batches))
    rec = P.recorded()
    pairs = tree(rec)
    assert pairs.count(("ft.encode", "step.forward")) == 2
    assert pairs.count(("encode_scene", "ft.encode")) == 4
    assert ("encode_scene", "step.forward") not in pairs
    encodes = [s for s in rec.spans if s.name == "ft.encode"]
    forwards = [s for s in rec.spans if s.name == "step.forward"]
    for e, f in zip(encodes, forwards):
        assert f.host[0] <= e.host[0] <= e.host[1] <= f.host[1]


@pytest.mark.parametrize("which", ["ft", "gen"])
def test_adam_bytes_count_24_a_parameter_stepped(which, request):
    trainer = request.getfixturevalue(f"{which}_trainer")
    batches = trainer._batches(0)
    stepped = sum(p.numel() for p in trainer.optimizer.param_groups[0][
        "params"])
    assert stepped == sum(p.numel() for p in trainer.model.parameters())
    with session():
        for _ in range(2):
            trainer.train_step(next(batches))
    assert TR.ADAM_BYTES == 24
    assert P.recorded().counters["adam.bytes"] == 2 * 24 * stepped


@pytest.mark.parametrize("which", ["ft", "gen"])
def test_nothing_is_recorded_outside_a_session(which, request):
    trainer = request.getfixturevalue(f"{which}_trainer")
    with session():
        P.count("before", 1)
    before = P.recorded()
    trainer.train_step(next(trainer._batches(0)))
    assert P.recorded() == before
    assert not P.recording()
