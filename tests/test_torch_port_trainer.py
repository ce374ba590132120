"""The port's trainer (``neuray_tpu_torch/train/trainer.py``) on the CPU,
mirroring the JAX trainer's tests (``tests/test_trainer_impl.py:41-140``):
a few steps and a resume, a 30-step run whose validation PSNR improves
and that resumes from its checkpoint, and the refusal of an optimizer
state that does not fit the model.

Shapes: 3 synthetic reference views at 32x32, 8 + 8 samples. The JAX
test trains on 8 devices, 8 scenes of 32 rays a step; the port trains on
one, so its 30-step run takes one scene of 256 rays a step (the same
rays an update) to make the same progress.
"""
import os

import numpy as np
import pytest
import torch

from neuray_tpu_torch.train import trainer as T

torch.set_num_threads(1)


def make_cfg(tmpdir, total_step=3, **over):
    return {
        "name": "smoke",
        "total_step": total_step,
        "train_log_step": 2,
        "val_interval": 1000000,  # no validation in the smoke test
        "save_interval": 2,
        "lr_type": "exp_decay",
        "lr_cfg": {"lr_init": 1e-3, "decay_step": 1000, "decay_rate": 0.5},
        "loss": ["render", "depth"],
        "use_nr_fine_loss": True,
        "val_metric": ["psnr_ssim"],
        "key_metric_name": "psnr_nr_fine",
        "train_dataset_type": "synthetic",
        "train_dataset_cfg": {"rfn": 3, "h": 32, "w": 32,
                              "train_ray_num": 32,
                              "depth_loss_coords_num": 8},
        "val_set_list": [],
        "output_root": str(tmpdir),
        "worker_num": 0,
        # renderer cfg (flat, reference-style)
        "use_hierarchical_sampling": True,
        "depth_sample_num": 8,
        "fine_depth_sample_num": 8,
        "ray_batch_num": 32,
        "ray_mask_point_num": 4,
        "use_depth_loss": True,
        "dist_decoder_cfg": {"use_vis": False},
        "fine_dist_decoder_cfg": {"use_vis": False},
        **over,
    }


def finite(renderer):
    return all(torch.isfinite(p).all() for p in renderer.parameters())


def test_trainer_runs_and_resumes(tmp_path):
    """3 steps in this process, then a resume to 5 with one spawned
    DataLoader worker."""
    trainer = T.Trainer(make_cfg(tmp_path, 3), device="cpu")
    trainer.run()
    assert os.path.exists(f"{trainer.model_dir}/ckpt.pt")
    assert os.path.exists(f"{trainer.model_dir}/train.txt")

    trainer2 = T.Trainer(make_cfg(tmp_path, 5, worker_num=1), device="cpu")
    renderer = trainer2.run()
    with open(f"{trainer2.model_dir}/train.txt") as f:
        log = f.read()
    assert "step 2" in log and "step 4" in log
    assert finite(renderer)
    state = torch.load(f"{trainer2.model_dir}/ckpt.pt", weights_only=True)
    assert state["step"] == 5 and state["opt_count"] == 5


def test_trainer_val_improves_and_resumes(tmp_path):
    """30 steps with a 2-view synthetic val set: psnr_nr_fine at step 30
    beats step 10, and the run resumes from its step-30 checkpoint."""
    def cfg(total_step):
        train = dict(make_cfg(tmp_path)["train_dataset_cfg"],
                     train_ray_num=256)
        return make_cfg(
            tmp_path, total_step, name="val30", val_interval=10,
            save_interval=10, train_dataset_cfg=train,
            val_set_list=[{"name": "sphere", "type": "synthetic",
                           "cfg": {"rfn": 3, "h": 32, "w": 32, "num": 2}}])

    trainer = T.Trainer(cfg(30), device="cpu")
    trainer.run()
    vals = {}
    with open(f"{trainer.model_dir}/val-sphere.txt") as f:
        for line in f:
            toks = line.split()
            vals[int(toks[2])] = float(toks[toks.index("psnr_nr_fine") + 1])
    assert 10 in vals and 30 in vals
    assert vals[30] > vals[10], vals
    best = torch.load(f"{trainer.model_dir}/ckpt_best.pt", weights_only=True)
    assert best["best_metric"] == pytest.approx(max(vals.values()), abs=1e-4)

    trainer2 = T.Trainer(cfg(34), device="cpu")
    renderer = trainer2.run()
    with open(f"{trainer2.model_dir}/train.txt") as f:
        log = f.read()
    assert "step 32" in log and "step 34" in log
    assert finite(renderer)


def test_restore_opt_state_strict():
    """Adam moments survive a resume; a state that does not fit the
    parameters raises under strict and is replaced by a fresh one (with a
    warning) otherwise."""
    params = [torch.nn.Parameter(torch.ones(3, 2)),
              torch.nn.Parameter(torch.zeros(2))]
    opt = torch.optim.Adam(params, lr=1e-3)
    for p in params:
        p.grad = torch.ones_like(p)
    opt.step()
    saved = opt.state_dict()

    fresh = torch.optim.Adam(params, lr=1e-3)
    assert T._restore_opt_state(fresh, saved)
    for p in params:
        for k in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(fresh.state[p][k], opt.state[p][k],
                                       rtol=0, atol=0)

    more = params + [torch.nn.Parameter(torch.zeros(4))]
    with pytest.raises(ValueError, match="opt_state"):
        T._restore_opt_state(torch.optim.Adam(more), saved)
    reset = torch.optim.Adam(more)
    assert not T._restore_opt_state(reset, saved, strict=False)
    assert not reset.state

    reshaped = [torch.nn.Parameter(torch.ones(2, 3)), params[1]]
    with pytest.raises(ValueError, match="opt_state"):
        T._restore_opt_state(torch.optim.Adam(reshaped), saved)


def test_resume_refuses_a_mismatched_optimizer_state(tmp_path):
    """A checkpoint whose optimizer state does not fit is refused at
    resume unless ``resume_reset_opt``, which restarts Adam (and its
    update count) and keeps the parameters."""
    trainer = T.Trainer(make_cfg(tmp_path, 2), device="cpu")
    trainer.run()
    path = f"{trainer.model_dir}/ckpt.pt"
    state = torch.load(path, weights_only=True)
    first = next(iter(state["opt_state"]["state"].values()))
    first["exp_avg"] = first["exp_avg"][..., :1]
    torch.save(state, path)
    with pytest.raises(ValueError, match="resume_reset_opt"):
        T.Trainer(make_cfg(tmp_path, 3), device="cpu").run()
    trainer2 = T.Trainer(make_cfg(tmp_path, 3, resume_reset_opt=True),
                         device="cpu")
    trainer2.run()
    after = torch.load(path, weights_only=True)
    assert after["step"] == 3 and after["opt_count"] == 1


def test_trainer_needs_a_device(tmp_path, monkeypatch):
    """The trainer trains on the card unless the caller asks for the CPU;
    without one it raises rather than carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.Trainer(make_cfg(tmp_path))
    assert T.Trainer(make_cfg(tmp_path), device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        T.Trainer(make_cfg(tmp_path, n_devices=2), device="cpu")
    with pytest.raises(NotImplementedError, match="no_such_metric"):
        T.Trainer(make_cfg(tmp_path,
                           val_metric=["psnr_ssim", "no_such_metric"]),
                  device="cpu")


def test_lr_follows_the_update_count(tmp_path):
    """Each update's learning rate is the schedule at the count of updates
    before it, as optax counts: exp decay halves it every decay_step."""
    cfg = make_cfg(tmp_path, lr_cfg={"lr_init": 1e-3, "decay_step": 2,
                                     "decay_rate": 0.5, "lr_min": 0.0})
    trainer = T.Trainer(cfg, device="cpu")
    seen = []
    step = trainer.optimizer.step

    def spy(*args, **kw):
        seen.append(trainer.optimizer.param_groups[0]["lr"])
        return step(*args, **kw)

    trainer.optimizer.step = spy
    batch = trainer.to_device(trainer.train_dataset[0])
    for _ in range(5):
        trainer.train_step(batch)
    np.testing.assert_allclose(seen, [1e-3, 1e-3, 5e-4, 5e-4, 2.5e-4])
    assert trainer.opt_count == 5
