"""The port's render CLI (``python -m neuray_tpu_torch.render``,
``render_video_gen``) against the JAX package's ``render.py`` on the same
scene, config and weights.

Scene: the NeRF-synthetic sphere fabricated at 32x32 (12 train views with
depth, 3 test views), read by both packages from one data root. Config:
``tests/test_auto_reaudit.py``'s (16 + 16 samples, 1024-ray chunks, no
vis, skip threshold 0.05, an 8-sample probe), weights the trained
``tools/bench_weights.npz``: an orbax checkpoint for JAX, the port's
``ckpt.pt`` for the port. Per skip mode and the exact path, what each CLI
hands ``save_renderings`` is held to 1e-4 on the 8x8 rays through the
image centre (the sphere; its silhouette is where a probe decision may
differ); where the two uint8 frames are equal the JPEG files are equal
byte for byte, and the GT dump is always. Also: ``--depth`` PNGs,
``--rb``/``--re``, resume on rerun, one encode per ref set along a
trajectory, and the cost-volume route (``bench_weights_cv.npz`` with the
prob conv x1000, ``SHARP``: the shipped MVSNet's flat volume magnifies f32
rounding ~1e4-fold, ``tests/test_torch_port_cost_volume.py``). JAX runs
at "highest" matmul precision.
"""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import orbax.checkpoint as ocp

import render as jrender
from neuray_tpu.data import database as jDB
from neuray_tpu_torch import render as prender
from neuray_tpu_torch.data import database as DB
from neuray_tpu_torch.data.synthetic import write_nerf_synthetic_sphere
from neuray_tpu_torch.models import renderer as R
from neuray_tpu_torch.selfcheck import write_cfg, write_gen_checkpoint
from neuray_tpu_torch.train.metrics import color_map_backward
from neuray_tpu_torch.utils.imageio import imread
from neuray_tpu_torch.utils.params import load_params_npz

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SIZE = 32
DATABASE = "nerf_synthetic/toy/black_800"
CFG = {
    "name": "cli_gen",
    "network": "neuray_gen",
    "init_net_type": "depth",
    "use_hierarchical_sampling": True,
    "depth_sample_num": 16,
    "fine_depth_sample_num": 16,
    "ray_batch_num": 1024,
    "dist_decoder_cfg": {"use_vis": False},
    "fine_dist_decoder_cfg": {"use_vis": False},
}
SKIP = {"skip_empty_rays": True, "skip_empty_threshold": 0.05,
        "probe_sample_num": 8}
MODES = ["exact", "two_phase", "probe", "probe_focus", "auto", "auto_focus"]
# the 8x8 rays through the image centre, row-major
CENTRE = (np.arange(12, 20)[:, None] * SIZE + np.arange(12, 20)).ravel()


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    write_nerf_synthetic_sphere(str(root), 12, SIZE, "toy", 3)
    return str(root)


@pytest.fixture(scope="module")
def weights():
    return load_params_npz(str(ROOT / "tools" / "bench_weights.npz"))


def out_dir(name, pose_type="eval"):
    return f"data/render/{DATABASE.replace('/', '_')}/{name}-{pose_type}"


class Run:
    """One config through both CLIs, each in a working directory of its
    own under tmp (its checkpoint in data/model, its renders in
    data/render), both reading the scene from data_root. Records what
    each hands save_renderings, by frame, and the port's encodes."""

    def __init__(self, tmp, monkeypatch, data_root, weights, cfg):
        self.cfg = cfg
        self.dirs = {k: tmp / k for k in ("jax", "port")}
        self.outs = {"jax": {}, "port": {}}
        self.encodes = []
        for k, d in self.dirs.items():
            d.mkdir(exist_ok=True)
            self.cfg_path = write_cfg(d / "cfg.yaml", cfg)
        ocp.PyTreeCheckpointer().save(
            str(self.dirs["jax"] / "data" / "model" / cfg["name"] / "ckpt"),
            {"step": np.asarray(0), "best_metric": np.asarray(0.0, np.float32),
             "params": weights}, force=True)
        write_gen_checkpoint(self.dirs["port"] / "data" / "model", cfg,
                             weights)
        for module in (jDB, DB):
            monkeypatch.setattr(module, "DATA_ROOT", data_root)
        self.monkeypatch = monkeypatch
        for k, module in (("jax", jrender), ("port", prender)):
            monkeypatch.setattr(module, "save_renderings",
                                self._recorder(k, module.save_renderings))
        encode = R.encode_ref

        def counted(renderer, ref, src=None):
            self.encodes.append(tuple(ref["poses"].shape))
            return encode(renderer, ref, src)

        monkeypatch.setattr(R, "encode_ref", counted)

    def _recorder(self, k, save):
        def record(output_dir, qi, out, h, w):
            self.outs[k][qi] = {key: np.asarray(R._host(v), np.float32)
                                for key, v in out.items()
                                if key.startswith("pixel_colors")
                                or key.startswith("render_depth")}
            return save(output_dir, qi, out, h, w)
        return record

    def __call__(self, which=("jax", "port"), pose_type="eval", depth=False,
                 rb=0, re=-1):
        for k in which:
            self.monkeypatch.chdir(self.dirs[k])
            args = (DATABASE, self.cfg_path, pose_type, None, depth, 1024,
                    rb, re)
            if k == "jax":
                with jax.default_matmul_precision("highest"):
                    jrender.render_video_gen(*args)
            else:
                prender.render_video_gen(*args, device="cpu")

    def path(self, k, name):
        return self.dirs[k] / name


def assert_frames_match(run, frames, pose_type="eval", atol=1e-4):
    """Floats on the centre rays within atol; the JPEGs byte-equal where
    the uint8 frames are."""
    for qi in frames:
        jo, po = run.outs["jax"][qi], run.outs["port"][qi]
        assert set(jo) >= {"pixel_colors_nr", "pixel_colors_nr_fine"}
        for key in ("pixel_colors_nr", "pixel_colors_nr_fine"):
            np.testing.assert_allclose(
                po[key][0, CENTRE], jo[key][0, CENTRE], rtol=0, atol=atol,
                err_msg=f"frame {qi} {key}")
            name = key[len("pixel_colors_"):]
            rel = f"{out_dir(run.cfg['name'], pose_type)}/{qi}-{name}.jpg"
            ours = run.path("port", rel).read_bytes()
            theirs = run.path("jax", rel).read_bytes()
            u8 = [color_map_backward(o[key].reshape(SIZE, SIZE, 3))
                  for o in (jo, po)]
            if np.array_equal(*u8):
                assert ours == theirs, f"frame {qi} {name}.jpg"
            else:
                print(f"frame {qi} {key}: {np.mean(u8[0] != u8[1]):.4f} of "
                      "the uint8 values differ")


@pytest.mark.parametrize("mode", MODES)
def test_render_cli_matches_jax(tmp_path, monkeypatch, data_root, weights,
                                mode):
    cfg = dict(CFG) if mode == "exact" else {**CFG, **SKIP,
                                             "skip_mode": mode}
    run = Run(tmp_path, monkeypatch, data_root, weights, cfg)
    run()
    assert sorted(run.outs["port"]) == sorted(run.outs["jax"]) == [0, 1, 2]
    assert_frames_match(run, range(3))
    gt = f"data/render/{DATABASE.replace('/', '_')}/gt"
    for qi in range(3):
        assert run.path("port", f"{gt}/{qi}.jpg").read_bytes() == \
            run.path("jax", f"{gt}/{qi}.jpg").read_bytes()
    if mode.startswith("auto"):
        logs = [[json.loads(line) for line in run.path(
            k, f"{out_dir(cfg['name'])}/auto_audit.jsonl").read_text()
            .splitlines()] for k in ("jax", "port")]
        assert [(e["frame"], e["probe_sample_num"], e["fallback"])
                for e in logs[0]] == [(e["frame"], e["probe_sample_num"],
                                       e["fallback"]) for e in logs[1]]


def test_render_cli_depth_range_and_resume(tmp_path, monkeypatch, data_root,
                                           weights):
    """``--depth`` writes both depth PNGs (equal to JAX's where the depths
    round alike); ``--rb 1 --re 2`` renders frame 1 alone and dumps its GT
    alone; a rerun renders nothing that exists (no encode) and fills in
    the frames that are missing."""
    run = Run(tmp_path, monkeypatch, data_root, weights, dict(CFG))
    run(depth=True, rb=1, re=2)
    assert sorted(run.outs["port"]) == sorted(run.outs["jax"]) == [1]
    assert_frames_match(run, [1])
    gt = f"data/render/{DATABASE.replace('/', '_')}/gt"
    for k in ("jax", "port"):
        assert sorted(os.listdir(run.path(k, gt))) == ["1.jpg"]
        assert sorted(os.listdir(run.path(k, out_dir("cli_gen")))) == [
            "1-depth.png", "1-depth_fine.png", "1-nr.jpg", "1-nr_fine.jpg"]
    for name in ("depth", "depth_fine"):
        ours, theirs = (imread(run.path(k, f"{out_dir('cli_gen')}/1-{name}"
                                        ".png")) for k in ("port", "jax"))
        assert ours.shape == theirs.shape == (SIZE, SIZE)
        assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 1
        assert np.mean(ours != theirs) < 0.01
    assert len(run.encodes) == 1
    run(which=("port",), rb=1, re=2)
    assert len(run.encodes) == 1 and sorted(run.outs["port"]) == [1]
    run(which=("port",))
    assert len(run.encodes) == 3 and sorted(run.outs["port"]) == [0, 1, 2]


def test_render_cli_shares_the_encode_along_a_trajectory(
        tmp_path, monkeypatch, data_root, weights):
    """An ``inter_6`` trajectory: the port encodes once per run of poses
    that select the same 8 views (as the JAX CLI's cache does), and its
    frames match JAX's."""
    from neuray_tpu_torch.data.render_poses import get_render_poses
    from neuray_tpu_torch.data.view_select import select_working_views_db
    run = Run(tmp_path, monkeypatch, data_root, weights, dict(CFG))
    run(pose_type="inter_6")
    db = DB.parse_database_name(DATABASE)
    sets = [tuple(s) for s in select_working_views_db(
        db, db.get_img_ids(check_depth_exist=True),
        get_render_poses(db, "inter_6"), 8)]
    runs = 1 + sum(a != b for a, b in zip(sets, sets[1:]))
    assert len(run.encodes) == runs < len(sets)
    assert_frames_match(run, range(6), "inter_6")


def test_render_cli_cost_volume_route(tmp_path, monkeypatch, data_root):
    """``init_net_type: cost_volume`` through the union of refs and
    source views (``build_src_imgs_info_select``), one frame."""
    from tests.test_torch_port_cost_volume import SHARP
    cfg = {**CFG, "name": "cli_cv", "init_net_type": "cost_volume"}
    weights = load_params_npz(str(ROOT / "tools" / "bench_weights_cv.npz"))
    cr = weights["params"]["init_net"]["mvsnet"]["cost_regularization"]
    cr["prob"]["kernel"] = cr["prob"]["kernel"] * np.float32(SHARP)
    run = Run(tmp_path, monkeypatch, data_root, weights, cfg)
    run(re=1)
    assert_frames_match(run, [0])


def test_render_cli_refuses_without_a_card(tmp_path):
    """Without ``--device`` on a machine with no CUDA device the CLI
    raises (its entry points run on the card unless asked)."""
    import subprocess
    import sys
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "-m", "neuray_tpu_torch.render", "--cfg",
         str(ROOT / "configs" / "gen" / "neuray_gen_depth.yaml")],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr
