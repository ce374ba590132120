"""The render CLI's ``--render_type ft`` (``models/ft.py:
render_video_ft``) against the JAX package's on one pose of an
``inter_4`` trajectory, with the same FT parameters (the net from the
trained ``tools/bench_weights.npz``, ray_feats drawn from a seed; an
orbax checkpoint for JAX, ``utils/params.py: ft_flax_to_torch`` in the
port's ``ckpt.pt``), on the exact path and through the auto skip mode;
and every ``configs/ft/*_pretrain.yaml`` read by the port's YAML reader
into the JAX package's dict and ``RenderConfig``.

Scene: the NeRF-synthetic sphere at 64x64 (at 32x32 the encoders'
InstanceNorm over 2x2 pixels puts the forward at ~2e-4,
``tests/test_torch_port_train.py``), 8 train views, read by both
packages from one root. The frame's colours are held to 1e-4 on the
16x16 rays through the image centre (the sphere); where the two uint8
frames are equal the JPEG files are equal byte for byte. JAX runs at
"highest" matmul precision.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import orbax.checkpoint as ocp

from neuray_tpu.data import database as jDB
from neuray_tpu.models import ft as jF
from neuray_tpu.models import renderer as jR
from neuray_tpu.train import metrics as jM
from neuray_tpu.utils.config import load_cfg as jload_cfg

from neuray_tpu_torch import render as prender
from neuray_tpu_torch.data import database as DB
from neuray_tpu_torch.data.synthetic import write_nerf_synthetic_sphere
from neuray_tpu_torch.models import renderer as R
from neuray_tpu_torch.selfcheck import write_cfg
from neuray_tpu_torch.train.metrics import color_map_backward
from neuray_tpu_torch.utils.config import load_cfg
from neuray_tpu_torch.utils.params import ft_flax_to_torch, load_params_npz

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SIZE, N_TRAIN = 64, 8
DATABASE = "nerf_synthetic/toy/black_800"
CFG = dict(
    name="ft_render", network="neuray_ft", database_name=DATABASE,
    database_split="val_all", use_validation=False, neighbor_view_num=4,
    ray_feats_res=[16, 16], use_self_hit_prob=True,
    use_hierarchical_sampling=True, depth_sample_num=8,
    fine_depth_sample_num=8, ray_mask_point_num=4,
    dist_decoder_cfg={"use_vis": False})
SKIP = dict(skip_empty_rays=True, skip_empty_threshold=0.01,
            skip_mode="auto", probe_sample_num=4)
CENTRE = (np.arange(24, 40)[:, None] * SIZE + np.arange(24, 40)).ravel()


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ft_render")
    write_nerf_synthetic_sphere(str(root), N_TRAIN, SIZE, "toy", 1)
    return str(root)


@pytest.fixture(scope="module")
def ft_tree():
    """The FT parameters: the trained net without its init net, and
    ray_feats [N, 16, 16, 32] normal from a seed."""
    weights = load_params_npz(str(ROOT / "tools" / "bench_weights.npz"))
    return {"net": {"params": {k: v for k, v in weights["params"].items()
                               if k != "init_net"}},
            "ray_feats": np.random.RandomState(0).randn(
                N_TRAIN, 16, 16, 32).astype(np.float32)}


@pytest.mark.parametrize("skip", [False, True], ids=["exact", "auto"])
def test_render_video_ft_matches_jax(tmp_path, monkeypatch, data_root,
                                     ft_tree, skip):
    cfg = {**CFG, **SKIP} if skip else dict(CFG)
    for module in (jDB, DB):
        monkeypatch.setattr(module, "DATA_ROOT", data_root)
    frames = {"jax": [], "port": []}
    jmap = jM.color_map_backward

    def record_jax(rgb):
        frames["jax"].append(np.asarray(rgb, np.float32))
        return jmap(rgb)

    monkeypatch.setattr(jM, "color_map_backward", record_jax)
    save = prender.save_renderings

    def record_port(output_dir, qi, out, h, w):
        frames["port"] += [R._host(out[k]).reshape(h, w, 3) for k in
                           ("pixel_colors_nr", "pixel_colors_nr_fine")]
        return save(output_dir, qi, out, h, w)

    monkeypatch.setattr(prender, "save_renderings", record_port)
    dirs = {k: tmp_path / k for k in ("jax", "port")}
    for k, d in dirs.items():
        (d / "data" / "model" / cfg["name"]).mkdir(parents=True)
        cfg_path = write_cfg(d / "cfg.yaml", cfg)
    ocp.PyTreeCheckpointer().save(
        str(dirs["jax"] / "data" / "model" / cfg["name"] / "ckpt"),
        {"params": ft_tree}, force=True)
    torch.save({"params": ft_flax_to_torch(ft_tree)},
               dirs["port"] / "data" / "model" / cfg["name"] / "ckpt.pt")
    args = (DATABASE, cfg_path, "inter_4", None, False, 1024, 1, 2)
    monkeypatch.chdir(dirs["jax"])
    with jax.default_matmul_precision("highest"):
        jF.render_video_ft(*args)
    monkeypatch.chdir(dirs["port"])
    prender.main(["--database_name", DATABASE, "--cfg", cfg_path,
                  "--render_type", "ft", "--pose_type", "inter_4",
                  "--ray_num", "1024", "--rb", "1", "--re", "2",
                  "--device", "cpu"])
    assert len(frames["jax"]) == len(frames["port"]) == 2
    out = f"data/render/{DATABASE.replace('/', '_')}/{cfg['name']}-inter_4"
    for name, ours, theirs in zip(("nr", "nr_fine"), frames["port"],
                                  frames["jax"]):
        np.testing.assert_allclose(
            ours.reshape(-1, 3)[CENTRE], theirs.reshape(-1, 3)[CENTRE],
            rtol=0, atol=1e-4, err_msg=name)
        files = [(dirs[k] / out / f"1-{name}.jpg").read_bytes()
                 for k in ("port", "jax")]
        if np.array_equal(color_map_backward(ours),
                          color_map_backward(theirs)):
            assert files[0] == files[1], name
        assert not (dirs["port"] / out / f"0-{name}.jpg").exists()


@pytest.mark.parametrize("fn", sorted((ROOT / "configs" / "ft").glob(
    "*_pretrain.yaml")), ids=lambda p: p.stem)
def test_ft_pretrain_configs_build(fn):
    """The port reads the file into the JAX package's dict, and the FT
    renderer's RenderConfig (no init net) equals JAX's field by field;
    the port's renderer builds from it."""
    cfg = load_cfg(str(fn))
    assert cfg == jload_cfg(str(fn))
    ours = R.RenderConfig.from_cfg({**cfg, "init_net_type": ""})
    theirs = jR.RenderConfig.from_cfg({**cfg, "init_net_type": ""})
    for field in dataclasses.fields(ours):
        assert getattr(ours, field.name) == getattr(theirs, field.name), \
            field.name
    R.NeurayRenderer(ours)
