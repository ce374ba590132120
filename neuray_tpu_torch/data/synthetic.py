"""Analytic synthetic scene for the port: diffuse spheres seen from
random cameras on a radius-4 shell (the scene ``bench.py`` renders).

A numpy copy of the unit-sphere path of ``neuray_tpu/data/synthetic.py``
with the same arithmetic, so the same seed gives the same arrays in both
packages (``tests/test_torch_port_models.py`` checks it), while the port
and ``chip_smoke.py`` import nothing of the JAX package.

``write_nerf_synthetic_sphere`` writes the sphere as a NeRF-synthetic
scene folder (PNG views, cameras, depth maps), which the finetuning path
reads through ``data/database.py``.

Conventions: channels-last, poses [3, 4] OpenCV world->cam, coords (x, y)
float32.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np

from neuray_tpu_torch.data.colmap_io import write_array
from neuray_tpu_torch.data.database import nerf_syn_val_ids
from neuray_tpu_torch.utils.png import write_png

RADIUS = 4.0
DEPTH_RANGE = (2.5, 5.5)
# (center, radius, palette)
UNIT_SPHERE = (((0.0, 0.0, 0.0), 1.0, (1.0, 0.5, 1.0)),)
# the NeRF-synthetic sphere folder: lego's field of view, one camera seed
LEGO_CAMERA_ANGLE_X = 0.6911
SCENE_SEED = 0


def look_at_camera(rng: np.random.RandomState, h: int, w: int,
                   radius: float = RADIUS):
    """Random camera on a radius shell looking at the origin.
    Returns (pose [3, 4] world->cam, K [3, 3])."""
    d = rng.randn(3)
    d = d / np.linalg.norm(d)
    center = d * radius
    z = -d
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(up, z)) > 0.98:
        up = np.array([0.0, 1.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], 0)
    t = -R @ center
    pose = np.concatenate([R, t[:, None]], 1).astype(np.float32)
    K = np.array([[w * 1.2, 0, w / 2], [0, w * 1.2, h / 2], [0, 0, 1]],
                 np.float32)
    return pose, K


def render_spheres_view(pose: np.ndarray, K: np.ndarray, h: int, w: int,
                        spheres=UNIT_SPHERE):
    """Nearest-hit render of diffuse spheres.
    Returns (rgb [h, w, 3] f32 in [0, 1], zdepth [h, w] f32, hit [h, w])."""
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float32)
    dirs_cam = pix @ np.linalg.inv(K).T
    R, t = pose[:, :3], pose[:, 3]
    cam = -R.T @ t
    dirs = dirs_cam @ R

    best_t = np.full((h, w), np.inf, np.float32)
    rgb = np.zeros((h, w, 3), np.float32)
    light = np.array([0.5, 0.5, 0.7])
    a = np.sum(dirs * dirs, -1)
    for center, radius, palette in spheres:
        oc = cam - np.asarray(center, np.float64)
        b = 2 * dirs @ oc
        c = oc @ oc - radius * radius
        disc = b * b - 4 * a * c
        sq = np.sqrt(np.maximum(disc, 0))
        t0 = (-b - sq) / (2 * a)
        t1 = (-b + sq) / (2 * a)
        tt = np.where(t0 > 1e-3, t0, t1)
        tt = np.where((disc > 0) & (tt > 1e-3), tt, np.inf)
        closer = np.isfinite(tt) & (tt < best_t)
        pts = cam[None, None] + dirs * np.where(closer, tt, 0.0)[..., None]
        shade = np.clip(((pts - np.asarray(center)) / radius) @ light, 0, 1)
        col = np.stack([shade * palette[0], shade * palette[1],
                        (1 - shade) * palette[2]], -1)
        rgb = np.where(closer[..., None], np.clip(col, 0, 1), rgb)
        best_t = np.where(closer, tt, best_t)

    hit = np.isfinite(best_t)
    pts = cam[None, None] + dirs * np.where(hit, best_t, 0.0)[..., None]
    zdepth = np.where(hit, pts @ R[2] + t[2], 0).astype(np.float32)
    return rgb.astype(np.float32), zdepth, hit


def make_sphere_scene(rng: np.random.RandomState, rfn: int, h: int,
                      w: int) -> Dict[str, np.ndarray]:
    """rfn reference views of the unit sphere: {imgs [rfn, h, w, 3],
    poses [rfn, 3, 4], Ks [rfn, 3, 3], depth_range [rfn, 2], depth
    [rfn, h, w, 1]}; depth is the exact z-depth (the depth init net's
    "estimate")."""
    imgs, poses, Ks, depths = [], [], [], []
    for _ in range(rfn):
        pose, K = look_at_camera(rng, h, w)
        rgb, zdepth, _ = render_spheres_view(pose, K, h, w)
        imgs.append(rgb)
        poses.append(pose)
        Ks.append(K)
        depths.append(zdepth)
    return {
        "imgs": np.stack(imgs),
        "poses": np.stack(poses).astype(np.float32),
        "Ks": np.stack(Ks).astype(np.float32),
        "depth_range": np.tile(np.asarray([DEPTH_RANGE], np.float32),
                               (rfn, 1)),
        "depth": np.stack(depths)[..., None],
    }


def write_nerf_synthetic_sphere(root: str, n_train: int = 100,
                                size: int = 800, scene: str = "sphere",
                                n_test: int = 1) -> None:
    """Write the unit sphere as the NeRF-synthetic scene folder
    ``{root}/nerf_synthetic/{scene}``: ``n_train`` train views ``r_<i>``,
    the val views of ``nerf_syn_val_ids`` and ``n_test`` test views
    ``r_<i>`` (drawn last: more of them change no other view), each
    a size x size RGBA PNG (alpha the hit mask, black background) from a
    random camera on the radius-4 shell (``look_at_camera``, in split
    order from ``SCENE_SEED``) at lego's field of view
    (``LEGO_CAMERA_ANGLE_X``); ``transforms_<split>.json`` with OpenGL
    camera-to-world matrices; and each train view's analytic z-depth as
    ``colmap_depth/train-r_<i>.png.geometric.bin``. Each view is rendered
    with the pose and K that ``NeRFSyntheticDatabase`` reads back."""
    rng = np.random.RandomState(SCENE_SEED)
    base = Path(root) / "nerf_synthetic" / scene
    (base / "colmap_depth").mkdir(parents=True, exist_ok=True)
    focal = 0.5 * size / np.tan(0.5 * LEGO_CAMERA_ANGLE_X)
    K = np.asarray([[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1]],
                   np.float32)
    flip = np.diag(np.asarray([1, -1, -1], np.float32))
    splits = (("train", [f"r_{i}" for i in range(n_train)]),
              ("val", [i[len("val-"):] for i in nerf_syn_val_ids]),
              ("test", [f"r_{i}" for i in range(n_test)]))
    for split, names in splits:
        (base / split).mkdir(exist_ok=True)
        frames = []
        for name in names:
            pose, _ = look_at_camera(rng, size, size)
            R, t = pose[:, :3].astype(np.float64), pose[:, 3]
            c2w = np.eye(4)
            c2w[:3, :3] = (np.diag([1.0, -1.0, -1.0]) @ R).T
            c2w[:3, 3] = -R.T @ t
            frames.append({"file_path": f"./{split}/{name}",
                           "transform_matrix": c2w.tolist()})
            # the pose as the database parses it back
            gl = np.asarray(c2w, np.float32)
            rot = gl[:3, :3].T
            pose = np.concatenate([flip @ rot, flip @ (-rot @ gl[:3, 3:])], 1)
            rgb, zdepth, hit = render_spheres_view(pose, K, size, size)
            rgba = np.concatenate(
                [np.round(rgb * 255), hit[..., None] * 255.0], -1)
            write_png(str(base / split / f"{name}.png"),
                      rgba.astype(np.uint8))
            if split == "train":
                write_array(str(base / "colmap_depth" /
                                f"train-{name}.png.geometric.bin"), zdepth)
        with open(base / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": LEGO_CAMERA_ANGLE_X,
                       "frames": frames}, f)


def make_query(rng: np.random.RandomState, h: int, w: int, rn: int,
               full_image: bool = False) -> Dict[str, np.ndarray]:
    """One query view: {coords [1, rn, 2], poses [1, 3, 4], Ks [1, 3, 3],
    depth_range [1, 2], imgs [1, h, w, 3] (the ground truth)};
    full_image=True emits the whole pixel grid instead of rn random
    pixels."""
    pose, K = look_at_camera(rng, h, w)
    rgb, _, _ = render_spheres_view(pose, K, h, w)
    if full_image:
        xs, ys = np.meshgrid(np.arange(w), np.arange(h))
        coords = np.stack([xs, ys], -1).reshape(1, -1, 2)
    else:
        coords = np.stack([rng.randint(0, w, rn),
                           rng.randint(0, h, rn)], -1)[None]
    return {
        "coords": coords.astype(np.float32),
        "poses": pose[None],
        "Ks": K[None],
        "depth_range": np.asarray([DEPTH_RANGE], np.float32),
        "imgs": rgb[None],
    }
