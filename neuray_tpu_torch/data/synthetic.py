"""Analytic synthetic scenes for the port: diffuse spheres seen from
random cameras on a radius-4 shell (the scene ``bench.py`` renders), and
the repo's hard scenes: five blobs with one thin sphere
(``make_blob_spheres``), the blobs inside a checker-textured room sphere
that every ray hits (``make_room_spheres``, ``ROOM_DEPTH_RANGE``), and
the pan scene of an anchor sphere and an X of thin rods
(``make_pan_scene_spheres``) with the pan trajectory's camera geometry
(``look_at_pose``, ``sphere_in_frustum``).

A numpy copy of ``neuray_tpu/data/synthetic.py`` (and of the pan tool's
geometry, ``tools/check_trajectory_escalation.py``) with the same
arithmetic, so the same seed gives the same arrays in both packages, byte
for byte (``tests/test_torch_port_scenes.py``), while the port and
``chip_smoke.py`` import nothing of the JAX package.

``write_nerf_synthetic_sphere`` writes the sphere as a NeRF-synthetic
scene folder (PNG views, cameras, depth maps), which the finetuning path
reads through ``data/database.py``.

Conventions: channels-last, poses [3, 4] OpenCV world->cam, coords (x, y)
float32; a sphere is (center, radius, palette[, textured]).
"""
from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

import numpy as np

from neuray_tpu_torch.data.colmap_io import write_array
from neuray_tpu_torch.data.database import nerf_syn_val_ids
from neuray_tpu_torch.utils.png import write_png

# cameras on a radius-4 shell around a unit sphere: every z-depth lies
# inside [2.5, 5.5]
RADIUS = 4.0
DEPTH_RANGE = (2.5, 5.5)
# (center, radius, palette)
UNIT_SPHERE = (((0.0, 0.0, 0.0), 1.0, (1.0, 0.5, 1.0)),)
# the room scene: cameras at radius 4 inside a radius-8 room sphere
ROOM_RADIUS = 8.0
ROOM_DEPTH_RANGE = (2.5, 12.5)
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
    """Nearest-hit render of diffuse spheres (the smallest positive root,
    so a camera inside a sphere sees its far side: the room); a sphere
    with a true fourth field carries a procedural 3-D checker.
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
    for sphere in spheres:
        center, radius, palette = sphere[:3]
        textured = len(sphere) > 3 and sphere[3]
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
        if textured:
            checker = (np.floor(pts[..., 0] * 1.5)
                       + np.floor(pts[..., 1] * 1.5)
                       + np.floor(pts[..., 2] * 1.5)) % 2
            col = (col + 0.25) * (0.5 + 0.5 * checker[..., None])
        rgb = np.where(closer[..., None], np.clip(col, 0, 1), rgb)
        best_t = np.where(closer, tt, best_t)

    hit = np.isfinite(best_t)
    pts = cam[None, None] + dirs * np.where(hit, best_t, 0.0)[..., None]
    zdepth = np.where(hit, pts @ R[2] + t[2], 0).astype(np.float32)
    return rgb.astype(np.float32), zdepth, hit


def render_sphere_view(pose: np.ndarray, K: np.ndarray, h: int, w: int):
    """``render_spheres_view`` of the unit sphere."""
    return render_spheres_view(pose, K, h, w, UNIT_SPHERE)


def make_blob_spheres(rng: np.random.RandomState, n: int = 5):
    """n diffuse spheres of radius 0.15-0.45 scattered in the 0.7-ball,
    the first a thin one of radius 0.08 (what a reduced-sample probe
    misses)."""
    spheres = []
    for i in range(n):
        center = rng.randn(3)
        center = center / np.linalg.norm(center) * rng.uniform(0.15, 0.7)
        radius = 0.08 if i == 0 else rng.uniform(0.15, 0.45)
        palette = tuple(rng.uniform(0.4, 1.0, 3))
        spheres.append((tuple(center), radius, palette))
    return tuple(spheres)


def make_room_spheres(rng: np.random.RandomState, n_inner: int = 4):
    """The full-coverage scene: ``make_blob_spheres(rng, n_inner)`` inside
    a checker-textured room sphere of radius ``ROOM_RADIUS`` around the
    cameras, so every ray hits geometry. Render it with
    ``depth_range=ROOM_DEPTH_RANGE``."""
    spheres = list(make_blob_spheres(rng, n_inner))
    spheres.append(((0.0, 0.0, 0.0), ROOM_RADIUS, (0.75, 0.7, 0.55),
                    True))
    return tuple(spheres)


def make_pan_scene_spheres():
    """The pan scene: a diffuse anchor sphere (r 0.5 at +1.1 x) and an X
    of 25 rod spheres (r 0.10) at -1.25 x. From the radius-4 shell the
    two groups lie ~32 deg apart, beyond the default K's ~26 deg
    half-diagonal field of view, so a camera can frame the anchor with
    the rods outside and then pan them in. The rod radius lies between
    the 8-sample probe's depth spacing (0.375) and the 16-sample one's,
    so the false-skip audit fails at probe 8 and passes after
    escalating. Deterministic."""
    anchor = ((1.1, 0.0, 0.0), 0.5, (0.9, 0.6, 0.5))
    ts = np.linspace(-0.5, 0.5, 13)
    rods = tuple(
        ((-1.25, float(t / np.sqrt(2)), float(sgn * t / np.sqrt(2))),
         0.10, (0.5, 0.9, 0.6))
        for sgn in (1.0, -1.0) for t in ts
        if not (sgn < 0 and abs(t) < 1e-9))
    return (anchor,) + rods


SCENES = ("sphere", "blobs", "room", "pan")


def named_scene(name: str):
    """(spheres, depth_range) of the tools' scenes by name: the unit
    sphere, the blobs and the room of ``RandomState(42)``, the pan
    scene."""
    spheres = {"sphere": lambda: UNIT_SPHERE,
               "blobs": lambda: make_blob_spheres(np.random.RandomState(42)),
               "room": lambda: make_room_spheres(np.random.RandomState(42)),
               "pan": make_pan_scene_spheres}[name]()
    return spheres, (ROOM_DEPTH_RANGE if name == "room" else DEPTH_RANGE)


def look_at_pose(cam_pos: np.ndarray, target: np.ndarray) -> np.ndarray:
    """The world->cam pose [3, 4] of a camera at cam_pos looking at
    target (z up, else y up when looking along z)."""
    z = target - cam_pos
    z = z / np.linalg.norm(z)
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(up, z)) > 0.98:
        up = np.array([0.0, 1.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], 0)
    t = -R @ cam_pos
    return np.concatenate([R, t[:, None]], 1).astype(np.float32)


def sphere_in_frustum(pose, K, h, w, center, radius, margin=0.0) -> bool:
    """Whether the sphere's projected disc (a pinhole small-disc bound)
    meets the image rectangle grown by ``margin`` px; a sphere behind or
    around the camera counts as in."""
    c_cam = pose[:, :3] @ center + pose[:, 3]
    if c_cam[2] <= radius:
        return True
    uv = K @ c_cam
    u, v = uv[0] / uv[2], uv[1] / uv[2]
    pr = K[0, 0] * radius / max(c_cam[2] - radius, 1e-3)
    return (-margin - pr <= u <= w - 1 + margin + pr
            and -margin - pr <= v <= h - 1 + margin + pr)


def make_sphere_scene(rng: np.random.RandomState, rfn: int, h: int,
                      w: int, spheres=UNIT_SPHERE,
                      depth_range=DEPTH_RANGE) -> Dict[str, np.ndarray]:
    """rfn reference views of the spheres (default the unit sphere):
    {imgs [rfn, h, w, 3], poses [rfn, 3, 4], Ks [rfn, 3, 3], depth_range
    [rfn, 2], depth [rfn, h, w, 1]}; depth is the exact z-depth (the
    depth init net's "estimate")."""
    cams = [look_at_camera(rng, h, w) for _ in range(rfn)]
    poses, Ks = zip(*cams)
    # the cameras are drawn in order; the renders (numpy's large operations
    # release the interpreter lock) in threads
    with ThreadPoolExecutor(min(rfn, 8)) as pool:
        views = list(pool.map(
            lambda cam: render_spheres_view(*cam, h, w, spheres), cams))
    imgs, depths, _ = zip(*views)
    return {
        "imgs": np.stack(imgs),
        "poses": np.stack(poses).astype(np.float32),
        "Ks": np.stack(Ks).astype(np.float32),
        "depth_range": np.tile(np.asarray([depth_range], np.float32),
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
    views = []
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
            views.append((split, name, np.concatenate(
                [flip @ rot, flip @ (-rot @ gl[:3, 3:])], 1)))
        with open(base / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": LEGO_CAMERA_ANGLE_X,
                       "frames": frames}, f)

    def write(view):
        split, name, pose = view
        rgb, zdepth, hit = render_spheres_view(pose, K, size, size)
        rgba = np.concatenate([np.round(rgb * 255), hit[..., None] * 255.0],
                              -1)
        write_png(str(base / split / f"{name}.png"), rgba.astype(np.uint8))
        if split == "train":
            write_array(str(base / "colmap_depth" /
                            f"train-{name}.png.geometric.bin"), zdepth)

    # the poses are drawn above in split order; the renders (numpy's large
    # operations and the PNG codec release the interpreter lock) in threads
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, views))


def make_query(rng: np.random.RandomState, h: int, w: int, rn: int,
               full_image: bool = False, spheres=UNIT_SPHERE,
               depth_range=DEPTH_RANGE) -> Dict[str, np.ndarray]:
    """One query view of the spheres: {coords [1, rn, 2], poses [1, 3,
    4], Ks [1, 3, 3], depth_range [1, 2], imgs [1, h, w, 3] (the ground
    truth)}; full_image=True emits the whole pixel grid instead of rn
    random pixels."""
    pose, K = look_at_camera(rng, h, w)
    rgb, _, _ = render_spheres_view(pose, K, h, w, spheres)
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
        "depth_range": np.asarray([depth_range], np.float32),
        "imgs": rgb[None],
    }
