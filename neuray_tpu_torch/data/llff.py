"""LLFF-format captures (``poses_bounds.npy``; port of
``neuray_tpu/data/llff.py``, reference utils/llff_utils.py): the pose
average and recentering, ``load_llff_data``, and ``_minify``, which
writes each image reduced by the factor (INTER_AREA) as a PNG into
``images_<factor>/`` once and reuses it, as the JAX package's does
through cv2 (the reference shells out to ImageMagick); like cv2.imread's
default, it reads a JPEG upright by its EXIF orientation."""
from __future__ import annotations

import os

import numpy as np

from neuray_tpu_torch.data.image_ops import resize_area
from neuray_tpu_torch.utils.imageio import imread_color
from neuray_tpu_torch.utils.png import read_png, write_png


def _normalize(x):
    return x / np.linalg.norm(x)


def _viewmatrix(z, up, pos):
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def poses_avg(poses):
    """poses [n, 3, 5] -> their average camera-to-world [3, 5]."""
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([_viewmatrix(vec2, up, center), hwf], 1)


def recenter_poses(poses):
    """poses [n, 3, 5] in the frame of their average pose."""
    poses_ = poses + 0
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = np.concatenate([poses_avg(poses)[:3, :4], bottom], -2)
    bottom = np.tile(np.reshape(bottom, [1, 1, 4]), [poses.shape[0], 1, 1])
    p44 = np.concatenate([poses[:, :3, :4], bottom], -2)
    p44 = np.linalg.inv(c2w) @ p44
    poses_[:, :3, :4] = p44[:, :3, :4]
    return poses_


def _minify(basedir: str, factor: int):
    """The images of ``basedir/images`` reduced by factor into
    ``images_<factor>/<name>.png`` (written once); returns their paths."""
    imgdir = os.path.join(basedir, f"images_{factor}")
    srcdir = os.path.join(basedir, "images")
    fns = sorted(f for f in os.listdir(srcdir)
                 if f.lower().endswith((".jpg", ".jpeg", ".png")))
    os.makedirs(imgdir, exist_ok=True)
    out_fns = []
    for fn in fns:
        out = os.path.join(imgdir, os.path.splitext(fn)[0] + ".png")
        out_fns.append(out)
        if os.path.exists(out):
            continue
        img = imread_color(os.path.join(srcdir, fn))
        h, w = img.shape[:2]
        write_png(out, resize_area(img, (int(np.round(w / factor)),
                                         int(np.round(h / factor)))))
    return out_fns


def load_llff_data(basedir: str, factor: int = 8, recenter: bool = True,
                   bd_factor: float = 0.75):
    """(images uint8 [n, h, w, 3] RGB, poses [n, 3, 5] with the hwf
    column, bds [n, 2], render_poses [120, 3, 5], i_test)."""
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])

    img_fns = _minify(basedir, factor)
    if poses.shape[-1] != len(img_fns):
        raise ValueError(f"{len(img_fns)} images vs {poses.shape[-1]} poses "
                         f"in {basedir}")
    imgs = [read_png(f)[:, :, :3] for f in img_fns]
    sh = imgs[0].shape
    poses[:2, 4, :] = np.array(sh[:2]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] / factor

    # LLFF [down right back] -> [right up back]
    poses = np.concatenate(
        [poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    images = np.stack(imgs, 0)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds *= sc
    if recenter:
        poses = recenter_poses(poses)

    # the spiral render path
    c2w = poses_avg(poses)
    up = _normalize(poses[:, :3, 1].sum(0))
    close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
    dt = 0.75
    focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    rads = np.percentile(np.abs(poses[:, :3, 3]), 90, 0)
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    render_poses = []
    for theta in np.linspace(0.0, 2.0 * np.pi * 2, 121)[:-1]:
        c = c2w[:3, :4] @ (np.array([np.cos(theta), -np.sin(theta),
                                     -np.sin(theta * 0.5), 1.0]) * rads)
        z = _normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        render_poses.append(
            np.concatenate([_viewmatrix(z, up, c), hwf], 1))
    render_poses = np.asarray(render_poses, np.float32)

    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    i_test = int(np.argmin(dists))
    return images.astype(np.uint8), poses, bds, render_poses, i_test
