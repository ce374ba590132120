"""Camera trajectories for the render CLI (port of
``neuray_tpu/data/render_poses.py``; reference utils/render_poses.py).

``interpolate_render_poses``: a smooth path through keyframe cameras, the
rotations SLERPed and the centres cubic-splined, both over the
accumulated rotation angle between keyframes. ``forward_circle_poses``:
an LLFF-style circle around the average camera of a forward-facing
capture. ``get_render_poses``: ``inter`` / ``inter_<n>`` (keyframes from
a txt of image indices, the format of ``configs/inter_trajectory/``, or
every image) and ``circle``. Poses are world->camera [n, 3, 4] float32.
"""
from __future__ import annotations

import numpy as np
from scipy.interpolate import CubicSpline
from scipy.spatial.transform import Rotation, Slerp


def pose_inverse(pose: np.ndarray) -> np.ndarray:
    """The inverse of a rigid [3, 4] transform."""
    R, t = pose[:, :3], pose[:, 3:]
    return np.concatenate([R.T, -R.T @ t], 1)


def _normalize(x):
    return x / np.linalg.norm(x)


def _viewmatrix(z, up, pos):
    """A camera->world [3, 4] looking along z with ``up`` as its down
    axis reference, at pos."""
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(vec2, up))
    vec1 = _normalize(np.cross(vec0, vec2))
    return np.stack([-vec0, vec1, vec2, pos], 1)


def interpolate_render_poses(database, inter_img_ids, view_num: int,
                             loop: bool = True) -> np.ndarray:
    """view_num poses along the keyframes' path (back to the first one
    with ``loop``) -> [view_num, 3, 4]."""
    inter_img_ids = list(inter_img_ids)
    if loop:
        inter_img_ids = inter_img_ids + inter_img_ids[-2::-1]
    poses = [database.get_pose(str(i)) for i in inter_img_ids]
    cam_pts = np.asarray([pose_inverse(p) for p in poses])[:, :, 3]
    cam_rots = np.asarray([p[:, :3] for p in poses])

    rot_ang = [np.linalg.norm(Rotation.from_matrix(
        cam_rots[k + 1] @ cam_rots[k].T).as_rotvec())
        for k in range(len(inter_img_ids) - 1)]
    knots = np.concatenate([np.zeros(1), np.cumsum(rot_ang)])
    # Slerp and CubicSpline need strictly increasing knots
    knots = knots + np.arange(len(knots)) * 1e-8
    ts = np.linspace(knots[0], knots[-1], view_num)

    R = Slerp(knots, Rotation.from_matrix(cam_rots))(ts).as_matrix()
    centers = CubicSpline(knots, cam_pts)(ts)
    t = R @ -centers[:, :, None]
    return np.concatenate([R, t], 2).astype(np.float32)


def forward_circle_poses(database, view_num: int = 60) -> np.ndarray:
    """view_num poses on a circle around the average camera of a
    forward-facing capture, looking at its focal depth -> [view_num, 3,
    4]."""
    img_ids = database.get_img_ids()
    poses = [database.get_pose(i) for i in img_ids]
    poses_inv = np.asarray([pose_inverse(p) for p in poses])
    cam_pts = poses_inv[:, :, 3]
    down = poses_inv[:, :, 1]
    lookat = poses_inv[:, :, 2]

    avg_cam_pt = (np.max(cam_pts, 0) + np.min(cam_pts, 0)) / 2
    avg_down = np.mean(down, 0)
    avg_lookat = np.mean(lookat, 0)
    avg_pose_inv = _viewmatrix(avg_lookat, avg_down, avg_cam_pt)
    avg_pose = pose_inverse(avg_pose_inv)

    pts_avg = cam_pts @ avg_pose[:, :3].T + avg_pose[:, 3]
    rads = np.percentile(np.abs(pts_avg), 90, 0)

    ranges = np.asarray([database.get_depth_range(i) for i in img_ids])
    near, far = np.mean(ranges[:, 0]), np.mean(ranges[:, 1])
    dt = 0.75
    focal = 1.0 / ((1.0 - dt) / near + dt / far)
    rads[2] = near * 0.2
    rads = rads * 0.8
    rads = np.concatenate([rads, [1.0]])

    out = []
    for theta in np.linspace(0, 2 * np.pi, view_num + 1)[:-1]:
        c = avg_pose_inv @ (np.asarray(
            [-np.sin(theta), np.cos(theta), 0.0, 1.0]) * rads)
        z = _normalize(avg_pose_inv @ np.asarray([0, 0, focal, 1.0]) - c)
        out.append(pose_inverse(_viewmatrix(z, avg_down, c)))
    return np.asarray(out, np.float32)


def get_render_poses(database, pose_type: str, pose_fn=None) -> np.ndarray:
    """The trajectory of ``pose_type``: ``inter`` (60 poses) or
    ``inter_<n>`` through the keyframes pose_fn lists (image indices,
    whitespace-separated; every image without pose_fn), or ``circle``."""
    if pose_type.startswith("inter"):
        parts = pose_type.split("_")
        view_num = int(parts[1]) if len(parts) > 1 else 60
        img_ids = list(database.get_img_ids())
        if pose_fn is not None:
            idx = np.loadtxt(pose_fn, dtype=np.int64).reshape(-1)
            img_ids = [img_ids[i] for i in idx]
        return interpolate_render_poses(database, img_ids, view_num, True)
    if pose_type == "circle":
        return forward_circle_poses(database)
    raise NotImplementedError(pose_type)
