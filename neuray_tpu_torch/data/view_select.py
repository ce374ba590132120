"""Working-view selection by nearest camera centres (port of
``neuray_tpu/data/view_select.py``; reference utils/view_select.py)."""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def _camera_centers(poses) -> np.ndarray:
    """World-space camera centres from [n, 3, 4] world->cam poses."""
    return np.asarray([-pose[:, :3].T @ pose[:, 3] for pose in poses])


def compute_nearest_camera_indices(database, que_ids: List[str],
                                   ref_ids: Optional[List[str]] = None
                                   ) -> np.ndarray:
    """For each query image id, the ref indices sorted by camera distance
    -> [len(que_ids), len(ref_ids)]."""
    if ref_ids is None:
        ref_ids = que_ids
    ref_pts = _camera_centers([database.get_pose(i) for i in ref_ids])
    que_pts = _camera_centers([database.get_pose(i) for i in que_ids])
    dists = np.linalg.norm(ref_pts[None] - que_pts[:, None], 2, 2)
    return np.argsort(dists, 1)


def select_working_views(ref_poses, que_poses, work_num: int,
                         exclude_self: bool = False) -> np.ndarray:
    """The work_num nearest ref views per query pose -> [qn, work_num]
    indices (the nearest one left out with ``exclude_self``)."""
    ref_pts = _camera_centers(ref_poses)
    que_pts = _camera_centers(que_poses)
    dists = np.linalg.norm(ref_pts[None] - que_pts[:, None], 2, 2)
    ids = np.argsort(dists, 1)
    if exclude_self:
        return ids[:, 1:work_num + 1]
    return ids[:, :work_num]


def select_working_views_db(database, ref_ids, que_poses, work_num: int,
                            exclude_self: bool = False) -> np.ndarray:
    """``select_working_views`` over database ids (every image of the
    database when ref_ids is None) -> [qn, work_num] image ids."""
    ref_ids = database.get_img_ids() if ref_ids is None else ref_ids
    ref_poses = np.asarray([database.get_pose(i) for i in ref_ids])
    idx = select_working_views(ref_poses, que_poses, work_num, exclude_self)
    return np.asarray(ref_ids)[idx]
