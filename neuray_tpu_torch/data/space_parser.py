"""Spaces-dataset scenes (``models.json`` camera rigs; port of
``neuray_tpu/data/space_parser.py``, reference
utils/space_dataset_utils.py): the json's angle-axis is camera-from-world,
so world-from-camera takes the negated rotation; fy is the focal length
times the pixel aspect ratio."""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np
from scipy.spatial.transform import Rotation


@dataclass
class SpaceCamera:
    intrinsics: np.ndarray  # 3x3
    w_f_c: np.ndarray       # 4x4 world-from-camera


@dataclass
class SpaceView:
    image_path: str
    shape: tuple            # (h, w)
    camera: SpaceCamera
    image: object = field(default=None)


def _world_from_camera(view_json) -> np.ndarray:
    transform = np.identity(4)
    transform[0:3, 3] = view_json["position"]
    angle_axis = np.asarray(view_json["orientation"], np.float64)
    if np.linalg.norm(angle_axis) < 1e-7:
        return transform
    transform[0:3, 0:3] = Rotation.from_rotvec(-angle_axis).as_matrix()
    return transform


def _intrinsics(view_json) -> np.ndarray:
    K = np.identity(3)
    K[0, 0] = view_json["focal_length"]
    K[1, 1] = view_json["focal_length"] * view_json["pixel_aspect_ratio"]
    K[0, 2] = view_json["principal_point"][0]
    K[1, 2] = view_json["principal_point"][1]
    return K


def read_view(base_dir: str, view_json) -> SpaceView:
    return SpaceView(
        image_path=os.path.join(base_dir, view_json["relative_path"]),
        shape=(int(view_json["height"]), int(view_json["width"])),
        camera=SpaceCamera(_intrinsics(view_json),
                           _world_from_camera(view_json)))


def read_scene(base_dir: str):
    """Every rig of a scene: a list (rig) of lists (camera) of
    ``SpaceView``."""
    with open(os.path.join(base_dir, "models.json")) as f:
        model_json = json.load(f)
    return [[read_view(base_dir, vj) for vj in views]
            for views in model_json]
