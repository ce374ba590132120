"""COLMAP's file formats (port of ``neuray_tpu/data/colmap_io.py``;
https://colmap.github.io/format.html), in struct and numpy.

The sparse model: ``read_cameras_binary``, ``read_images_binary`` and
``read_points3d_binary`` (``cameras.bin``, ``images.bin``,
``points3D.bin``) into ``Camera``, ``Image`` and ``Point3D`` records, and
``qvec2rotmat``. The JAX package may read these through its native
reader (``colmap_native.py``); the scenes the port reads (fern's model,
a few hundred points) need none.

The dense maps (``*.geometric.bin``): an ascii ``w&h&c&`` header, then
the f32 values with the width fastest, then the height, then the channels
(column major); ``read_array`` and ``write_array``.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict

import numpy as np

# camera_model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    def K(self) -> np.ndarray:
        """3x3 intrinsics of a pinhole-family model."""
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
            f, cx, cy = self.params[:3]
            fx = fy = f
        else:
            fx, fy, cx, cy = self.params[:4]
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


@dataclass
class Image:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3d_ids: np.ndarray

    def R(self) -> np.ndarray:
        return qvec2rotmat(self.qvec)

    def pose34(self) -> np.ndarray:
        """[3, 4] world->cam extrinsics."""
        return np.concatenate([self.R(), self.tvec[:, None]], 1)


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2d_idxs: np.ndarray


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w,
         2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
         1 - 2 * x * x - 2 * y * y]])


def _read(f, fmt: str):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path: str) -> Dict[int, Camera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{num_params}d"))
            cams[cam_id] = Camera(cam_id, name, width, height, params)
    return cams


def read_images_binary(path: str) -> Dict[int, Image]:
    images = {}
    rec_type = np.dtype([("x", "<f8"), ("y", "<f8"), ("id", "<i8")])
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            (img_id,) = _read(f, "<i")
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            (cam_id,) = _read(f, "<i")
            name = b""
            while (c := f.read(1)) != b"\x00":
                if not c:
                    raise ValueError(f"{path}: truncated image name")
                name += c
            (n2d,) = _read(f, "<Q")
            rec = np.frombuffer(f.read(24 * n2d), dtype=rec_type)
            images[img_id] = Image(img_id, qvec, tvec, cam_id,
                                   name.decode("utf-8"),
                                   np.stack([rec["x"], rec["y"]], -1),
                                   rec["id"].copy())
    return images


def read_points3d_binary(path: str) -> Dict[int, Point3D]:
    pts = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            (pid,) = _read(f, "<Q")
            xyz = np.array(_read(f, "<3d"))
            rgb = np.array(_read(f, "<3B"))
            (err,) = _read(f, "<d")
            (track_len,) = _read(f, "<Q")
            track = np.frombuffer(f.read(8 * track_len), np.int32).reshape(
                track_len, 2)
            pts[pid] = Point3D(pid, xyz, rgb, err, track[:, 0].copy(),
                               track[:, 1].copy())
    return pts


def read_array(path: str) -> np.ndarray:
    """A dense map file -> f32 [h, w, c], squeezed ([h, w] for c = 1), an
    array of its own (writable: readers mask it in place)."""
    with open(path, "rb") as f:
        header = b""
        amp = 0
        while amp < 3:
            c = f.read(1)
            header += c
            if c == b"&":
                amp += 1
        w, h, c = (int(x) for x in header.decode("ascii").split("&")[:3])
        data = np.frombuffer(f.read(), dtype=np.float32)
    arr = data.reshape((w, h, c), order="F").transpose(1, 0, 2)
    return np.squeeze(np.array(arr, order="C"))


def write_array(path: str, arr: np.ndarray) -> None:
    """Write arr [h, w] or [h, w, c] as a dense map file that
    ``read_array`` reads back."""
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    with open(path, "wb") as f:
        f.write(f"{w}&{h}&{c}&".encode("ascii"))
        f.write(arr.transpose(1, 0, 2).reshape(-1, order="F").tobytes())


def write_cameras_binary(path: str, cams: Dict[int, Camera]) -> None:
    """``cams`` as a ``cameras.bin`` that ``read_cameras_binary`` reads
    back."""
    ids = {name: i for i, (name, _) in CAMERA_MODELS.items()}
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            f.write(struct.pack("<iiQQ", cam.id, ids[cam.model], cam.width,
                                cam.height))
            f.write(np.asarray(cam.params, "<f8").tobytes())


def write_images_binary(path: str, images: Dict[int, Image]) -> None:
    """``images`` as an ``images.bin`` that ``read_images_binary`` reads
    back."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for img in images.values():
            f.write(struct.pack("<i4d3di", img.id, *img.qvec, *img.tvec,
                                img.camera_id))
            f.write(img.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", len(img.point3d_ids)))
            rec = np.zeros(len(img.point3d_ids), [("x", "<f8"), ("y", "<f8"),
                                                  ("id", "<i8")])
            if len(rec):
                rec["x"], rec["y"] = img.xys[:, 0], img.xys[:, 1]
                rec["id"] = img.point3d_ids
            f.write(rec.tobytes())


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """The unit quaternion (w, x, y, z), w >= 0, of rotation R:
    ``qvec2rotmat`` of it gives R back."""
    w = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    x = np.sqrt(max(0.0, 1 + R[0, 0] - R[1, 1] - R[2, 2])) / 2
    y = np.sqrt(max(0.0, 1 - R[0, 0] + R[1, 1] - R[2, 2])) / 2
    z = np.sqrt(max(0.0, 1 - R[0, 0] - R[1, 1] + R[2, 2])) / 2
    x = np.copysign(x, R[2, 1] - R[1, 2])
    y = np.copysign(y, R[0, 2] - R[2, 0])
    z = np.copysign(z, R[1, 0] - R[0, 1])
    q = np.asarray([w, x, y, z])
    return q / np.linalg.norm(q)


def write_points3d_binary(path: str, points: Dict[int, Point3D]) -> None:
    """``points`` as a ``points3D.bin`` that ``read_points3d_binary``
    reads back."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack("<Q3d3Bd", p.id, *p.xyz,
                                *np.asarray(p.rgb, np.uint8), p.error))
            track = np.stack([p.image_ids, p.point2d_idxs], -1).astype("<i4")
            f.write(struct.pack("<Q", len(track)))
            f.write(track.tobytes())
