"""Fabricated scenes of the five training families, of LLFF's COLMAP
captures, of the DTU test set and of the example (COLMAP) layout, written in each family's published on-disk layout, for the
tests and ``chip_smoke.py`` (the real captures are not in the
repository).

Each scene is the analytic sphere of ``data/synthetic.py`` seen from
cameras that look at it, rendered with the pose and K that the family's
reader (``data/database.py``, ``data/train_databases.py``) reads back, so
its depth maps are exact: GSO's object views all round, the other
families' views from a cluster of directions (the forward-facing
captures' layout). Files are written with the port's own codecs
(``utils/imageio.py``); the images of several views are written by a
thread pool (the codecs run in C++ outside the interpreter lock).

Every writer takes the data root (``NEURAY_DATA_ROOT``), a scene name, a
view count and a size, and a seed; it returns the database name that reads
the scene back.
"""
from __future__ import annotations

import json
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from neuray_tpu_torch.data import colmap_io
from neuray_tpu_torch.data.synthetic import render_spheres_view
from neuray_tpu_torch.utils.imageio import imwrite


def _look_at(center: np.ndarray) -> np.ndarray:
    """World->cam [3, 4] (OpenCV) of a camera at center looking at the
    origin."""
    z = -center / np.linalg.norm(center)
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(up, z)) > 0.98:
        up = np.array([0.0, 1.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], 0)
    return np.concatenate([R, (-R @ center)[:, None]], 1)


def _cluster(rng, n: int, distance: float, spread: float = 0.25):
    """n camera poses around one direction (a forward-facing capture)."""
    d0 = rng.randn(3)
    d0 /= np.linalg.norm(d0)
    out = []
    for _ in range(n):
        d = d0 + spread * rng.randn(3)
        out.append(_look_at(d / np.linalg.norm(d) * distance))
    return out


def _render(pose, K, h, w, radius=1.0):
    """(rgb uint8 [h, w, 3], z-depth f32 [h, w], hit [h, w]) of a sphere
    of radius at the origin."""
    spheres = (((0.0, 0.0, 0.0), radius, (1.0, 0.5, 1.0)),)
    rgb, depth, hit = render_spheres_view(np.asarray(pose, np.float32),
                                          np.asarray(K, np.float32), h, w,
                                          spheres)
    return np.round(rgb * 255).astype(np.uint8), depth, hit


def _K(f, w, h):
    return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float64)


def _upsample(img: np.ndarray, k: int) -> np.ndarray:
    return np.repeat(np.repeat(img, k, 0), k, 1) if k > 1 else img


def _pool_map(fn, items, workers: int = 8) -> list:
    """fn over items on a thread pool (the renders' large numpy operations
    and the codecs release the interpreter lock), results in order. Each
    writer draws its poses before it renders, so the scene is the same as
    a serial one."""
    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(fn, items))


def _write_all(jobs) -> None:
    """Write each (path, image) of jobs."""
    _pool_map(lambda job: imwrite(*job), jobs)


def write_gso(root, name="sphere", size=512, seed=0) -> str:
    """google_scanned_objects/<name>: its 250 views all round an object of
    radius 0.5, at size x size: ``rgb/`` (RGB PNG), ``mask/`` (gray PNG),
    ``depth/`` (16-bit PNG, mm), ``intrinsics/`` (4x4) and ``pose/``
    (camera-to-world 4x4) txts."""
    rng = np.random.RandomState(seed)
    base = Path(root) / "google_scanned_objects" / name
    for sub in ("rgb", "mask", "depth", "intrinsics", "pose"):
        (base / sub).mkdir(parents=True, exist_ok=True)
    K = _K(1.2 * size, size, size)
    K44 = np.eye(4)
    K44[:3, :3] = K
    poses = []
    for _ in range(250):
        d = rng.randn(3)
        poses.append(_look_at(d / np.linalg.norm(d) * 2.0))

    def write(i):
        pose = poses[i]
        c2w = np.eye(4)
        c2w[:3, :3] = pose[:, :3].T
        c2w[:3, 3] = -pose[:, :3].T @ pose[:, 3]
        np.savetxt(base / "pose" / f"{i:06}.txt", c2w.reshape(-1))
        np.savetxt(base / "intrinsics" / f"{i:06}.txt", K44.reshape(-1))
        rgb, depth, hit = _render(pose, K, size, size, 0.5)
        imwrite(base / "rgb" / f"{i:06}.png", rgb)
        imwrite(base / "mask" / f"{i:06}.png", hit.astype(np.uint8) * 255)
        imwrite(base / "depth" / f"{i:06}.png",
                np.round(depth * 1000).astype(np.uint16))

    _pool_map(write, range(250))
    return f"gso/{name}/black_raw"


def _write_depths(depth_dir: Path, items) -> None:
    depth_dir.mkdir(parents=True, exist_ok=True)
    for fn, depth in items:
        colmap_io.write_array(str(depth_dir / fn), depth)


def write_dtu_train(root, name="scan1", n=10, h=1200, w=1600, seed=0) -> str:
    """dtu_train/<name>: n views (IDR's layout: ``image/<i:06>.png``,
    ``cameras.npz`` with ``world_mat_<i>`` and ``scale_mat_<i>``) and their
    depths under ``colmap_dtu_cache/``."""
    rng = np.random.RandomState(seed)
    base = Path(root) / "dtu_train" / name
    (base / "image").mkdir(parents=True, exist_ok=True)
    K = _K(1.2 * w, w, h)
    poses = _cluster(rng, n, 2.5)
    cams = {}
    for i, pose in enumerate(poses):
        cams[f"world_mat_{i}"] = np.concatenate(
            [K @ pose, [[0.0, 0, 0, 1]]], 0)
        cams[f"scale_mat_{i}"] = np.eye(4)
    np.savez(base / "cameras.npz", **cams)

    def write(i):
        rgb, depth, _ = _render(poses[i], K, h, w)
        imwrite(base / "image" / f"{i:06}.png", rgb)
        return f"{i}.jpg.geometric.bin", depth

    _write_depths(Path(root) / "colmap_dtu_cache" / "dtu_train" / name /
                  "dense" / "stereo" / "depth_maps", _pool_map(write, range(n)))
    return f"dtu_train/{name}"


def _llff_row(pose, h, w, f, near, far):
    """A poses_bounds.npy row: the camera-to-world [down, right, back,
    centre] columns of an OpenCV world->cam pose, (h, w, f), the bounds."""
    R, t = pose[:, :3], pose[:, 3]
    x, y, z = R.T[:, 0], R.T[:, 1], R.T[:, 2]
    m = np.stack([y, x, -z, -R.T @ t, [h, w, f]], 1)
    return np.concatenate([m.reshape(-1), [near, far]])


def write_real_iconic(root, name="sphere", n=10, h=3024, w=4032, factor=4,
                      seed=0) -> str:
    """real_iconic_noface/<name>: n JPEG originals of h x w (each pixel a
    factor x factor block of the render at the reduced size, so the
    reader's INTER_AREA reduction gives that render back), their
    ``poses_bounds.npy``, and the depths at the reduced size under
    ``colmap_forward_cache/``, in the frame the reader rescales the poses
    to (depths times 1 / (0.75 * the least near bound))."""
    rng = np.random.RandomState(seed)
    base = Path(root) / "real_iconic_noface" / name
    (base / "images").mkdir(parents=True, exist_ok=True)
    hs, ws = h // factor, w // factor
    f = 1.2 * w
    K = _K(f / factor, ws, hs)
    near, far = 2.5, 5.5
    scale = 1.0 / (np.float32(near) * 0.75)
    poses = _cluster(rng, n, 4.0)
    rows, jobs, depths = [], [], []
    views = _pool_map(lambda pose: _render(pose, K, hs, ws), poses)
    for i, (pose, (rgb, depth, _)) in enumerate(zip(poses, views)):
        rows.append(_llff_row(pose, h, w, f, near, far))
        jobs.append((base / "images" / f"img_{i:03}.jpg",
                     _upsample(rgb, factor)))
        depths.append((f"{i}.jpg.geometric.bin", depth * scale))
    np.save(base / "poses_bounds.npy", np.asarray(rows))
    _write_all(jobs)
    _write_depths(Path(root) / "colmap_forward_cache" / "real_iconic" /
                  name / str(factor) / "dense_out" / "stereo" / "depth_maps",
                  depths)
    return f"real_iconic/{name}/{factor}"


def write_real_estate(root, name="sphere", n=10, h=720, w=1280,
                      target=(450, 800), seed=0) -> str:
    """real_estate_dataset/train: n frames ``frames/<name>/<ts>.png`` of
    h x w, ``cameras/<name>.txt`` (normalized intrinsics, world->cam
    rows), and the depths at the target size under
    ``colmap_forward_cache/``."""
    rng = np.random.RandomState(seed)
    base = Path(root) / "real_estate_dataset" / "train"
    (base / "frames" / name).mkdir(parents=True, exist_ok=True)
    (base / "cameras").mkdir(parents=True, exist_ok=True)
    th, tw = target
    fx, fy, cx, cy = 1.2 * w / w, 1.2 * w / h, 0.5, 0.5
    poses = _cluster(rng, n, 4.0)

    def render(pose):
        rgb, _, _ = _render(pose, [[fx * w, 0, cx * w], [0, fy * h, cy * h],
                                   [0, 0, 1]], h, w)
        _, depth, _ = _render(pose, [[fx * tw, 0, cx * tw],
                                     [0, fy * th, cy * th], [0, 0, 1]],
                              th, tw)
        return rgb, depth

    lines, jobs, depths = ["https://example.com/clip\n"], [], []
    views = _pool_map(render, poses)
    for i, (pose, (rgb, depth)) in enumerate(zip(poses, views)):
        ts = 1000 * (i + 1)
        lines.append(" ".join(str(v) for v in [ts, fx, fy, cx, cy, 0, 0,
                                               *pose.reshape(-1)]) + "\n")
        jobs.append((base / "frames" / name / f"{ts}.png", rgb))
        depths.append((f"{ts}.jpg.geometric.bin", depth))
    (base / "cameras" / f"{name}.txt").write_text("".join(lines))
    _write_all(jobs)
    _write_depths(Path(root) / "colmap_forward_cache" / "real_estate" / name /
                  "dense_out" / "stereo" / "depth_maps", depths)
    return f"real_estate/{name}/{th}_{tw}"


def write_space(root, name="scene_000", n=10, h=480, w=800, seed=0) -> str:
    """spaces_dataset/data/800/<name>: one rig of n cameras
    (``models.json``: angle-axis orientation, position, focal length,
    principal point) with JPEG images, and the depths under
    ``colmap_forward_cache/``."""
    from scipy.spatial.transform import Rotation
    rng = np.random.RandomState(seed)
    base = Path(root) / "spaces_dataset" / "data" / "800" / name
    (base / "cam").mkdir(parents=True, exist_ok=True)
    f = 1.2 * w
    K = _K(f, w, h)
    poses = _cluster(rng, n, 4.0)
    rig, jobs, depths = [], [], []
    views = _pool_map(lambda pose: _render(pose, K, h, w), poses)
    for i, (pose, (rgb, depth, _)) in enumerate(zip(poses, views)):
        R, t = pose[:, :3], pose[:, 3]
        rig.append({"relative_path": f"cam/image_{i:03}.jpg",
                    "height": h, "width": w, "focal_length": f,
                    "pixel_aspect_ratio": 1.0,
                    "principal_point": [w / 2, h / 2],
                    "position": (-R.T @ t).tolist(),
                    "orientation": Rotation.from_matrix(R).as_rotvec()
                    .tolist()})
        jobs.append((base / "cam" / f"image_{i:03}.jpg", rgb))
        depths.append((f"0-{i}.jpg.geometric.bin", depth))
    (base / "models.json").write_text(json.dumps([rig]))
    _write_all(jobs)
    _write_depths(Path(root) / "colmap_forward_cache" / "space" / name /
                  "dense_out" / "stereo" / "depth_maps", depths)
    return f"space/{name}"


def _write_colmap_model(sparse: Path, poses, K, w, h, names) -> None:
    sparse.mkdir(parents=True, exist_ok=True)
    colmap_io.write_cameras_binary(str(sparse / "cameras.bin"), {
        1: colmap_io.Camera(1, "PINHOLE", w, h,
                            np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]))})
    empty = np.zeros((0, 2)), np.zeros(0, np.int64)
    colmap_io.write_images_binary(str(sparse / "images.bin"), {
        i + 1: colmap_io.Image(i + 1, colmap_io.rotmat2qvec(pose[:, :3]),
                               pose[:, 3], 1, fn, *empty)
        for i, (pose, fn) in enumerate(zip(poses, names))})


def write_llff_colmap(root, name="fern", n=20, h=3024, w=4032, seed=0
                      ) -> str:
    """llff_colmap/<name>: n JPEG originals ``images/IMG_<k>.JPG`` of
    h x w (4 x 4 blocks of the render at the cache's high size, 1008 x
    756 for 4032 x 3024), a COLMAP binary sparse model
    (``sparse/{cameras,images}.bin``, one PINHOLE camera), ``depth_range
    .npy`` and the depths at the cache size in ``colmap_depth/``."""
    rng = np.random.RandomState(seed)
    base = Path(root) / "llff_colmap" / name
    (base / "images").mkdir(parents=True, exist_ok=True)
    k = w // 1008 if w >= 1008 else 1
    hs, ws = h // k, w // k
    K = _K(1.2 * w, w, h)
    Ks = _K(1.2 * ws, ws, hs)
    poses = _cluster(rng, n, 4.0)
    names = [f"IMG_{4026 + i}.JPG" for i in range(n)]
    jobs, depths = [], []
    views = _pool_map(lambda pose: _render(pose, Ks, hs, ws), poses)
    for i, (rgb, depth, _) in enumerate(views):
        jobs.append((base / "images" / names[i], _upsample(rgb, k)))
        depths.append((f"{i + 1}.jpg.geometric.bin", depth))
    _write_colmap_model(base / "sparse", poses, K, w, h, names)
    np.save(base / "depth_range.npy", np.tile([[2.5, 5.5]], (n, 1)))
    _write_all(jobs)
    _write_depths(base / "colmap_depth", depths)
    return f"llff_colmap/{name}/high"


def write_dtu_test(root, name="scan24", n=6, h=1200, w=1600, seed=0) -> str:
    """dtu_test/<name>: IDR's layout (``image/``, ``mask/<i:03>.png``,
    ``cameras.npz``), ``depth_range.npy`` and ``colmap_depth/`` at half
    the size (800 wide for 1600). The reader scales K from 1600x1200, so
    only that size makes images and cameras agree."""
    rng = np.random.RandomState(seed)
    base = Path(root) / "dtu_test" / name
    for sub in ("image", "mask", "colmap_depth"):
        (base / sub).mkdir(parents=True, exist_ok=True)
    K = _K(1.2 * w, w, h)
    Kd = K * [[0.5], [0.5], [1]]
    poses = _cluster(rng, n, 2.5)

    def render(pose):
        rgb, _, hit = _render(pose, K, h, w)
        _, depth, _ = _render(pose, Kd, h // 2, w // 2)
        return rgb, hit, depth

    cams, jobs = {}, []
    views = _pool_map(render, poses)
    for i, (pose, (rgb, hit, depth)) in enumerate(zip(poses, views)):
        cams[f"world_mat_{i}"] = np.concatenate(
            [K @ pose, [[0.0, 0, 0, 1]]], 0)
        jobs += [(base / "image" / f"{i:06}.png", rgb),
                 (base / "mask" / f"{i:03}.png",
                  np.repeat(hit[..., None], 3, 2).astype(np.uint8) * 255)]
        colmap_io.write_array(str(base / "colmap_depth" / f"{i}.jpg.geometric.bin"),
                      depth)
    np.savez(base / "cameras.npz", **cams)
    np.save(base / "depth_range.npy", np.asarray([1.0, 4.0], np.float32))
    _write_all(jobs)
    return f"dtu_test/{name}/black_{w // 2}"


def write_example(root, name="desk", n=6, h=48, w=64, seed=0) -> str:
    """example/<name>: a COLMAP sparse model (``sparse/0``, points
    included), JPEG images and dense depths in ``dense/stereo/
    depth_maps/``."""
    rng = np.random.RandomState(seed)
    base = Path(root) / "example" / name
    (base / "images").mkdir(parents=True, exist_ok=True)
    K = _K(1.2 * w, w, h)
    poses = _cluster(rng, n, 4.0)
    names = [f"frame_{i}.jpg" for i in range(n)]
    jobs, depths = [], []
    views = _pool_map(lambda pose: _render(pose, K, h, w), poses)
    for (rgb, depth, _), fn in zip(views, names):
        jobs.append((base / "images" / fn, rgb))
        depths.append((f"{fn}.geometric.bin", depth))
    _write_colmap_model(base / "sparse" / "0", poses, K, w, h, names)
    pts = rng.randn(40, 3)
    pts = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    none = np.zeros(0, np.int32)
    colmap_io.write_points3d_binary(
        str(base / "sparse" / "0" / "points3D.bin"),
        {k + 1: colmap_io.Point3D(k + 1, p, np.array([200, 100, 50]), 0.5,
                                  none, none)
         for k, p in enumerate(pts)})
    _write_all(jobs)
    _write_depths(base / "dense" / "stereo" / "depth_maps", depths)
    return f"example/{name}/raw"


def write_training_mixture(root, gso_size=512, dtu=(1200, 1600),
                           iconic=(3024, 4032), estate=(720, 1280),
                           space=(480, 800), n=10) -> dict:
    """One scene of each of the five training families (``dtu_train``,
    ``space``, ``real_iconic``, ``real_estate``, ``gso``) at the given
    sizes, n views each (GSO: its 250); returns family -> database name
    and the seconds each took to write."""
    names, seconds = {}, {}
    for family, write in (
            ("gso", lambda: write_gso(root, size=gso_size)),
            ("dtu_train", lambda: write_dtu_train(root, n=n, h=dtu[0],
                                                  w=dtu[1])),
            ("real_iconic", lambda: write_real_iconic(
                root, n=n, h=iconic[0], w=iconic[1])),
            ("real_estate", lambda: write_real_estate(
                root, n=n, h=estate[0], w=estate[1])),
            ("space", lambda: write_space(root, n=n, h=space[0],
                                          w=space[1]))):
        t0 = time.perf_counter()
        names[family] = write()
        seconds[family] = time.perf_counter() - t0
    return {"names": names, "seconds": seconds}
