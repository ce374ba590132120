"""Host throughput of the generalization training's input pipeline (port
of ``tools/bench_input_pipeline.py``):

    python -m neuray_tpu_torch.bench_input_pipeline [--views 250]
        [--scenes 1] [--samples 16] [--gil]

fabricates GSO-format scenes (the heaviest mixture member: 512x512 rgb,
mask and 16-bit depth PNGs a view; ``data/train_databases.py:
GoogleScannedObjectDatabase`` reads 250 views) under a temporary data
root, the JAX tool's pixels exactly (a textured pattern plus noise, a
square mask, depths in mm, from ``RandomState(0)``), written by
``utils/png.py: write_png``. It then times
``data/train_dataset.py: GeneralRendererDataset`` making samples (each
decodes ~10 views, runs the depth and range augmentations and draws 512
rays):

  * ``single_thread``: ``dataset[i]`` in this process;
  * ``dataloader_w<n>`` for n = 1, 2, 4: the trainers' own loader
    (``train/trainer.py: sample_loader``, a ``DataLoader`` of n spawned
    workers), timed after the loader's first 2n + 1 samples (its start
    and prefetch) have come; ``first_sample_s`` is the time from the
    loader's creation to its first sample (the workers' start, which the
    JAX tool's threads do not pay). These rows take the place of the JAX
    tool's ``Prefetcher`` rows; its fork mode (``prefetcher_p<n>``) is
    not ported (it has no backpressure, ROADMAP hazard e);
  * with ``--gil``, ``gil_profile``: the share of a sample's time that
    releases the interpreter lock, from a spinner thread's rate while
    samples are made against its idle rate (x2, as in the JAX tool), and
    ``sample_s``, a sample's time beside the spinner: each release of the
    lock hands it to the spinner for a switch interval, so the samples
    run many times slower than alone and the estimate saturates at 1.

One JSON line a row, after a line with the scenes' fabrication time.
Host only: it never touches the card.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from neuray_tpu_torch.data import database as D
from neuray_tpu_torch.data.train_dataset import GeneralRendererDataset
from neuray_tpu_torch.train.trainer import sample_loader
from neuray_tpu_torch.utils.png import write_png

WORKERS = (1, 2, 4)
PREFETCH = 2        # DataLoader's prefetch_factor: samples a worker holds


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--views", type=int, default=250)
    ap.add_argument("--scenes", type=int, default=1)
    ap.add_argument("--samples", type=int, default=16)
    ap.add_argument("--gil", action="store_true",
                    help="estimate the share of a sample's time that "
                    "releases the interpreter lock (a spinner thread)")
    return ap.parse_args(argv)


def look_at_pose(center):
    center = np.asarray(center, np.float64)
    z = -center / np.linalg.norm(center)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], 0)
    return np.concatenate([R, (-R @ center)[:, None]], 1)


def fabricate_gso_scene(root: str, name: str, views: int,
                        rng: np.random.RandomState) -> None:
    """The JAX tool's GSO scene ``name`` under root: the same pose and
    intrinsics files and the same pixels. The JAX tool writes its rgb
    arrays with cv2, which takes them as BGR: the files hold them
    reversed, and so does this writer."""
    scene = os.path.join(root, "google_scanned_objects", name)
    for sub in ("rgb", "mask", "depth", "intrinsics", "pose"):
        os.makedirs(os.path.join(scene, sub), exist_ok=True)
    K44 = np.eye(4)
    K44[:3, :3] = [[512.0, 0, 256], [0, 512.0, 256], [0, 0, 1]]
    ys, xs = np.mgrid[0:512, 0:512]
    base = np.stack([(xs // 8 % 32) * 8, (ys // 8 % 32) * 8,
                     ((xs + ys) // 16 % 32) * 8], -1).astype(np.uint8)
    mask = np.zeros((512, 512), np.uint8)
    mask[100:400, 100:400] = 255
    with ThreadPoolExecutor(8) as pool:     # zlib releases the lock
        for f in [pool.submit(write_png, *a)
                  for a in _gso_views(scene, views, rng, K44, base, mask)]:
            f.result()


def _gso_views(scene, views, rng, K44, base, mask):
    """Write each view's pose and intrinsics and yield its PNGs' (path,
    pixels), drawing the noise in the JAX tool's order."""
    for i in range(views):
        ang = 2 * np.pi * i / views
        center = np.asarray([np.cos(ang), np.sin(ang), 0.5]) * 1.4
        pose = look_at_pose(center)
        c2w = np.eye(4)
        c2w[:3, :3] = pose[:, :3].T
        c2w[:3, 3] = center
        np.savetxt(os.path.join(scene, "pose", f"{i:06}.txt"),
                   c2w.reshape(-1))
        np.savetxt(os.path.join(scene, "intrinsics", f"{i:06}.txt"),
                   K44.reshape(-1))
        img = base + rng.randint(0, 32, (512, 512, 3)).astype(np.uint8)
        depth_mm = 1000 + (rng.rand(512, 512) * 1500).astype(np.uint16)
        yield (os.path.join(scene, "rgb", f"{i:06}.png"),
               np.ascontiguousarray(img[..., ::-1]))
        yield os.path.join(scene, "mask", f"{i:06}.png"), mask
        yield os.path.join(scene, "depth", f"{i:06}.png"), depth_mm


def gso_dataset() -> GeneralRendererDataset:
    return GeneralRendererDataset(
        {"train_database_types": ["gso"], "type2sample_weights": {"gso": 1},
         "resolution_type": "hr"}, is_train=True)


def rate(tag: str, seconds: float, n: int) -> dict:
    per = seconds / n
    return {"mode": tag, "sample_s": round(per, 4),
            "samples_per_s": round(1 / per, 3)}


def gil_profile(ds, samples: int) -> dict:
    """The JAX tool's spinner profile of ``ds[i]``: a background thread
    counts while samples are made; twice its busy rate over its idle rate
    estimates the share of the sample time that releases the lock."""
    counter = {"n": 0, "stop": False}

    def spin():
        while not counter["stop"]:
            counter["n"] += 1

    t = threading.Thread(target=spin, daemon=True)
    t.start()
    time.sleep(1.0)
    idle0 = counter["n"]
    time.sleep(2.0)
    idle_rate = (counter["n"] - idle0) / 2.0
    n0 = counter["n"]
    t0 = time.perf_counter()
    for i in range(samples):
        ds[i + 1]
    dt = time.perf_counter() - t0
    busy_rate = (counter["n"] - n0) / dt
    counter["stop"] = True
    t.join(timeout=1.0)
    return {"mode": "gil_profile",
            "spinner_idle_per_s": round(idle_rate, 0),
            "spinner_busy_per_s": round(busy_rate, 0),
            "est_gil_released_frac": round(
                min(1.0, 2.0 * busy_rate / max(idle_rate, 1.0)), 3),
            "sample_s": round(dt / samples, 4)}


def run(flags, log=print):
    """The rows, each printed as a JSON line as it is measured. The data
    root is ``NEURAY_DATA_ROOT`` for the spawned workers and
    ``data/database.py``'s ``DATA_ROOT`` here, both put back after."""
    tmp = tempfile.mkdtemp(prefix="neuray_pipe_bench_")
    saved = D.DATA_ROOT, os.environ.get("NEURAY_DATA_ROOT")
    rows = []

    def emit(row):
        log(json.dumps(row), flush=True)
        rows.append(row)

    try:
        rng = np.random.RandomState(0)
        t0 = time.perf_counter()
        for s in range(flags.scenes):
            fabricate_gso_scene(tmp, f"obj{s}", flags.views, rng)
        log(f"fabricated {flags.scenes} scene(s) of {flags.views} views in "
            f"{time.perf_counter() - t0:.1f} s", flush=True)
        D.DATA_ROOT = os.environ["NEURAY_DATA_ROOT"] = tmp
        ds = gso_dataset()
        ds[0]                               # warm-up
        t0 = time.perf_counter()
        for i in range(flags.samples):
            ds[i + 1]
        emit(rate("single_thread", time.perf_counter() - t0, flags.samples))
        for workers in WORKERS:
            warm = PREFETCH * workers + 1
            t0 = time.perf_counter()
            it = sample_loader(ds, list(range(1, warm + flags.samples + 1)),
                               workers)
            next(it)
            first = time.perf_counter() - t0
            for _ in range(warm - 1):
                next(it)
            t0 = time.perf_counter()
            for _ in range(flags.samples):
                next(it)
            emit({**rate(f"dataloader_w{workers}", time.perf_counter() - t0,
                         flags.samples),
                  "first_sample_s": round(first, 3)})
            del it
        if flags.gil:
            emit(gil_profile(ds, flags.samples))
    finally:
        D.DATA_ROOT = saved[0]
        if saved[1] is None:
            os.environ.pop("NEURAY_DATA_ROOT", None)
        else:
            os.environ["NEURAY_DATA_ROOT"] = saved[1]
        shutil.rmtree(tmp, ignore_errors=True)
    return rows


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
