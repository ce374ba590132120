"""Training datasets. The synthetic sphere scenes in the train-step schema
(a numpy copy of ``neuray_tpu/data/train_dataset.py:
SyntheticRendererDataset``, the same arrays for the same index), built on
the port's ``data/synthetic.py``. The real-data ``GeneralRendererDataset``
is not ported yet."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from neuray_tpu_torch.data.synthetic import make_query, make_sphere_scene


class SyntheticRendererDataset:
    """Sample ``index``: rfn reference views of the unit sphere at h x w
    with their exact depth as ``true_depth``, one query view (train:
    ``train_ray_num`` random pixels; eval: the full image) and
    ``depth_loss_coords_num`` random pixels per reference view for the
    depth loss, all drawn from ``RandomState(index % 2**16)``."""

    default_cfg = {
        "rfn": 3,
        "h": 32,
        "w": 32,
        "train_ray_num": 64,
        "depth_loss_coords_num": 16,
        "num": 1024,
    }

    def __init__(self, cfg: Dict[str, Any], is_train: bool):
        self.cfg = {**self.default_cfg, **cfg}
        self.is_train = is_train

    def __getitem__(self, index) -> Dict[str, Any]:
        c = self.cfg
        rng = np.random.RandomState(index % (2 ** 16))
        ref = make_sphere_scene(rng, c["rfn"], c["h"], c["w"])
        ref["true_depth"] = ref["depth"]
        que = make_query(rng, c["h"], c["w"], c["train_ray_num"],
                         full_image=not self.is_train)
        xs = rng.randint(0, c["w"], (c["rfn"], c["depth_loss_coords_num"]))
        ys = rng.randint(0, c["h"], (c["rfn"], c["depth_loss_coords_num"]))
        return {"ref": ref, "que": que,
                "depth_loss_coords": np.stack([xs, ys], -1).astype(
                    np.float32),
                "is_gso": np.zeros([], np.float32),
                "scene_name": "synthetic/sphere"}

    def __len__(self):
        return self.cfg["num"]


name2dataset = {"synthetic": SyntheticRendererDataset}
