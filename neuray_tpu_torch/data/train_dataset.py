"""Training datasets. The synthetic sphere scenes in the train-step schema
(a numpy copy of ``neuray_tpu/data/train_dataset.py:
SyntheticRendererDataset``, the same arrays for the same index), built on
the port's ``data/synthetic.py``; and the cost-volume source-view wiring
``build_src_imgs_info_select``. The real-data ``GeneralRendererDataset``
is not ported yet."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from neuray_tpu_torch.data.imgs_info import build_imgs_info
from neuray_tpu_torch.data.synthetic import make_query, make_sphere_scene
from neuray_tpu_torch.data.view_select import compute_nearest_camera_indices


def build_src_imgs_info_select(database, ref_ids, ref_ids_all,
                               cost_volume_nn_num: int,
                               pad_interval: int = -1):
    """One imgs_info over the union of the selected ref views and each
    one's ``cost_volume_nn_num`` nearest views among ref_ids_all (itself
    left out), as the cost-volume init net takes them (reference
    train_dataset.py:44-64). Returns (the union's imgs_info, ref_cv_idx
    [rfn, nn] the source views' indices into the union, ref_real_idx
    [rfn] the ref views')."""
    order = compute_nearest_camera_indices(database, ref_ids, ref_ids_all)
    src_ids = np.asarray(ref_ids_all)[order[:, 1:1 + cost_volume_nn_num]]
    sel_ids = np.asarray(ref_ids)
    union_ids = np.unique(np.concatenate([src_ids.ravel(), sel_ids]))
    # np.unique sorts, so a view's place in the union is a searchsorted hit
    ref_real_idx = np.searchsorted(union_ids, sel_ids)
    ref_cv_idx = np.searchsorted(union_ids, src_ids)
    is_aligned = not database.database_name.startswith("space")
    union_info = build_imgs_info(database, list(union_ids), pad_interval,
                                 is_aligned, replace_none_depth=True)
    return union_info, ref_cv_idx, ref_real_idx


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
