"""COLMAP's dense map format (port of ``read_array`` in
``neuray_tpu/data/colmap_io.py``; the sparse-model readers wait for the
databases that need them): an ascii ``w&h&c&`` header, then the f32
values with the width fastest, then the height, then the channels (column
major). ``NeRFSyntheticDatabase.get_depth`` reads its depth maps so."""
from __future__ import annotations

import numpy as np


def read_array(path: str) -> np.ndarray:
    """A dense map file -> f32 [h, w, c], squeezed ([h, w] for c = 1)."""
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
    return np.squeeze(np.ascontiguousarray(arr))


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
