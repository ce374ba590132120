"""The reference GT-PSNRs of ``chip_smoke.py``'s analytic-scene frames
(phase 19), from the JAX package.

Phase 19 renders the blobs (``tools/bench_weights_blobs.npz``) and the
room (``tools/bench_weights_room_strong.npz``) exactly in f32 at 800x800
from 8 reference views (``chip_smoke.scene_frame``) and holds each card
frame to the JAX package's GT-PSNR on the same rays: every
``SCENE_PSNR_STRIDE``-th pixel of every ``SCENE_PSNR_STRIDE``-th row
(``chip_smoke.scene_psnr_rays``), within ``SCENE_PSNR_TOL`` dB of
``chip_smoke.SCENE_JAX_GT_PSNR``. Those figures come from running this
file as a script on the CPU:

    JAX_PLATFORMS=cpu python tests/test_torch_port_scene_quality.py

which renders those rays with the JAX package at full size (f32,
"highest" matmul precision) and prints their GT-PSNR, fine and coarse.
Under pytest the file checks the ray subset and that the frames are the
JAX package's scenes (at a small size).
"""
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def test_scene_psnr_rays_are_the_strided_grid():
    s, n = chip_smoke.SCENE_PSNR_STRIDE, chip_smoke.H
    idx = chip_smoke.scene_psnr_rays()
    xs, ys = idx % n, idx // n
    assert idx.size == (-(-n // s)) ** 2
    assert (xs % s == 0).all() and (ys % s == 0).all()
    assert np.unique(idx).size == idx.size and idx.max() < n * n


def test_scene_frames_are_the_jax_packages():
    from neuray_tpu.data import synthetic as J
    for name, spheres, dr in (
            ("blobs", J.make_blob_spheres(np.random.RandomState(42)),
             J.DEPTH_RANGE),
            ("room", J.make_room_spheres(np.random.RandomState(42)),
             J.ROOM_DEPTH_RANGE)):
        ref, que, gt = chip_smoke.scene_frame(name, 24)
        rng = np.random.RandomState(0)
        jref = J.make_sphere_scene(rng, chip_smoke.RFN, 24, 24, spheres, dr)
        jque = J.make_query(rng, 24, 24, 0, True, spheres, dr)
        for k in jref:
            assert jref[k].tobytes() == ref[k].tobytes(), k
        assert jque.pop("imgs")[0].tobytes() == gt.tobytes()
        for k in jque:
            assert jque[k].tobytes() == que[k].tobytes(), k


def main():
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    from neuray_tpu.models import renderer as jR
    from neuray_tpu.utils.params_io import load_params_npz

    idx = chip_smoke.scene_psnr_rays()
    renderer = jR.NeurayRenderer(jR.RenderConfig(**chip_smoke.EXACT_PROFILE))
    for name in sys.argv[1:] or ("blobs", "room"):
        t0 = time.perf_counter()
        ref, que, gt = chip_smoke.scene_frame(name)
        que = dict(que, coords=que["coords"][:, idx])
        params = load_params_npz(str(
            ROOT / "tools" / chip_smoke.SCENE_WEIGHTS[name]))
        with jax.default_matmul_precision("highest"):
            ref_c = jR.make_scene_encode_fn(renderer)(
                params, {k: jnp.asarray(v) for k, v in ref.items()})
            out = jR.make_ray_render_fn(
                renderer, ("pixel_colors_nr", "pixel_colors_nr_fine"))(
                    params, ref_c, {k: jnp.asarray(v) for k, v in
                                    que.items()})
        want = gt.reshape(-1, 3)[idx]
        for k in ("pixel_colors_nr_fine", "pixel_colors_nr"):
            print(f"{name}: JAX GT-PSNR {k} on {idx.size} rays: "
                  f"{chip_smoke.psnr(np.asarray(out[k])[0], want):.4f} dB",
                  flush=True)
        print(f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
