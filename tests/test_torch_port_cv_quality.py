"""The reference GT-PSNR of ``chip_smoke.py``'s cost-volume frame (phase
10), from the JAX package.

``tools/bench_weights_cv.npz`` was trained at 384 px, and at phase 10's
1024x768 reference views its fine image falls short of the 24 dB floor
of the other phases. So phase 10 holds the port's card frame to the JAX
package's GT-PSNR on the same rays: every ``CV_PSNR_STRIDE``-th pixel of
every ``CV_PSNR_STRIDE``-th row of the 1008x756 query
(``chip_smoke.cv_psnr_rays``), within ``CV_PSNR_TOL`` dB of
``chip_smoke.CV_JAX_GT_PSNR``. That figure comes from running this file
as a script on the CPU:

    JAX_PLATFORMS=cpu python tests/test_torch_port_cv_quality.py

which renders those rays with the JAX package at full size (f32,
"highest" matmul precision; the init net one reference view at a time
to bound its memory) and prints their GT-PSNR, fine and coarse. Under
pytest the file only checks the ray subset.
"""
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def test_cv_psnr_rays_are_the_strided_grid():
    s = chip_smoke.CV_PSNR_STRIDE
    idx = chip_smoke.cv_psnr_rays()
    xs, ys = idx % chip_smoke.CV_QW, idx // chip_smoke.CV_QW
    assert idx.size == (-(-chip_smoke.CV_QH // s)) * (-(-chip_smoke.CV_QW
                                                        // s))
    assert (xs % s == 0).all() and (ys % s == 0).all()
    assert np.unique(idx).size == idx.size and idx.max() < (
        chip_smoke.CV_QH * chip_smoke.CV_QW)


def main():
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    from neuray_tpu.models import renderer as jR
    from neuray_tpu.utils.params_io import load_params_npz

    t0 = time.perf_counter()
    ref, src, que, gt = chip_smoke.cv_scene()
    idx = chip_smoke.cv_psnr_rays()
    que = dict(que, coords=que["coords"][:, idx])
    params = load_params_npz(str(ROOT / "tools" / "bench_weights_cv.npz"))
    renderer = jR.NeurayRenderer(jR.RenderConfig(**chip_smoke.CV_PROFILE))
    src = {k: jnp.asarray(v) for k, v in src.items()}
    with jax.default_matmul_precision("highest"):
        init = jax.jit(lambda p, r, s: renderer.apply(
            p, r, s, method=jR.NeurayRenderer.initialize_ray_feats))
        raw = [init(params, {k: jnp.asarray(v[i:i + 1])
                             for k, v in ref.items()}, src)
               for i in range(chip_smoke.RFN)]
        ref = {k: jnp.asarray(v) for k, v in ref.items() if k != "nn_ids"}
        img_feats, ray_feats = jax.jit(lambda p, r, x: renderer.apply(
            p, r, x, method=jR.NeurayRenderer.encode_scene))(
                params, ref, jnp.concatenate(raw))
        ref_c = renderer.build_gather_cache(
            dict(ref, img_feats=img_feats, ray_feats=ray_feats))
        out = jR.make_ray_render_fn(
            renderer, ("pixel_colors_nr", "pixel_colors_nr_fine"))(
                params, ref_c, {k: jnp.asarray(v) for k, v in que.items()})
    want = gt.reshape(-1, 3)[idx]
    for k in ("pixel_colors_nr_fine", "pixel_colors_nr"):
        print(f"JAX GT-PSNR {k} on {idx.size} rays: "
              f"{chip_smoke.psnr(np.asarray(out[k])[0], want):.4f} dB",
              flush=True)
    print(f"({time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()
