"""The port's quality tools against the JAX package's drivers on the CPU:
``python -m neuray_tpu_torch.check_skip_quality --device cpu`` (its full,
skip, ``--auto``, ``--focus`` and ``--probe`` rows) on the blobs and the
room, and ``python -m neuray_tpu_torch.check_bf16_quality --device cpu``.

The JAX side is each JAX tool's own sequence of calls
(``tools/check_skip_quality.py``, ``tools/check_bf16_quality.py``) on the
same scene and weights, with the JAX tools' CPU shapes (16 + 16 samples,
64-ray chunks, f32; frames from 8 reference views, here 32 px), one
setting of each sweep, and JAX at "highest" matmul precision (hazard a).

The skip tool's full frame from its own encode is held to JAX's at 5e-4
(at 32 px the encoders' InstanceNorms normalize 2x2 maps, 3e-4 on 3
views in ``tests/test_torch_port_render.py``; on these 8 views 2 of 3072
values reached 4.1e-4). Its sweep then runs on the maps JAX
encoded (``R.encode_ref`` handed them), as ``tests/test_torch_port_
drivers.py`` holds the drivers: independent encodes part the probe's hit
fractions by ~1e-5, and a ray whose cumulative fraction lies that close
to the focus quantile takes the next sample as its window's end (10% of
the blobs' frame's colours differed so). Held, per row: the keep set (so
the kept fraction), the accepted probe size, the fallback and the
false-skip rates equal (where a ray's keep decision differs, the failure
names the ray and the distance of the nearest gating score in its 3x3
neighbourhood from the threshold, the dilation's reach); colours by
``colours_close`` (focused frames: off the rays of
``window_borderline``); PSNRs against the ground truth and against the
full frame within ``PSNR_TOL`` = 0.01 dB. The bf16 tool's f32 frame is
held to JAX's by ``colours_close`` and its bf16 and u8 frames by the
lossy-mode rule of ``tests/test_torch_port_bf16.py`` (``held``). Both
tools render the trained ``tools/bench_weights.npz`` here (handed to the
port's ``run`` as ``params``), as ``test_torch_port_bf16.py`` holds its
routes: the tools' own random weights put a tail of rays where a bf16
rounding moves the fine depths and the colour by up to ~0.5 in either
package (fault 3; measured 23 of 4096 rays moved beyond 0.1 by JAX's own
bf16 and u8 routes), which the rule's maximum would measure instead of
the route. The tool's own initialization is run on its own
(``test_bf16_tool_default_weights``).

``colours_close``: 1e-4, but for at most ``FINE_SHARE`` = 0.1% of the
values, which may lie up to ``FINE_BOUND`` = 5e-3 apart: a fine pass
resamples its depths from the coarse hit mass, and on rays where that
mass is small a rounding difference moves them (ROADMAP Queue 3, fault
3). Measured: 2 of 3072 values at 2.0e-4 (the room's focused frame), 3
of 12288 at 2.1e-3 (the bf16 tool's f32 frame of random weights).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuray_tpu.data import synthetic as jsyn
from neuray_tpu.models import renderer as jR
from neuray_tpu.train.metrics import compute_psnr as j_psnr_u8
from neuray_tpu.utils.params_io import load_params_npz as j_load_npz

from neuray_tpu_torch import check_bf16_quality as BQ
from neuray_tpu_torch import check_skip_quality as SQ
from neuray_tpu_torch.models import renderer as R
from neuray_tpu_torch.train.metrics import unit_psnr as psnr
from tests.test_torch_port_bf16 import held

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SIZE, DN, CHUNK = 32, 16, 64
PSNR_TOL = 0.01
# one setting of each sweep: the JAX tool's first probe size, focus pair,
# margin and stride; the fast profile's threshold; dilate 1
FLAGS = ["--device", "cpu", "--size", str(SIZE), "--auto", "--focus",
         "--probe",
         "--thresholds", "0.01", "--probe-samples", "8",
         "--probe-thresholds", "0.005", "--probe-dilates", "1",
         "--focus-samples", "16:32"]


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def jax_rows(scene, weights):
    """``tools/check_skip_quality.py``'s calls at the port's flags: the
    frame dicts of its full render and of each mode, keyed like the port
    tool's rows."""
    spheres = {"blobs": jsyn.make_blob_spheres(np.random.RandomState(42)),
               "room": jsyn.make_room_spheres(np.random.RandomState(42))
               }[scene]
    dr = jsyn.ROOM_DEPTH_RANGE if scene == "room" else jsyn.DEPTH_RANGE
    rng = np.random.RandomState(0)
    ref = {k: jnp.asarray(v) for k, v in jsyn.make_sphere_scene(
        rng, 8, SIZE, SIZE, spheres, dr).items()}
    que_np = jsyn.make_query(rng, SIZE, SIZE, rn=0, full_image=True,
                             spheres=spheres, depth_range=dr)
    gt = que_np.pop("imgs")[0].reshape(-1, 3)
    que = {k: jnp.asarray(v) for k, v in que_np.items()}
    params = j_load_npz(weights)
    maps = {}
    base = dict(use_hierarchical_sampling=True, depth_sample_num=DN,
                fine_depth_sample_num=DN, ray_batch_num=CHUNK,
                use_vis=False, fine_use_vis=False, use_bf16=False,
                gather_quant="none")

    def build(**over):
        r = jR.NeurayRenderer(jR.RenderConfig(**base, **over))
        c = jR.make_scene_encode_fn(r)(params, ref)
        maps.update({k: np.asarray(c[k]) for k in ("img_feats",
                                                    "ray_feats")})
        return r, c

    renderer, ref_c = build()
    full = np.asarray(jR.make_ray_render_fn(
        renderer, keep_keys=("pixel_colors_nr", "pixel_colors_nr_fine"))(
            params, ref_c, que)["pixel_colors_nr_fine"])[0]
    hw = (SIZE, SIZE)
    r, c = build(probe_sample_num=8, focus_sample_num=min(16, DN),
                 focus_fine_sample_num=min(32, DN))
    out = {"full": {"pixel_colors_nr_fine": full[None]},
           "auto_focus": jR.render_frame_probe_auto(
               r, params, c, que, threshold=0.005, image_hw=hw, dilate=1,
               focus=True, tol=0.02, win_tol_db=0.05, probe_stride=1),
           "skip": jR.render_frame_skip_empty(renderer, params, ref_c, que,
                                              threshold=0.01)}
    r, c = build(probe_sample_num=8, focus_sample_num=min(16, DN),
                 focus_fine_sample_num=min(32, DN), focus_margin=1)
    out["focus"] = jR.render_frame_probe_focus(
        r, params, c, que, threshold=0.005, image_hw=hw, dilate=1,
        probe_stride=1)
    r, c = build(probe_sample_num=8)
    out["probe"] = jR.render_frame_probe_skip(
        r, params, c, que, threshold=0.005, image_hw=hw, dilate=1)
    return out, full, gt, maps


FINE_SHARE, FINE_BOUND = 1e-3, 5e-3


def colours_close(ours, theirs, what):
    d = np.abs(np.asarray(ours, np.float64) - np.asarray(theirs, np.float64))
    print(f"{what}: {int((d > 1e-4).sum())} of {d.size} values beyond 1e-4, "
          f"max {d.max():.3g}")
    assert (d > 1e-4).mean() <= FINE_SHARE, what
    assert d.max() <= FINE_BOUND, what


def gate_scores(mode, renderer, ref_c, que, psn):
    """Each ray's gating score in the port (the coarse hit mass for skip,
    the probe's score otherwise) and the mode's threshold."""
    if mode == "skip":
        hp = R.render_coarse_rays(renderer, ref_c, que, ("hit_prob_nr",))
        return R._host(hp["hit_prob_nr"].sum(-1))[0], 0.01
    r = SQ.with_fields(renderer, probe_sample_num=psn)
    score = (R.probe_rays(r, ref_c, que) if mode == "probe"
             else R.focus_probe_rays(r, ref_c, que)[0])
    return R._host(score)[0], 0.005


def keep_differences(mode, ours, theirs, setup, psn):
    """The rays whose keep decision differs, each with the distance from
    the threshold of the gating score nearest to it in the ray's 3x3
    neighbourhood (the dilation's reach)."""
    diff = np.nonzero(ours["keep_mask"] != np.asarray(theirs["keep_mask"]))[0]
    if not diff.size:
        return {}
    renderer, ref_c, que = setup
    score, th = gate_scores(mode, renderer, ref_c, que, psn)
    grid = np.pad(np.abs(score - th).reshape(SIZE, SIZE), 1,
                  constant_values=np.inf)
    return {int(i): float(grid[i // SIZE:i // SIZE + 3,
                               i % SIZE:i % SIZE + 3].min()) for i in diff}


def window_borderline(renderer, ref_c, que, psn):
    """Rays whose cumulative probe hit fraction at ``psn`` samples comes
    within 1e-5 of the focus quantile q or 1 - q (``tests/
    test_torch_port_drivers.py: _window_borderline``), grown by the
    dilation's one ray."""
    r = SQ.with_fields(renderer, probe_sample_num=psn)
    hp = R._chunk_loop(lambda q: {"hp": r._probe_hit_prob(ref_c, q)[1]},
                       que, r.cfg.ray_batch_num)["hp"][0]
    frac = torch.cumsum(hp, -1) / (hp.sum(-1, keepdim=True) + 1e-12)
    q = r.cfg.focus_quantile
    near = (((frac - q).abs() < 1e-5)
            | ((frac - (1 - q)).abs() < 1e-5)).any(-1).numpy()
    return R._dilate_keep_mask(near, (SIZE, SIZE), 1)


@pytest.fixture(scope="module", params=["blobs", "room"])
def skip_quality(request):
    scene = request.param
    flags = SQ.parse_args(FLAGS + ["--scene", scene])
    jax_out = jax_rows(scene, flags.weights)
    maps = jax_out[3]
    own = SQ.frame_setup(scene, flags.size, flags.chunk, flags.weights, CPU)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(R, "encode_ref", lambda renderer, ref: renderer.
                   build_gather_cache({**ref, **{
                       k: torch.from_numpy(v.copy())
                       for k, v in maps.items()}}))
        rows = SQ.run(flags, CPU, log=lambda *a, **k: None)
        setup = SQ.frame_setup(scene, flags.size, flags.chunk,
                               flags.weights, CPU)[:3]
    return scene, rows, setup, jax_out, own


def test_rows_and_keys(skip_quality):
    _, rows, _, _, _ = skip_quality
    assert [r["mode"] for r, _ in rows] == ["full", "auto_focus", "skip",
                                            "focus", "probe"]
    keys = {"kept_fraction", "time_s", "rays_per_s", "psnr_vs_full",
            "psnr_vs_gt"}
    for row, _ in rows[1:]:
        assert keys <= row.keys()
    auto = rows[1][0]
    assert {"accepted_probe_samples", "false_skip_rate", "window_clip",
            "window_clip_db", "fallback", "audit_trail"} <= auto.keys()


def test_full_frame(skip_quality):
    """The tool's full frame on its own encode, and on JAX's maps."""
    _, rows, _, (jax_out, full, gt, _), own = skip_quality
    renderer, ref_c, que, own_gt, _ = own
    mine = R._host(R.render_rays(renderer, ref_c, que, SQ.FRAME_KEYS)[
        "pixel_colors_nr_fine"])[0]
    np.testing.assert_array_equal(own_gt, gt)
    np.testing.assert_allclose(mine, full, rtol=0, atol=5e-4)
    row, out = rows[0]
    ours = R._host(out["pixel_colors_nr_fine"])[0]
    np.testing.assert_allclose(ours, full, rtol=0, atol=1e-4)
    assert abs(row["psnr_vs_gt"] - psnr(full, gt)) <= PSNR_TOL


@pytest.mark.parametrize("mode", ["auto_focus", "skip", "focus", "probe"])
def test_mode_matches_jax(skip_quality, mode):
    scene, rows, setup, (jax_out, full, gt, _), _ = skip_quality
    (row, ours), = [(r, o) for r, o in rows if r["mode"] == mode]
    theirs = jax_out[mode]
    psn = theirs.get("probe_sample_num", 8)
    differ = keep_differences(mode, ours, theirs, setup, psn)
    assert not differ, (f"{scene} {mode}: keep decisions differ on rays "
                        f"(distance of the nearest score from the "
                        f"threshold): {differ}")
    assert ours["kept_rays"] == theirs["kept_rays"]
    if mode == "auto_focus":
        assert row["accepted_probe_samples"] == theirs["probe_sample_num"]
        assert row["fallback"] == theirs["fallback"]
        assert ours["false_skip_rate"] == theirs["false_skip_rate"]
        assert [a["probe_sample_num"] for a in ours["audit_trail"]] == [
            a["probe_sample_num"] for a in theirs["audit_trail"]]
    img = np.asarray(theirs["pixel_colors_nr_fine"])[0]
    same = np.ones(SIZE * SIZE, bool)
    if mode in ("focus", "auto_focus") and theirs.get("fallback") is None:
        same = ~window_borderline(*setup, psn)
        assert same.mean() > 0.9, same.mean()
    colours_close(ours["pixel_colors_nr_fine"][0][same], img[same],
                  f"{scene} {mode}")
    assert abs(row["psnr_vs_gt"] - psnr(img, gt)) <= PSNR_TOL
    assert abs(row["psnr_vs_full"] - psnr(img, full)) <= PSNR_TOL
    print(f"{scene} {mode}: kept {row['kept_fraction']}, GT-PSNR "
          f"{row['psnr_vs_gt']} (JAX {psnr(img, gt):.3f})")


# ---------------- check_bf16_quality ----------------

BF16_SIZE, BF16_RFN = 64, 4


@pytest.fixture(scope="module")
def bf16_quality():
    """The port tool's frames and record, and ``tools/check_bf16_quality
    .py``'s three frames (its calls at the same size, views, samples and
    chunks), on the trained weights."""
    ref_np, que_np, gt = BQ.scene(BF16_SIZE, BF16_RFN)
    ref = {k: jnp.asarray(v) for k, v in ref_np.items()}
    que = {k: jnp.asarray(v) for k, v in que_np.items()}
    frames = {}
    params = j_load_npz(str(ROOT / "tools" / "bench_weights.npz"))
    for tag, route in BQ.ROUTES:
        cfg = jR.RenderConfig(
            use_hierarchical_sampling=True, depth_sample_num=DN,
            fine_depth_sample_num=DN, ray_batch_num=CHUNK, use_vis=False,
            fine_use_vis=False, **route)
        renderer = jR.NeurayRenderer(cfg)
        ref_c = jR.make_scene_encode_fn(renderer)(params, ref)
        frames[tag] = np.asarray(jR.make_ray_render_fn(
            renderer, keep_keys=("pixel_colors_nr_fine",))(
                params, ref_c, que)["pixel_colors_nr_fine"], np.float32)
    results, ours = BQ.run(BF16_SIZE, BF16_RFN, 64, 1024, CPU, params,
                           log=lambda *a, **k: None)
    return results, ours, frames, gt


def test_bf16_tool_record(bf16_quality):
    results, _, _, _ = bf16_quality
    assert set(results) == {
        "rays_per_sec_f32", "psnr_vs_gt_f32", "rays_per_sec_bf16",
        "psnr_vs_gt_bf16", "rays_per_sec_u8", "psnr_vs_gt_u8",
        "psnr_bf16_vs_f32", "psnr_gt_delta_bf16", "psnr_u8_vs_f32",
        "psnr_gt_delta_u8", "size"}
    assert results["size"] == BF16_SIZE


def test_bf16_tool_frames(bf16_quality):
    results, ours, theirs, gt = bf16_quality
    colours_close(ours["f32"], theirs["f32"], "check_bf16_quality f32")
    for tag in ("bf16", "u8"):
        held(f"check_bf16_quality {tag}", ours[tag], theirs[tag],
             theirs["f32"])
    want = round(float(j_psnr_u8(theirs["f32"].reshape(-1, 3),
                                 gt.reshape(-1, 3))), 4)
    assert abs(results["psnr_vs_gt_f32"] - want) <= PSNR_TOL
    for tag in ("bf16", "u8"):
        jax_vs = float(j_psnr_u8(theirs[tag].reshape(-1, 3),
                                 theirs["f32"].reshape(-1, 3)))
        print(f"{tag}: PSNR against f32 port {results[f'psnr_{tag}_vs_f32']}"
              f", JAX {jax_vs:.2f}")


def test_bf16_tool_default_weights():
    """The tool's own weights (flax's initializers under seed 0) at 32 px:
    every route renders, finite."""
    results, frames = BQ.run(32, 3, 8, 64, CPU, log=lambda *a, **k: None)
    assert results["size"] == 32
    assert all(np.isfinite(f).all() and f.shape == (1, 1024, 3)
               for f in frames.values())
    assert np.isfinite([v for v in results.values()]).all()
