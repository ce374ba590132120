"""The port's skip-phase profiler against ``tools/profile_skip_phases.py``
on the CPU: ``python -m neuray_tpu_torch.profile_skip_phases --device
cpu`` (the two-phase exact gate) and ``--focus`` (the probe-focused
frame), each against the JAX tool's own sequence of calls at its CPU
shapes (64 px, 4 views, 16 + 16 samples, probe and focus at 8, 256-ray
chunks, f32) on the JAX renderer's initial parameters, with JAX at
"highest" matmul precision (hazard a). Each package encodes the scene
itself.

Held: the keep set equal to JAX's (the JAX tool's before its bucket
padding); the merged frame's colours, coarse and fine, by
``colours_close`` of ``tests/test_torch_port_quality_tools.py`` (1e-4
but for 0.1% of values within 5e-3: a fine pass resamples its depths
from the hit mass, ROADMAP Queue 3, fault 3); the record's keys, every
phase's seconds present and positive, and ``padded`` the kept count
rounded up to a chunk.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuray_tpu.data.synthetic import make_query, make_sphere_scene
from neuray_tpu.models import renderer as jR

from neuray_tpu_torch import profile_skip_phases as PS
from tests.test_torch_port_quality_tools import colours_close

torch.set_num_threads(1)

CPU = torch.device("cpu")
KEEP = ("pixel_colors_nr",)


def jax_frame(focus: bool, threshold: float):
    """The JAX tool's frame at its CPU shapes: (keep indices, the merged
    frame, the parameters). Two-phase: the coarse colours and, as
    ``render_frame_skip_empty`` merges them, the kept rays' fine colours
    over them (the JAX tool renders the fine pass and drops it)."""
    cfg = jR.RenderConfig(
        use_hierarchical_sampling=True, depth_sample_num=16,
        fine_depth_sample_num=16, ray_batch_num=256, probe_sample_num=8,
        focus_sample_num=8, focus_fine_sample_num=8, init_diff_scale=1,
        use_vis=False, fine_use_vis=False, use_bf16=False,
        gather_quant="none")
    renderer = jR.NeurayRenderer(cfg)
    rng = np.random.RandomState(0)
    ref = {k: jnp.asarray(v)
           for k, v in make_sphere_scene(rng, 4, 64, 64).items()}
    que_np = make_query(rng, 64, 64, rn=0, full_image=True)
    n_rays = que_np["coords"].shape[1]
    que = {k: jnp.asarray(v) for k, v in que_np.items() if k != "imgs"}
    params = jax.jit(lambda r, q: renderer.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        r, q, False))(ref, dict(que, coords=que["coords"][:, :256]))
    ref_c = jR.make_scene_encode_fn(renderer)(params, ref)
    if not focus:
        coarse = jR.make_coarse_render_fn(
            renderer, keep_keys=KEEP + ("hit_prob_nr",))(params, ref_c, que)
        score = np.asarray(jnp.sum(coarse["hit_prob_nr"], -1))
        keep = np.nonzero(score[0] > threshold)[0]
        idx = jnp.asarray(keep)
        fine = jR.make_fine_render_fn(
            renderer, keep_keys=tuple(k + "_fine" for k in KEEP))(
                params, ref_c, dict(que, coords=jnp.take(
                    que["coords"], idx, axis=1)),
                jnp.take(coarse["hit_prob_nr"], idx, axis=1))
        frame = {}
        for k in KEEP:
            frame[k] = np.asarray(coarse[k], np.float32)
            frame[k + "_fine"] = frame[k].copy()
            frame[k + "_fine"][0, keep] = np.asarray(fine[k + "_fine"])[0]
        return keep, frame, params
    probe_fn = jR.make_focus_probe_fn(renderer)
    rays_fn = jR.make_focus_render_fn(
        renderer, keep_keys=KEEP + tuple(k + "_fine" for k in KEEP))
    keep_mask, near, far = jR._strided_focus_probe(
        probe_fn, params, ref_c, que, threshold, (64, 64), 2)
    keep_mask = jR._dilate_keep_mask(keep_mask, (64, 64), 1)
    keep = np.nonzero(keep_mask)[0]
    que_k = dict(que, coords=jnp.take(que["coords"], jnp.asarray(keep),
                                      axis=1))
    out = rays_fn(params, ref_c, que_k, jnp.asarray(near[:, keep]),
                  jnp.asarray(far[:, keep]))
    return keep, jR._merge_kept_outputs(KEEP, out, keep, keep_mask, 1,
                                        n_rays), params


@pytest.fixture(scope="module", params=[False, True],
                ids=["two_phase", "focus"])
def skip(request):
    focus = request.param
    flags = PS.parse_args(["--device", "cpu", "--iters", "1"]
                          + ["--focus"] * focus)
    with jax.default_matmul_precision("highest"):
        keep, frame, params = jax_frame(focus, flags.threshold)
    rec, extras = PS.run(flags, CPU, jax.tree.map(np.asarray, params))
    return focus, rec, extras, keep, frame


def test_keep_set_equals_jax(skip):
    _, rec, extras, keep, _ = skip
    ours = np.nonzero(extras["frame"]["keep_mask"])[0]
    print(f"kept {ours.size} of 4096 (JAX {keep.size})")
    np.testing.assert_array_equal(ours, keep)
    assert rec["kept"] == keep.size


def test_frame_equals_jax(skip):
    _, _, extras, _, frame = skip
    for k in ("pixel_colors_nr", "pixel_colors_nr_fine"):
        colours_close(extras["frame"][k], frame[k], k)


def test_record_keys(skip):
    focus, rec, extras, _, _ = skip
    phases = PS.PHASES[focus]
    assert list(rec) == [*phases, "kept", "padded", "total", "rays_per_sec",
                         "pad_waste_fraction", "device"]
    assert all(rec[p] >= 0 for p in phases)
    assert all(extras["seconds"][p] > 0 for p in phases), extras["seconds"]
    chunk = extras["renderer"].cfg.ray_batch_num
    assert rec["padded"] == -(-rec["kept"] // chunk) * chunk
