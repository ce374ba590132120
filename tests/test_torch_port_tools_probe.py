"""The port's probe-score diagnosis and encode profiler against the JAX
tools' own sequences of calls on the CPU: ``python -m
neuray_tpu_torch.diag_probe_score --device cpu`` against
``tools/diag_probe_score.py`` and ``python -m
neuray_tpu_torch.profile_encode --device cpu`` against
``tools/profile_encode.py``, each at the JAX tool's CPU shapes, with the
JAX renderer's initial parameters (``renderer.init`` as the JAX tool
draws them) handed to the port's ``run`` and JAX at "highest" matmul
precision (hazard a).

diag_probe_score: the probe scores and the summed coarse hit mass within
1e-4, the keep decision equal but for rays whose hit mass lies within
1e-5 of the threshold (named where any exist), and the record's
quantiles, recall thresholds, keep fractions and ``pearson_r`` within
1e-4 of the JSON record the JAX tool's own ``main`` prints (``--cpu``,
its ``--weights`` a file of the parameters the port is handed, written
in f32 by ``save_params_npz``: the tool's own ``renderer.init`` draws the
same ones under the same keys, but eagerly, op by op, in ~50 s).

profile_encode: each stage's output against the JAX method of the same
name (``initialize_ray_feats``, ``encode_scene``, ``build_gather_cache``,
``make_scene_encode_fn``) at 1e-4: the encoders' InstanceNorms
normalise maps of 2x2 at these shapes and amplify f32 rounding
(``tests/test_torch_port_quality_tools.py`` holds its 32 px frames at
5e-4), but at 64 px the largest difference measured was 7.2e-5 (the
vis encoder's ray_feats). The record's keys are the JAX tool's.
"""
import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuray_tpu.data.synthetic import make_query, make_sphere_scene
from neuray_tpu.models import renderer as jR
from neuray_tpu.utils.params_io import save_params_npz

from neuray_tpu_torch import diag_probe_score as DP
from neuray_tpu_torch import profile_encode as PE

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL = 1e-4
BORDER = 1e-5


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def host(tree):
    return jax.tree.map(np.asarray, tree)


def close(ours, theirs, tol, what):
    ours = np.asarray(ours.float() if torch.is_tensor(ours) else ours,
                      np.float64)
    d = np.abs(ours - np.asarray(theirs, np.float64))
    print(f"{what}: max {d.max():.3g}")
    assert ours.shape == np.shape(theirs), what
    assert d.max() <= tol, what


# ---------------- diag_probe_score ----------------

def jax_tool_record(tmp, params):
    """The record ``tools/diag_probe_score.py``'s ``main`` prints with
    ``--cpu`` and ``params`` as its weights file, at "highest"
    precision. The tool sets the persistent cache's threshold; the
    test session's is put back."""
    spec = importlib.util.spec_from_file_location(
        "jax_diag_probe_score", ROOT / "tools" / "diag_probe_score.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    key = "jax_persistent_cache_min_compile_time_secs"
    kept = getattr(jax.config, key)
    weights = str(tmp / "init.npz")
    save_params_npz(weights, params, np.float32)
    argv = ["diag_probe_score.py", "--cpu", "--weights", weights]
    out = io.StringIO()
    try:
        with mock.patch.object(sys, "argv", argv), \
                contextlib.redirect_stdout(out), \
                jax.default_matmul_precision("highest"):
            tool.main()
    finally:
        jax.config.update(key, kept)
    return json.loads(out.getvalue())


@pytest.fixture(scope="module")
def diag(tmp_path_factory):
    """``tools/diag_probe_score.py``'s calls at its CPU shapes (64 px,
    16 + 16 samples, 64-ray chunks, probe 16, f32), its own printed
    record, and the port tool's run on JAX's parameters."""
    flags = DP.parse_args(["--device", "cpu"])
    with jax.default_matmul_precision("highest"):
        cfg = jR.RenderConfig(
            use_hierarchical_sampling=True, depth_sample_num=16,
            fine_depth_sample_num=16, ray_batch_num=64,
            probe_sample_num=flags.probe_samples, use_vis=False,
            fine_use_vis=False, use_bf16=False, gather_quant="none")
        renderer = jR.NeurayRenderer(cfg)
        rng = np.random.RandomState(0)
        ref = {k: jnp.asarray(v)
               for k, v in make_sphere_scene(rng, 8, 64, 64).items()}
        que_np = make_query(rng, 64, 64, rn=0, full_image=True)
        que = {k: jnp.asarray(v) for k, v in que_np.items() if k != "imgs"}
        params = jax.jit(lambda r, q: renderer.init(
            {"params": jax.random.PRNGKey(0),
             "sample": jax.random.PRNGKey(1)}, r, q, False))(
                ref, dict(que, coords=que["coords"][:, :64]))
        ref_c = jR.make_scene_encode_fn(renderer)(params, ref)
        probe = np.asarray(jR.make_probe_fn(renderer)(params, ref_c, que))[0]
        coarse = jR.make_coarse_render_fn(renderer,
                                          keep_keys=("hit_prob_nr",))
        net = np.asarray(jnp.sum(coarse(params, ref_c, que)["hit_prob_nr"],
                                 -1))[0]
    want = jax_tool_record(tmp_path_factory.mktemp("diag"), params)
    rec, extras = DP.run(flags, CPU, host(params))
    return flags, rec, extras, probe, net, want


def test_diag_scores_equal_jax(diag):
    _, _, extras, probe, net, _ = diag
    close(extras["probe"], probe, TOL, "probe score")
    close(extras["net"], net, TOL, "coarse hit mass")


def test_diag_keep_decisions_equal_jax(diag):
    flags, _, extras, _, net, _ = diag
    th = flags.net_threshold
    differ = np.nonzero((extras["net"] > th) != (net > th))[0]
    border = np.abs(net - th) < BORDER
    print("rays within 1e-5 of the threshold:", np.nonzero(border)[0])
    assert not differ.size or border[differ].all(), {
        int(i): float(net[i]) for i in differ}


def test_diag_record_equals_jax(diag):
    """The port tool's record against the one the JAX tool prints."""
    _, rec, _, _, _, want = diag
    assert list(rec) == list(want) == [
        "net_kept_fraction", "probe_score_kept_quantiles",
        "probe_score_skipped_quantiles", "pearson_r", "recall_1.0",
        "recall_0.9999", "recall_0.999", "recall_0.99"]
    assert rec["net_kept_fraction"] == want["net_kept_fraction"]
    for key in ("probe_score_kept_quantiles",
                "probe_score_skipped_quantiles"):
        assert list(rec[key]) == list(want[key])
        close(list(rec[key].values()), list(want[key].values()), TOL, key)
    close(rec["pearson_r"], want["pearson_r"], TOL, "pearson_r")
    for recall in DP.RECALLS:
        ours, theirs = rec[f"recall_{recall}"], want[f"recall_{recall}"]
        close(ours["probe_threshold"], theirs["probe_threshold"], TOL,
              f"recall {recall} threshold")
        close(ours["overall_keep_fraction"],
              theirs["overall_keep_fraction"], TOL, f"recall {recall} keep")


# ---------------- profile_encode ----------------

@pytest.fixture(scope="module")
def encode():
    """``tools/profile_encode.py``'s stages at its CPU shapes (8 views at
    64 px, 8 + 8 samples, f32) on its init's parameters, and the port
    tool's run on them (one timed call)."""
    flags = PE.parse_args(["--device", "cpu", "--iters", "1"])
    with jax.default_matmul_precision("highest"):
        cfg = jR.RenderConfig(
            use_hierarchical_sampling=True, depth_sample_num=8,
            fine_depth_sample_num=8, use_vis=False, fine_use_vis=False,
            use_bf16=False, gather_quant="none")
        renderer = jR.NeurayRenderer(cfg)
        rng = np.random.RandomState(0)
        ref = {k: jnp.asarray(v) for k, v in
               make_sphere_scene(rng, flags.rfn, 64, 64).items()}
        que = {"coords": jnp.zeros((1, 64, 2), jnp.float32),
               "poses": ref["poses"][:1], "Ks": ref["Ks"][:1],
               "depth_range": ref["depth_range"][:1]}
        params = jax.jit(lambda r, q: renderer.init(
            {"params": jax.random.PRNGKey(0),
             "sample": jax.random.PRNGKey(1)}, r, q, False))(ref, que)
        raw = jax.jit(lambda p, r: renderer.apply(
            p, r, None, method=jR.NeurayRenderer.initialize_ray_feats))(
                params, ref)
        img_feats, ray_feats = jax.jit(lambda p, r, rf: renderer.apply(
            p, r, rf, method=jR.NeurayRenderer.encode_scene))(
                params, ref, raw)
        cache = jax.jit(renderer.build_gather_cache)(
            dict(ref, img_feats=img_feats, ray_feats=ray_feats))
        fused = jR.make_scene_encode_fn(renderer)(params, ref)
    want = {"init_net": raw, "image+vis_encoder": (img_feats, ray_feats),
            "gather_cache": cache, "fused_encode": fused}
    rec, outputs = PE.run(flags, CPU, host(params))
    return rec, outputs, host(want)


def test_encode_init_net_equals_jax(encode):
    _, outputs, want = encode
    close(outputs["init_net"], want["init_net"], TOL, "init_net")


def test_encode_encoders_equal_jax(encode):
    _, outputs, want = encode
    for name, ours, theirs in zip(("img_feats", "ray_feats"),
                                  outputs["image+vis_encoder"],
                                  want["image+vis_encoder"]):
        close(ours, theirs, TOL, name)


@pytest.mark.parametrize("stage", ["gather_cache", "fused_encode"])
def test_encode_maps_equal_jax(encode, stage):
    """The port's unpacked gather map holds [ray_feats | img_feats] (the
    JAX package's ``feats``) and the image itself as ``rgb_map``."""
    _, outputs, want = encode
    ours, theirs = outputs[stage], want[stage]
    for key in ("ray_feats", "img_feats"):
        close(ours[key], theirs[key], TOL, f"{stage} {key}")
    close(ours["feats"], np.concatenate(
        [theirs["ray_feats"], theirs["img_feats"]], -1), TOL,
        f"{stage} feats")
    close(ours["rgb_map"], theirs["imgs"], 0.0, f"{stage} rgb_map")


def test_encode_record_keys(encode):
    rec, _, _ = encode
    stages = ("init_net", "image+vis_encoder", "gather_cache",
              "fused_encode")
    assert list(rec) == ["shape", "platform", "device",
                         *(f"{s}_s" for s in stages), "sum_of_stages_s"]
    assert rec["shape"] == "8x64x64" and rec["platform"] == "cpu"
    assert all(rec[f"{s}_s"] >= 0 for s in stages)
