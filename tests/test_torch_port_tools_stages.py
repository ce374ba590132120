"""The port's per-stage profiler (``python -m
neuray_tpu_torch.profile_stages --device cpu``) against the JAX stage
functions of ``tools/profile_stages.py`` on the same arrays: the tool's
own inputs (``make_inputs``, the JAX tool's draws from
``RandomState(0)`` at the CPU shapes: K = 2 chunks of 64 rays, 16
samples, 4 views, a 64x64 frame) and the JAX tool's initial parameters
of the dist decoder and the aggregation net (``init`` under
``PRNGKey(0)`` and ``PRNGKey(1)``) handed to the port's ``run``, JAX at
"highest" matmul precision (hazard a). Each stage's first chunk:

- f32 stages (projection, sampling, compositing) within 1e-4; the
  projection's coordinates within 1e-4 of their magnitude besides (the
  random poses put points near a camera plane, where a coordinate is a
  quotient of a small depth that cancels: measured 5.2e-5 relative,
  0.77 absolute on a coordinate of ~1.5e4);
- the gather on the f32 maps against the JAX package's unpacked
  ``ops/interpolate.py: interpolate_feature_map`` at 1e-4; on the bf16
  maps by the lossy-mode rule of ``tests/test_torch_port_bf16.py``
  (``held``: JAX's bf16 gather rounded to bf16, JAX's f32 gather of the
  same map as the reference); on the u8 maps the dequantized JAX gather
  of the codes within one bf16 ulp (``tests/test_torch_port_gather.py``);
- the bf16 dist decoder + ``compute_prob`` and the bf16 aggregation net
  by ``held`` against the JAX modules in bf16 and in f32 on the same
  parameters and bf16 inputs.

Also the record's keys, and every stage's per-chunk times present.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuray_tpu.models.agg_net import name2agg_net
from neuray_tpu.models.dist_decoder import name2dist_decoder
from neuray_tpu.ops import geometry as jG
from neuray_tpu.ops import mixture as jM
from neuray_tpu.ops import sampling as jS
from neuray_tpu.ops.compositing import alpha_values2hit_prob
from neuray_tpu.ops.interpolate import interpolate_feature_map

from neuray_tpu_torch import profile_stages as PT
from tests.test_torch_port_bf16 import held

torch.set_num_threads(1)

CPU = torch.device("cpu")
JBF = jnp.bfloat16
TOL = 1e-4


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def prj_dict(x, feats):
    d = {k: jnp.asarray(x[k]) for k in ("hit_prob", "vis", "rgb", "dir",
                                        "mask")}
    d["ray_feats"] = d["img_feats"] = feats
    return d


@pytest.fixture(scope="module")
def stages():
    """(the tool's inputs, its record, each stage's first chunk's output,
    the JAX modules and their parameters)."""
    flags = PT.parse_args(["--device", "cpu"])
    flags.iters = 1
    sh = PT.shapes(flags, CPU)
    x = PT.make_inputs(sh, lambda tag: True)
    feats = jnp.asarray(x["feats_in"], JBF)
    with jax.default_matmul_precision("highest"):
        dd = name2dist_decoder["mixture_logistics"]({"use_vis": False},
                                                    dtype=JBF)
        dd_params = dd.init(jax.random.PRNGKey(0), feats[0])
        agg = name2agg_net["default"]({"neuray_dim": 32,
                                       "sample_num": sh.dn}, dtype=JBF)
        agg_params = agg.init(jax.random.PRNGKey(1), prj_dict(x, feats[0]),
                              jnp.asarray(x["que_dir"]))
    params = jax.tree.map(np.asarray, {"params": {
        "dist_decoder": dd_params["params"],
        "agg_net": agg_params["params"]}})
    rec, extras = PT.run(flags, CPU, params, log=lambda *a, **k: None)
    assert extras["inputs"].keys() == x.keys()
    for k in x:
        np.testing.assert_array_equal(extras["inputs"][k], x[k])
    return x, sh, rec, extras["outputs"], (dd, dd_params, agg, agg_params)


def close(ours, theirs, what, rtol=0.0):
    ours = as_f64(ours)
    theirs = np.asarray(theirs, np.float64)
    d = np.abs(ours - theirs)
    bound = TOL + rtol * np.abs(theirs)
    print(f"{what}: max {d.max():.3g}, max relative "
          f"{(d / np.maximum(np.abs(theirs), 1e-30)).max():.3g}")
    assert ours.shape == theirs.shape, what
    assert (d <= bound).all(), what


def as_f64(x):
    return x.detach().float().numpy().astype(np.float64)


def test_record_keys(stages):
    _, sh, rec, outputs, _ = stages
    names = [PT.STAGES[t][0] for t in PT.STAGES]
    assert list(outputs) == list(PT.STAGES)
    assert list(rec) == [k for n in names
                         for k in (n, f"{n} ms/chunk", f"{n} host ms/chunk")
                         ] + ["device", "k"]
    assert rec["k"] == sh.k == 2 and rec["device"] == "cpu"
    assert all(rec[f"{n} ms/chunk"] > 0 for n in names)


def test_projection_equals_jax(stages):
    x, sh, _, outputs, _ = stages
    want = jG.project_points_ref_views(
        jnp.asarray(x["poses"]), jnp.asarray(x["Ks"]), sh.size, sh.size,
        jnp.asarray(x["pts"][0]).reshape(-1, 3))
    for name, ours, theirs in zip(("dir", "pts", "depth", "mask"),
                                  outputs["proj"], want):
        close(ours, theirs, f"projection {name}", rtol=1e-4)


def jax_gather(m, x, sh):
    pp = jnp.asarray(x["prj_pts"][0])
    ones = jnp.ones(pp.shape[:2], jnp.float32)
    return np.asarray(interpolate_feature_map(m, pp, ones, sh.size,
                                              sh.size), np.float32)


def test_gather_f32_equals_jax(stages):
    x, sh, _, outputs, _ = stages
    for name, ours, m in zip(("rgb", "feats"), outputs["gather"],
                             (x["imgs"], x["feats_map"])):
        close(ours, jax_gather(jnp.asarray(m), x, sh), f"gather {name}")


def test_gather_bf16_held_to_jax(stages):
    x, sh, _, outputs, _ = stages
    for name, ours, m in zip(("rgb", "feats"), outputs["fused"],
                             (x["imgs"], x["feats_map"])):
        assert ours.dtype == torch.bfloat16
        mb = jnp.asarray(m, JBF)
        bf16 = np.asarray(jnp.asarray(jax_gather(mb, x, sh), JBF),
                          np.float32)
        held(f"gather bf16 {name}", ours, bf16,
             jax_gather(mb.astype(jnp.float32), x, sh))


def test_gather_u8_equals_jax_dequantized(stages):
    """The port's u8 codes (``build_gather_cache``, held bit-equal to the
    JAX package's quantization in ``tests/test_torch_port_bf16.py``)
    gathered by JAX and dequantized, within one bf16 ulp."""
    from neuray_tpu_torch.models.renderer import NeurayRenderer
    x, sh, _, outputs, _ = stages
    f8 = torch.from_numpy(x["feats_map8"])
    c = NeurayRenderer.build_gather_cache(
        {"imgs": torch.from_numpy(x["imgs8"]), "ray_feats": f8[..., :32],
         "img_feats": f8[..., 32:]}, True, "u8")
    for name, ours, key in zip(("rgb", "feats"), outputs["fused_u8"],
                               ("rgb", "feats")):
        codes = c["rgb_map" if key == "rgb" else "feats"].numpy()
        lerp = jax_gather(jnp.asarray(codes.astype(np.float32)), x, sh)
        want = lerp * c[f"{key}_scale"].numpy() - c[f"{key}_offset"].numpy()
        assert ours.dtype == torch.bfloat16
        np.testing.assert_allclose(ours.float().numpy(), want,
                                   rtol=2.0 ** -8, atol=1e-6,
                                   err_msg=f"gather u8 {name}")


def test_dist_held_to_jax(stages):
    x, _, _, outputs, (dd, dd_params, _, _) = stages
    feats = jnp.asarray(x["feats_in"][0], JBF)

    def jax_dist(module, f):
        mean, var, vis, aw = module.apply(dd_params, f)
        alpha, _, hit_prob = jM.compute_prob(
            jnp.asarray(x["prj_depth"][0]), jnp.asarray(x["que_dists"])[None],
            mean, var, vis, aw, True, jnp.asarray(x["depth_range"]), False)
        return alpha, hit_prob

    jb = jax_dist(dd, feats)
    jf = jax_dist(dd.clone(dtype=None), feats.astype(jnp.float32))
    for name, ours, b, f in zip(("alpha", "hit_prob"), outputs["dist"], jb,
                                jf):
        held(f"dist {name}", ours, b, f)


def test_agg_held_to_jax(stages):
    x, _, _, outputs, (_, _, agg, agg_params) = stages
    feats = jnp.asarray(x["feats_in"][0], JBF)
    que_dir = jnp.asarray(x["que_dir"])
    jb = agg.apply(agg_params, prj_dict(x, feats), que_dir)
    f32 = feats.astype(jnp.float32)
    jf = agg.clone(dtype=None).apply(agg_params, prj_dict(x, f32), que_dir)
    for name, ours, b, f in zip(("density", "colors"), outputs["agg"], jb,
                                jf):
        held(f"agg {name}", ours, b, f)


def test_sampling_equals_jax(stages):
    x, sh, _, outputs, _ = stages
    que_range = jnp.asarray(x["que_range"])
    que_depth, _ = jS.sample_depth(que_range, 1, sh.chunk, sh.dn, False)
    want = jS.sample_fine_depth(que_depth, jnp.asarray(x["hit_prob_k"][0]),
                                que_range, sh.dn, False, None)
    close(outputs["sampling"], want, "sampling")


def test_compositing_equals_jax(stages):
    x, _, _, outputs, _ = stages
    close(outputs["comp"], alpha_values2hit_prob(jnp.asarray(x["alpha"][0])),
          "compositing")
