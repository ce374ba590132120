"""The port's eval drivers against the JAX package's: the probe, focus,
skip and auto renders with their audits, the positions they feed the
ray attention, the half-grid diff of the depth init net
(``init_diff_scale=2``) and ``RenderConfig.from_cfg`` on the shipped
fast profile.

Scene: the synthetic sphere, 3 reference views at 32x32, a full-image
query (1024 rays), 8 coarse + 8 fine samples, a 4-sample probe, 6 + 6
focus samples, 64-ray chunks, the trained ``tools/bench_weights.npz``.
The port renders from the maps JAX encoded, so the comparison is of the
drivers. JAX runs at "highest" matmul precision. Colours are held to
1e-4, metric depths (~4) to 1e-3; skipped rays are exactly 0.
"""
import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from neuray_tpu.data.synthetic import make_query, make_sphere_scene
from neuray_tpu.models import agg_net as jA
from neuray_tpu.models import ibrnet as jI
from neuray_tpu.models import init_net as jN
from neuray_tpu.models import renderer as jR
from neuray_tpu.ops import sampling as jS
from neuray_tpu.utils.config import load_cfg

import chip_smoke
from neuray_tpu_torch.models import agg_net as A
from neuray_tpu_torch.models import ibrnet as I
from neuray_tpu_torch.models import init_net as N
from neuray_tpu_torch.models import renderer as R
from neuray_tpu_torch.ops import sampling as S
from neuray_tpu_torch.utils.params import load_flax_params, load_params_npz

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
H = W = 32
CFG = dict(use_hierarchical_sampling=True, depth_sample_num=8,
           fine_depth_sample_num=8, ray_batch_num=64, probe_sample_num=4,
           focus_sample_num=6, focus_fine_sample_num=6, use_vis=False,
           fine_use_vis=False, ray_mask_point_num=4, render_depth=True)
# the fast profile's threshold; no probe or exact score of this scene
# lies within 3e-4 of it, so both packages keep the same rays
TH = 0.01
KEEP_BASE = ("pixel_colors_nr", "render_depth")


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def tol(key):
    return 1e-3 if "render_depth" in key else 1e-4


def close(ours, theirs, atol=1e-4):
    if isinstance(ours, torch.Tensor):
        ours = ours.numpy()
    np.testing.assert_allclose(ours, np.asarray(theirs), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(7)
    ref = make_sphere_scene(rng, 3, H, W)
    que = make_query(rng, H, W, 0, full_image=True)
    del que["imgs"]
    return ref, que, load_params_npz(str(ROOT / "tools" / "bench_weights.npz"))


class Pair:
    """One config in both packages: the JAX renderer and its encoded
    scene, and the port's renderer on the maps JAX encoded."""

    def __init__(self, scene, jref_c=None, **over):
        ref, que, self.params = scene
        cfg = {**CFG, **over}
        self.jr = jR.NeurayRenderer(jR.RenderConfig(**cfg))
        self.jque = {k: jnp.asarray(v) for k, v in que.items()}
        if jref_c is None:
            with jax.default_matmul_precision("highest"):
                jref_c = jR.make_scene_encode_fn(self.jr)(
                    self.params, {k: jnp.asarray(v) for k, v in ref.items()})
        self.jref_c = jref_c
        self.r = R.NeurayRenderer(R.RenderConfig(**cfg))
        load_flax_params(self.r, self.params)
        self.r.eval()
        self.ref_c = R.NeurayRenderer.build_gather_cache(
            {**{k: torch.from_numpy(v) for k, v in ref.items()},
             **{k: t(self.jref_c[k]) for k in ("img_feats", "ray_feats")}})
        self.que = {k: torch.from_numpy(v) for k, v in que.items()}

    def jax(self, fn, *args, **kw):
        """A JAX frame function: fn(renderer, params, ref_c, que, ...)."""
        return fn(self.jr, self.params, self.jref_c, self.jque, *args, **kw)

    def jit(self, make_fn, *args, keep=None):
        """A JAX chunk loop: make_fn(renderer[, keep])(params, ref_c, que,
        ...)."""
        fn = make_fn(self.jr) if keep is None else make_fn(self.jr, keep)
        return fn(self.params, self.jref_c, self.jque, *args)

    def port(self, fn, *args, **kw):
        return fn(self.r, self.ref_c, self.que, *args, **kw)


@pytest.fixture(scope="module")
def pairs(scene):
    cache = {}

    def get(**over):
        """over: render-time fields only; the encode is shared."""
        key = tuple(sorted(over.items()))
        if key not in cache:
            base = cache.get(()) or Pair(scene)
            cache[()] = base
            cache[key] = Pair(scene, base.jref_c, **over) if over else base
        return cache[key]

    return get


def assert_frames_match(ours, theirs, skipped_zero=True):
    assert ours["kept_rays"] == theirs["kept_rays"] > 0
    np.testing.assert_array_equal(ours["keep_mask"], theirs["keep_mask"])
    arrays = [k for k, v in theirs.items()
              if isinstance(v, np.ndarray) and k != "keep_mask"]
    assert set(arrays) == {k + s for k in KEEP_BASE for s in ("", "_fine")}
    for k in arrays:
        assert ours[k].shape == theirs[k].shape, k
        close(ours[k], theirs[k], tol(k))
        if skipped_zero:
            assert (ours[k][0, ~ours["keep_mask"]] == 0).all(), k


# ---------------- sampling and positions ----------------

def test_sample_depth_ranged():
    rng = np.random.RandomState(0)
    near = rng.uniform(2.5, 4.0, (2, 5)).astype(np.float32)
    far = (near + rng.uniform(0.1, 1.5, (2, 5))).astype(np.float32)
    for ours, theirs in zip(S.sample_depth_ranged(t(near), t(far), 7),
                            jS.sample_depth_ranged(near, far, 7)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=1e-6)
    # constant rows reproduce JAX's sample_depth
    dr = np.asarray([[2.5, 5.5], [2.0, 6.0]], np.float32)
    ranged = S.sample_depth_ranged(t(dr[:, :1].repeat(5, 1)),
                                   t(dr[:, 1:].repeat(5, 1)), 7)
    for a, b in zip(ranged, jS.sample_depth(dr, 2, 5, 7, False)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sinusoid_pos_at():
    pos = np.random.RandomState(1).uniform(0, 63, (4, 8)).astype(np.float32)
    close(I.sinusoid_pos_at(16, t(pos)), jI.sinusoid_pos_at(16, pos),
          atol=1e-5)
    close(I.sinusoid_pos_at(16, torch.arange(64.0)),
          I.sinusoid_pos_encoding(16, 64)[0], atol=2e-6)


@pytest.mark.parametrize("mode", ["pos_stride", "pos"])
def test_agg_net_positions(scene, mode):
    rng = np.random.RandomState(13)
    shape = (3, 1, 4, 8)                                  # rfn,qn,rn,dn
    prj_dir = rng.randn(*shape, 3)
    que_dir = rng.randn(*shape[1:], 3)
    mask = (rng.rand(*shape, 1) > 0.3)
    mask[:, 0, 0, 0] = False
    prj = {"ray_feats": rng.randn(*shape, 32),
           "img_feats": rng.randn(*shape, 32),
           "hit_prob": rng.rand(*shape, 1), "vis": rng.rand(*shape, 1),
           "rgb": rng.rand(*shape, 3),
           "dir": prj_dir / np.linalg.norm(prj_dir, axis=-1, keepdims=True),
           "mask": mask}
    prj = {k: v.astype(np.float32) for k, v in prj.items()}
    que_dir = (que_dir / np.linalg.norm(que_dir, axis=-1, keepdims=True)
               ).astype(np.float32)
    kw = ({"pos_stride": 4} if mode == "pos_stride" else
          {"pos": rng.uniform(0, 63, shape[1:]).astype(np.float32)})
    tree = scene[2]["params"]["agg_net"]
    net = A.DefaultAggregationNet(32, 64)
    load_flax_params(net, tree)
    prj_t = {k: t(v) for k, v in prj.items()}
    ours = net(prj_t, t(que_dir), **{k: t(v) if k == "pos" else v
                                     for k, v in kw.items()})
    jnet = jA.DefaultAggregationNet({"neuray_dim": 32, "sample_num": 64})
    theirs = jax.jit(functools.partial(jnet.apply, **kw))(
        {"params": tree}, prj, que_dir)
    for a, b in zip(ours, theirs):
        close(a.detach(), b)
    # the positions reach the attention
    default = net(prj_t, t(que_dir))[0].detach()
    assert (default - ours[0].detach()).abs().max() > 1e-3


# ---------------- probes and chunk passes ----------------

def _window_borderline(p: Pair) -> np.ndarray:
    """Rays whose cumulative probe hit fraction comes within 1e-5 of q or
    1 - q: a cumsum (port) and a triangular matmul (JAX) may round them
    to neighbouring windows."""
    hp = R._chunk_loop(
        lambda q: {"hp": p.r._probe_hit_prob(p.ref_c, q)[1]}, p.que,
        p.r.cfg.ray_batch_num)["hp"][0]
    frac = torch.cumsum(hp, -1) / (hp.sum(-1, keepdim=True) + 1e-12)
    q = p.r.cfg.focus_quantile
    return (((frac - q).abs() < 1e-5)
            | ((frac - (1 - q)).abs() < 1e-5)).any(-1).numpy()


def test_probe_scores(pairs):
    p = pairs()
    close(p.port(R.probe_rays), p.jit(jR.make_probe_fn))


def test_focus_probe_windows(pairs):
    p = pairs()
    score, near, far = p.port(R.focus_probe_rays)
    jscore, jnear, jfar = (np.asarray(x)[0]
                           for x in p.jit(jR.make_focus_probe_fn))
    close(score[0], jscore)
    same = ~_window_borderline(p)
    np.testing.assert_allclose(near[0].numpy()[same], jnear[same], rtol=1e-6)
    np.testing.assert_allclose(far[0].numpy()[same], jfar[same], rtol=1e-6)
    # narrowed windows on confident rays, the full range below 1e-3
    low = jscore <= 1e-3
    assert (near[0][low] == 2.5).all() and (far[0][low] == 5.5).all()
    assert ((near[0] > 2.5) | (far[0] < 5.5)).any()


@pytest.mark.parametrize("use_all", [False, True])
def test_render_chunk_focus(pairs, use_all):
    """On JAX's windows; fine_depth_use_all merges the coarse depths
    into the fine pass (and rescales the fine positions)."""
    p = pairs(fine_depth_use_all=use_all)
    _, near, far = p.jit(jR.make_focus_probe_fn)
    keep = ("pixel_colors_nr", "pixel_colors_nr_fine", "hit_prob_nr",
            "hit_prob_nr_fine", "render_depth", "render_depth_fine")
    theirs = p.jit(jR.make_focus_render_fn, near, far, keep=keep)
    ours = p.port(R.render_focus_rays, t(near), t(far), keep)
    assert ours["hit_prob_nr_fine"].shape[-1] == (12 if use_all else 6)
    for k in keep:
        close(ours[k], theirs[k], tol(k))


@pytest.mark.parametrize("use_all", [False, True])
def test_render_chunk_fine(pairs, use_all):
    """From JAX's coarse hit_prob."""
    p = pairs(fine_depth_use_all=use_all)
    hp = p.jit(jR.make_coarse_render_fn, keep=("hit_prob_nr",))[
        "hit_prob_nr"]
    keep = ("pixel_colors_nr_fine", "render_depth_fine")
    theirs = p.jit(jR.make_fine_render_fn, hp, keep=keep)
    ours = p.port(R.render_fine_rays, t(hp), keep)
    for k in keep:
        close(ours[k], theirs[k], tol(k))


def test_render_rays_fine_depth_use_all(pairs):
    p = pairs(fine_depth_use_all=True)
    keep = ("pixel_colors_nr", "pixel_colors_nr_fine", "render_depth_fine")
    theirs = p.jit(jR.make_ray_render_fn, keep=keep)
    ours = p.port(R.render_rays, keep)
    for k in keep:
        close(ours[k], theirs[k], tol(k))


# ---------------- host helpers ----------------

@pytest.mark.parametrize("dilate", [0, 1, 2])
def test_dilate_keep_mask(dilate):
    m = np.random.RandomState(dilate).rand(31 * 33) > 0.97
    ours = R._dilate_keep_mask(m, (31, 33), dilate)
    np.testing.assert_array_equal(ours, jR._dilate_keep_mask(m, (31, 33),
                                                             dilate))
    assert ours.sum() > m.sum() if dilate else (ours == m).all()


@pytest.mark.parametrize("h,w,stride", [(32, 32, 2), (31, 33, 2),
                                        (32, 32, 3)])
def test_strided_focus_probe(monkeypatch, h, w, stride):
    """The pooling, dilation and upsampling from the same probe outputs,
    which a stand-in probe hands to both packages."""
    hs, ws = -(-h // stride), -(-w // stride)
    rng = np.random.RandomState(h + w + stride)
    score = (rng.rand(1, hs * ws) * (rng.rand(1, hs * ws) > 0.8)).astype(
        np.float32)
    near = rng.uniform(2.5, 4.0, (1, hs * ws)).astype(np.float32)
    far = (near + rng.uniform(0.1, 1.5, (1, hs * ws))).astype(np.float32)
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    coords = np.stack([xs, ys], -1).reshape(1, -1, 2).astype(np.float32)
    probed = {}

    def jax_probe(params, ref_c, que_p):
        probed["jax"] = np.asarray(que_p["coords"])
        return tuple(jnp.asarray(x) for x in (score, near, far))

    def port_probe(renderer, ref_c, que_p, mesh=None):
        assert mesh is None
        probed["port"] = que_p["coords"].numpy()
        return tuple(torch.from_numpy(x) for x in (score, near, far))

    monkeypatch.setattr(R, "focus_probe_rays", port_probe)
    theirs = jR._strided_focus_probe(jax_probe, None, None,
                                     {"coords": jnp.asarray(coords)}, 0.3,
                                     (h, w), stride)
    ours = R._strided_focus_probe(None, None,
                                  {"coords": torch.from_numpy(coords)}, 0.3,
                                  (h, w), stride)
    np.testing.assert_array_equal(probed["port"], probed["jax"])
    for a, b in zip(ours, theirs):
        assert a.shape == np.shape(b)
        np.testing.assert_array_equal(a, np.asarray(b))
    assert ours[0].any() and not ours[0].all()


def test_with_probe_sample_num_shares_the_modules(pairs):
    p = pairs()
    r8 = R._with_probe_sample_num(p.r, 8)
    assert r8.cfg.probe_sample_num == 8 and p.r.cfg.probe_sample_num == 4
    assert r8.agg_net is p.r.agg_net and r8.init_net is p.r.init_net
    assert R._with_probe_sample_num(p.r, 4) is p.r


# ---------------- frame drivers, given JAX's probe ----------------

@pytest.mark.parametrize("stride", [1, 2])
def test_render_frame_probe_focus(pairs, stride):
    p = pairs()
    probe_fn = jR.make_focus_probe_fn(p.jr)
    if stride == 1:
        jprobe = p.jit(jR.make_focus_probe_fn)
        probe = tuple(t(x) for x in jprobe)
    else:
        jprobe = jR._strided_focus_probe(probe_fn, p.params, p.jref_c,
                                         p.jque, TH, (H, W), stride)
        probe = jprobe
    kw = dict(threshold=TH, keep_base=KEEP_BASE, image_hw=(H, W), dilate=1,
              probe_stride=stride)
    assert_frames_match(
        p.port(R.render_frame_probe_focus, probe_out=probe, **kw),
        p.jax(jR.render_frame_probe_focus, probe_out=jprobe, **kw))


def test_render_frame_probe_skip(pairs):
    p = pairs()
    jscore = p.jit(jR.make_probe_fn)
    kw = dict(threshold=TH, keep_base=KEEP_BASE, image_hw=(H, W), dilate=1)
    assert_frames_match(
        p.port(R.render_frame_probe_skip, probe_out=t(jscore), **kw),
        p.jax(jR.render_frame_probe_skip, probe_out=jscore, **kw))


def test_render_frame_skip_empty(pairs):
    p = pairs()
    ours = p.port(R.render_frame_skip_empty, threshold=TH, keep_base=KEEP_BASE)
    assert_frames_match(ours, p.jax(jR.render_frame_skip_empty, threshold=TH,
                                    keep_base=KEEP_BASE), skipped_zero=False)
    skipped = ~ours["keep_mask"]
    for k in KEEP_BASE:   # the fine output of a skipped ray is its coarse
        np.testing.assert_array_equal(ours[k + "_fine"][0, skipped],
                                      ours[k][0, skipped])


@pytest.mark.parametrize("frame_fn", ["render_frame_probe_skip",
                                      "render_frame_probe_focus"])
def test_zero_kept_rays(pairs, frame_fn):
    p = pairs()
    ours = p.port(getattr(R, frame_fn), threshold=1e9, keep_base=KEEP_BASE)
    theirs = p.jax(getattr(jR, frame_fn), threshold=1e9,
                   keep_base=KEEP_BASE)
    assert ours["kept_rays"] == theirs["kept_rays"] == 0
    for k in (k + s for k in KEEP_BASE for s in ("", "_fine")):
        assert ours[k].shape == theirs[k].shape, k
        assert not ours[k].any()
    assert ours["render_depth"].shape == (1, H * W)


# ---------------- audits ----------------

def test_audits(pairs):
    """The same rays are audited (the same RandomState picks) and give
    the same false-skip rate and window-clip figures."""
    p = pairs()
    score, near, far = (np.asarray(x)
                        for x in p.jit(jR.make_focus_probe_fn))
    keep_mask = score[0] > TH
    skip_idx, keep_idx = np.nonzero(~keep_mask)[0], np.nonzero(keep_mask)[0]
    for n in (100, 2048):
        fs = p.port(R.estimate_false_skip, skip_idx, TH, n, seed=3)
        assert fs == p.jax(jR.estimate_false_skip, skip_idx, TH, n, seed=3)
    for n in (20, 1024):
        wc = p.port(R.estimate_window_clip, keep_idx, near, far, TH,
                    sample_rays=n, seed=3)
        jwc = p.jax(jR.estimate_window_clip, keep_idx, near, far, TH,
                    sample_rays=n, seed=3)
        assert wc.keys() == jwc.keys()
        for k in wc:
            np.testing.assert_allclose(wc[k], jwc[k], rtol=1e-4, atol=1e-7)
    assert wc["clip_mass"] > 0


AUTO_CASES = {
    "accept": dict(dilate=0, tol=1.0),
    "escalate_then_fall_back": dict(dilate=0, tol=-1.0,
                                    max_probe_sample_num=8),
    "keep_every_ray": dict(threshold=-1.0, dilate=0, tol=0.0),
    "focus_accept": dict(dilate=0, tol=1.0, focus=True, win_tol_db=1e9),
    "focus_window_guard": dict(dilate=0, tol=1.0, focus=True,
                               win_tol_db=-1.0, max_probe_sample_num=8),
    "focus_strided_accept": dict(image_hw=(H, W), dilate=1, tol=1.0,
                                 focus=True, probe_stride=2,
                                 win_tol_db=1e9),
}


@pytest.mark.parametrize("case", list(AUTO_CASES))
def test_render_frame_probe_auto(pairs, case):
    p = pairs()
    kw = {"threshold": TH, "keep_base": KEEP_BASE, **AUTO_CASES[case]}
    ours = p.port(R.render_frame_probe_auto, **kw)
    theirs = p.jax(jR.render_frame_probe_auto, **kw)
    for k in ("fallback", "probe_sample_num", "false_skip_rate"):
        assert ours[k] == theirs[k], k
    assert len(ours["audit_trail"]) == len(theirs["audit_trail"])
    for a, b in zip(ours["audit_trail"], theirs["audit_trail"]):
        assert a.keys() == b.keys()
        wa, wb = a.pop("window_clip_db"), b.pop("window_clip_db")
        assert a == b
        assert (wa is None) == (wb is None)
        if wa is not None:
            np.testing.assert_allclose(wa, wb, rtol=1e-4, atol=1e-7)
    assert_frames_match(ours, theirs,
                        skipped_zero=theirs["fallback"] is None)
    expected = {"accept": (None, 4), "escalate_then_fall_back": (
        "two_phase", 8), "focus_window_guard": ("two_phase", 8)}
    if case in expected:
        assert (ours["fallback"], ours["probe_sample_num"]) == expected[case]
    if case == "keep_every_ray":
        assert ours["kept_rays"] == H * W and ours["false_skip_rate"] == 0.0


# ---------------- half-grid init diff ----------------

@pytest.mark.parametrize("h,w", [(32, 32), (64, 32)])
def test_depth_init_net_half_grid(scene, monkeypatch, h, w):
    """G' with diff_scale=2 matches JAX's half-pixel upsample; a
    corner-aligned one does not."""
    ref = make_sphere_scene(np.random.RandomState(0), 3, h, w)
    tree = scene[2]["params"]["init_net"]
    net = N.DepthInitNet(diff_scale=2)
    load_flax_params(net, tree)
    net.eval()
    ours = net({k: t(v) for k, v in ref.items()}).detach()
    theirs = jax.jit(jN.DepthInitNet({"diff_scale": 2}).apply)(
        {"params": tree}, ref)
    close(ours, theirs)

    def corner_aligned(x, s, hh, ww):
        return F.interpolate(x.permute(0, 3, 1, 2), size=(hh, ww),
                             mode="bilinear",
                             align_corners=True).permute(0, 2, 3, 1)

    monkeypatch.setattr(N, "upsample_half_pixel", corner_aligned)
    off = net({k: t(v) for k, v in ref.items()}).detach()
    assert np.abs(off.numpy() - np.asarray(theirs)).max() > 1e-3


@pytest.mark.parametrize("h,w", [(34, 30), (35, 31)])
def test_half_grid_diff_feats(h, w):
    """The subgrid diff features at sizes the init net's encoder does not
    take, the odd ones included (the upsample crops to h, w), against
    the JAX package's arithmetic (``init_net.py:125-140``)."""
    ref = make_sphere_scene(np.random.RandomState(0), 3, h, w)
    dn = jN.extract_depth_for_init(ref["depth_range"], ref["depth"])

    @jax.jit
    def jax_diff(imgs, dn, depth_range, poses, Ks):
        ks = Ks * jnp.asarray([0.5, 0.5, 1.0])[None, :, None]
        diff_s = jN.get_diff_feats(imgs[:, ::2, ::2], dn[:, ::2, ::2],
                                   depth_range, poses, ks)
        return jax.image.scale_and_translate(
            diff_s, (3, h, w, 8), (1, 2), scale=jnp.asarray([2.0, 2.0]),
            translation=jnp.asarray([0.0, 0.0]), method="linear")

    theirs = jax_diff(ref["imgs"], dn, ref["depth_range"], ref["poses"],
                      ref["Ks"])
    ours = N.get_diff_feats_subgrid(
        t(ref["imgs"]), t(dn), t(ref["depth_range"]), t(ref["poses"]),
        t(ref["Ks"]), 2)
    assert ours.shape == (3, h, w, 8)
    close(ours, theirs)


# ---------------- the shipped fast profile ----------------

def test_render_config_from_fast_profile_yaml():
    cfg = load_cfg(str(ROOT / "configs" / "gen" /
                       "neuray_gen_depth_fast.yaml"))
    ours = R.RenderConfig.from_cfg(cfg)
    theirs = jR.RenderConfig.from_cfg(cfg)
    for f in dataclasses.fields(theirs):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert ours.init_diff_scale == 2 and not ours.fine_use_vis
    assert ours == R.RenderConfig(**chip_smoke.FAST_PROFILE)
    args = chip_smoke.FAST_ARGS
    assert (args["threshold"], args["tol"], args["dilate"],
            args["probe_stride"]) == (
        cfg["skip_empty_threshold"], cfg["skip_auto_tol"],
        cfg["probe_dilate"], cfg["probe_stride"])
    R.NeurayRenderer(ours)
