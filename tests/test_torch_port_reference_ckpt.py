"""The port's reader of the reference's PyTorch checkpoints
(``neuray_tpu_torch/utils/reference_ckpt.py``, the CLI
``python -m neuray_tpu_torch.convert_reference_ckpt``) against the JAX
package's converter: ``neuray_tpu/utils/torch_convert.py:
convert_gen_state_dict`` (and ``mvsnet_convert.py``) followed by
``utils/params.py: flax_to_torch`` gives, leaf for leaf, the tensors the
port's direct load gives (``rtol=0, atol=0``: a rename moves no bit).

The reference-named modules are ``tests/test_torch_convert.py``'s with
random weights (PyTorch's default init under a seed), composed here for
``use_vis`` off and on, coarse-only and hierarchical; the cost-volume
model adds an ``init_net`` whose ``mvsnet.*`` keys follow
``mvsnet_convert.py``'s docstring (BatchNorms with ``running_mean`` /
``running_var``, deconvs as ``convN.0`` / ``.1``) and whose other keys
follow ``torch_convert.py``'s ``cost_volume_init_net``. Also: the strict
errors, the ``network_state_dict`` wrapper, a refused pickle, the
record's inverse, the CLI's ``ckpt_best.pt`` read back by
``load_gen_state``, and a render from the converted weights against
JAX's render from JAX's conversion (1e-4).
"""
import argparse
import pickle

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from neuray_tpu.data.synthetic import make_query, make_sphere_scene
from neuray_tpu.models import renderer as jR
from neuray_tpu.utils.mvsnet_convert import load_mvsnet_ckpt
from neuray_tpu.utils.torch_convert import convert_gen_state_dict as j_convert

from neuray_tpu_torch import convert_reference_ckpt as CLI
from neuray_tpu_torch.models import renderer as R
from neuray_tpu_torch.models.ft import load_gen_state
from neuray_tpu_torch.selfcheck import write_cfg
from neuray_tpu_torch.utils import reference_ckpt as RC
from neuray_tpu_torch.utils.params import flax_to_torch
from tests.test_torch_convert import (
    AggNetT, DepthInitNetT, DistDecoderT, ResidualBlockT, ResUNetT,
    VisEncoderT, conv1x1, conv3x3)

torch.set_num_threads(1)


# ---------------- reference-named MVSNet and cost-volume init net ----------

class ABNT(nn.Module):
    """An inplace-ABN BatchNorm's state: weight, bias, running stats."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.rand(c) + 0.5)
        self.bias = nn.Parameter(torch.randn(c))
        self.register_buffer("running_mean", torch.randn(c))
        self.register_buffer("running_var", torch.rand(c) + 0.5)


class ConvBnT(nn.Module):
    def __init__(self, i, o, k, conv=nn.Conv2d):
        super().__init__()
        self.conv = conv(i, o, k, 1, k // 2, bias=False)
        self.bn = ABNT(o)


class FeatureNetT(nn.Module):
    def __init__(self):
        super().__init__()
        chans = [(3, 8, 3), (8, 8, 3), (8, 16, 5), (16, 16, 3), (16, 16, 3),
                 (16, 32, 5), (32, 32, 3)]
        for i, (a, b, k) in enumerate(chans):
            setattr(self, f"conv{i}", ConvBnT(a, b, k))
        self.feature = nn.Conv2d(32, 32, 3, 1, 1)


class CostRegNetT(nn.Module):
    def __init__(self):
        super().__init__()
        for i, (a, b) in enumerate([(32, 8), (8, 16), (16, 16), (16, 32),
                                    (32, 32), (32, 64), (64, 64)]):
            setattr(self, f"conv{i}", ConvBnT(a, b, 3, nn.Conv3d))
        for i, (a, b) in ((7, (64, 32)), (9, (32, 16)), (11, (16, 8))):
            setattr(self, f"conv{i}", nn.Sequential(
                nn.ConvTranspose3d(a, b, 3, 2, 1, 1, bias=False), ABNT(b)))
        self.prob = nn.Conv3d(8, 1, 3, 1, 1)


class MVSNetT(nn.Module):
    def __init__(self):
        super().__init__()
        self.feature = FeatureNetT()
        self.cost_regularization = CostRegNetT()


def seq3(i):
    return nn.Sequential(conv3x3(i, 32), ResidualBlockT(32), conv1x1(32, 32))


class CostVolumeInitNetT(nn.Module):
    def __init__(self):
        super().__init__()
        self.mvsnet = MVSNetT()
        self.res_net = ResUNetT(3, (2, 3, 6), 32, 32)
        self.volume_conv2d = seq3(64)
        self.depth_conv = seq3(1)
        self.out_conv = seq3(96)


class RefRenderer(nn.Module):
    """A reference ``NeuralRayGenRenderer``'s state-dict names."""

    def __init__(self, use_vis, fine_use_vis, hierarchical, init):
        super().__init__()
        self.vis_encoder = VisEncoderT()
        self.dist_decoder = DistDecoderT(use_vis)
        self.image_encoder = ResUNetT(3, (1, 2, 6, 4), 32, 16)
        self.agg_net = AggNetT()
        if hierarchical:
            self.fine_dist_decoder = DistDecoderT(fine_use_vis)
            self.fine_agg_net = AggNetT()
        if init == "depth":
            self.init_net = DepthInitNetT()
        elif init == "cost_volume":
            self.init_net = CostVolumeInitNetT()


VARIANTS = {
    "depth_coarse_novis": dict(use_hierarchical=False, use_vis=False,
                               fine_use_vis=False, init_net_type="depth"),
    "depth_hier_vis": dict(use_hierarchical=True, use_vis=True,
                           fine_use_vis=True, init_net_type="depth"),
    "depth_hier_novis": dict(use_hierarchical=True, use_vis=False,
                             fine_use_vis=False, init_net_type="depth"),
    "cost_volume_hier": dict(use_hierarchical=True, use_vis=False,
                             fine_use_vis=False, init_net_type="cost_volume"),
}


def reference_sd(flags, seed=0):
    torch.manual_seed(seed)
    m = RefRenderer(flags["use_vis"], flags["fine_use_vis"],
                    flags["use_hierarchical"], flags["init_net_type"])
    return {k: v.detach().clone() for k, v in m.state_dict().items()}


def render_cfg(flags, **over):
    return R.RenderConfig(
        use_hierarchical_sampling=flags["use_hierarchical"],
        use_vis=flags["use_vis"], fine_use_vis=flags["fine_use_vis"],
        init_net_type=flags["init_net_type"], **over)


def assert_states_equal(ours, theirs):
    assert set(ours) == set(theirs), (sorted(set(ours) ^ set(theirs))[:10])
    for k, v in theirs.items():
        assert ours[k].dtype == torch.float32, k
        assert torch.equal(ours[k], v), k


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_load_equals_jax_converter_leaf_for_leaf(variant):
    flags = VARIANTS[variant]
    sd = reference_sd(flags)
    ours, record = RC.convert_gen_state_dict(sd, **flags)
    theirs = flax_to_torch(j_convert(sd, **flags))
    assert_states_equal(ours, theirs)
    assert len(record) == len(sd) == len(ours)
    renderer = R.NeurayRenderer(render_cfg(flags))
    RC.check_state(ours, renderer.state_dict())
    renderer.load_state_dict(ours, strict=True)


def test_reverse_mapping_inverts_the_conversion():
    """The port state back to reference names (what ``chip_smoke.py``
    phase 16 writes from the ``.npz`` weights): the same tensors under the
    same keys, the same record."""
    flags = VARIANTS["cost_volume_hier"]
    sd = reference_sd(flags)
    state, record = RC.convert_gen_state_dict(sd, **flags)
    back, record_back = RC.convert_gen_state_dict(state, **flags,
                                                  reverse=True)
    assert record_back == record and set(back) == set(sd)
    for k, v in sd.items():
        assert back[k] is v
    kinds = {kind for _, _, kind in record}
    assert kinds == {"conv2d", "conv3d", "deconv3d", "linear", "norm",
                     "bn_stat", "bias"}
    deconv = [(r, p) for r, p, kind in record if kind == "deconv3d"]
    assert ("init_net.mvsnet.cost_regularization.conv7.0.weight",
            "init_net.mvsnet.cost_regularization.conv7.conv.weight") in deconv
    with pytest.raises(KeyError, match="port keys that fill nothing"):
        RC.convert_gen_state_dict({**state, "stray": torch.zeros(1)},
                                  **flags, reverse=True)


def test_mvsnet_ckpt_equals_jax(tmp_path):
    """A lightning checkpoint's ``model.*`` MVSNet (a state dict of
    tensors, which ``weights_only`` loads): the port's reader against the
    JAX package's ``load_mvsnet_ckpt`` + ``flax_to_torch``."""
    torch.manual_seed(3)
    sd = MVSNetT().state_dict()
    path = str(tmp_path / "mvsnet_pl.ckpt")
    torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()},
                "epoch": 15}, path)
    ours = RC.read_mvsnet_ckpt(path)
    theirs = flax_to_torch(load_mvsnet_ckpt(path))
    assert_states_equal(ours, theirs)
    state, _ = RC.convert_mvsnet_state_dict(sd, "init_net.mvsnet")
    full = R.NeurayRenderer(render_cfg(VARIANTS["cost_volume_hier"]))
    own = {k: v for k, v in full.state_dict().items()
           if k.startswith("init_net.mvsnet.")}
    RC.check_state(state, own)


def test_refused_pickle_names_the_file_and_class(tmp_path):
    """A checkpoint that pickles an object (lightning's hyperparameters as
    an ``argparse.Namespace``) is refused, not loaded unsafely."""
    sd = MVSNetT().state_dict()
    path = str(tmp_path / "mvsnet_pl.ckpt")
    torch.save({"state_dict": sd,
                "hyper_parameters": argparse.Namespace(lr=1e-3)}, path)
    with pytest.raises(pickle.UnpicklingError) as e:
        RC.read_mvsnet_ckpt(path)
    assert path in str(e.value) and "argparse.Namespace" in str(e.value)


@pytest.mark.parametrize("case", ["missing", "extra"])
def test_strict_reference_keys(case):
    flags = VARIANTS["depth_hier_novis"]
    sd = reference_sd(flags)
    if case == "missing":
        gone = ["agg_net.prob_embed.0.weight", "init_net.depth_skip.2.weight"]
        for k in gone:
            del sd[k]
        with pytest.raises(KeyError) as e:
            RC.convert_gen_state_dict(sd, **flags)
        assert all(k in str(e.value) for k in gone)
    else:
        sd["dist_decoder.vis_decoder.0.weight"] = torch.zeros(32, 32)
        sd["init_net.unused"] = torch.zeros(1)
        with pytest.raises(KeyError) as e:
            RC.convert_gen_state_dict(sd, **flags)
        assert "dist_decoder.vis_decoder.0.weight" in str(e.value)
        assert "init_net.unused" in str(e.value)


def test_strict_port_parameters():
    """A port parameter that no reference key fills (the config asks for
    the vis decoders the file lacks), a key the port lacks, a shape that
    differs: each listed."""
    flags = VARIANTS["depth_hier_novis"]
    state, _ = RC.convert_gen_state_dict(reference_sd(flags), **flags)
    own = R.NeurayRenderer(render_cfg({**flags, "use_vis": True})).state_dict()
    with pytest.raises(KeyError) as e:
        RC.check_state(state, own)
    assert "dist_decoder.vis_decoder.fc0.weight" in str(e.value)
    assert "fine_dist_decoder.vis_decoder" not in str(e.value)
    own = R.NeurayRenderer(render_cfg(flags)).state_dict()
    bad = dict(state, extra_leaf=torch.zeros(1))
    bad["agg_net.prob_embed_0.weight"] = torch.zeros(3, 3)
    with pytest.raises(KeyError) as e:
        RC.check_state(bad, own)
    assert "extra_leaf" in str(e.value)
    assert "agg_net.prob_embed_0.weight: (3, 3) for (32, 34)" in str(e.value)


@pytest.mark.parametrize("wrapped", [True, False])
def test_reads_the_network_state_dict_wrapper(tmp_path, wrapped):
    flags = VARIANTS["depth_coarse_novis"]
    sd = reference_sd(flags)
    path = str(tmp_path / "model_best.pth")
    torch.save({"network_state_dict": sd, "step": 123456} if wrapped else sd,
               path)
    got, step = RC.read_reference_ckpt(path)
    assert step == (123456 if wrapped else 0)
    assert set(got) == set(sd)
    assert all(torch.equal(got[k], v) for k, v in sd.items())


# ---------------- the CLI, and a render from its file ----------------

GEN_CFG = dict(name="ref_gen", use_hierarchical_sampling=True,
               depth_sample_num=8, fine_depth_sample_num=8,
               ray_batch_num=64, dist_decoder_cfg={"use_vis": False},
               fine_dist_decoder_cfg={"use_vis": False},
               init_net_type="depth")


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """``python -m neuray_tpu_torch.convert_reference_ckpt`` on a reference
    file of random weights, the config's flags read from its file."""
    work = tmp_path_factory.mktemp("ref_ckpt")
    flags = RC.gen_flags(GEN_CFG)
    sd = reference_sd(flags, seed=5)
    pth = str(work / "model_best.pth")
    torch.save({"network_state_dict": sd, "step": 7}, pth)
    cfg = write_cfg(work / "gen.yaml", GEN_CFG)
    out = work / "model" / GEN_CFG["name"]
    CLI.main(["--torch_ckpt", pth, "--cfg", cfg, "--out", str(out)])
    return work, sd, flags


def test_cli_writes_what_load_gen_state_reads(converted):
    work, sd, flags = converted
    ckpt = torch.load(work / "model" / "ref_gen" / "ckpt_best.pt",
                      weights_only=True)
    assert ckpt["step"] == 7 and set(ckpt) == {"step", "best_metric",
                                               "params"}
    state = load_gen_state(str(work / "model"), "ref_gen")
    assert_states_equal(state, flax_to_torch(j_convert(sd, **flags)))


def test_render_from_the_converted_file_matches_jax(converted):
    """The port renders (exact coarse + fine, 3 views at 32x32, rays
    through the image centre) from the CLI's file as JAX renders from its
    own conversion of the same reference file: 1e-4."""
    work, sd, flags = converted
    rng = np.random.RandomState(0)
    ref = make_sphere_scene(rng, 3, 32, 32)
    que = make_query(rng, 32, 32, 0, full_image=True)
    que = {k: v for k, v in que.items() if k != "imgs"}
    que["coords"] = que["coords"][:, 384:640]
    cfg = R.RenderConfig.from_cfg(GEN_CFG)
    jr = jR.NeurayRenderer(jR.RenderConfig.from_cfg(GEN_CFG))
    with jax.default_matmul_precision("highest"):
        theirs = jR.render_full(
            jr, jax.tree.map(jnp.asarray, j_convert(sd, **flags)),
            {k: jnp.asarray(v) for k, v in ref.items()},
            {k: jnp.asarray(v) for k, v in que.items()})
    renderer = R.NeurayRenderer(cfg)
    renderer.load_state_dict(load_gen_state(str(work / "model"), "ref_gen"))
    ours = R.render_full(renderer.eval(),
                         {k: torch.from_numpy(v) for k, v in ref.items()},
                         {k: torch.from_numpy(v) for k, v in que.items()})
    for k in ("pixel_colors_nr", "pixel_colors_nr_fine"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]),
                                   rtol=0, atol=1e-4, err_msg=k)
