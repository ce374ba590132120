"""The NeuRay generalization renderer (port of
``neuray_tpu/models/renderer.py``): the exact coarse+fine render and the
probe-driven eval drivers.

Per scene, ``encode_ref`` runs the init net (the depth init net, or the
cost-volume init net on the ref views and their ``src`` views), the
image encoder and the vis encoder once and packs ``[ray_feats |
img_feats]`` into one 64-channel map. Per ray chunk,
``NeurayRenderer.render_chunk`` samples depths, projects every sample
into every reference view, gathers rgb and features (``ops.gather``
kernels on a CUDA tensor), decodes the visibility mixture, aggregates
across views and composites; then the same again at importance-resampled
fine depths. ``render_full`` runs
the encode and the chunk loop under ``torch.inference_mode()``. Each
pass is a span ``pass``, its decode and aggregation spans
``dist_decoder`` and ``agg_net`` inside it (``utils/profiling.py``).

``NeurayRenderer.forward`` is the training forward on one ray chunk,
with autograd (the encode included): the fine sampler reads the CDF at
random draws from a ``torch.Generator`` and sorts them, the outputs carry
``pixel_colors_gt``, and ``depth_loss_coords`` adds the depth-loss head.
Gradients reach the gather maps through the backward kernel. With
``use_self_hit_prob`` a training pass also samples the query view's own
ray features (finetuning's consistency path, ``models/ft.py``), and
``init_net_type=""`` builds no init net (finetuning's renderer, whose
ray features are parameters).

With ``use_dr_prediction`` each pass also renders directly
(``_direct_rendering``, the reference's second branch): the views'
decoded alphas averaged by their visibility, and colours from an SH fit
of the views' colours weighted by their hit probabilities
(``ops/sh.py``), or the network's with ``use_nr_color_for_dr``; the
outputs carry ``pixel_colors_dr`` and ``hit_prob_dr`` (``_fine`` for the
fine pass), which the DR losses read.

``use_bf16`` runs the convs and dense layers in bf16 (parameters stay
f32; their bf16 copies are cast once, ``blocks.ComputeCast``) and
gathers from a bf16 map and image; with ``gather_quant="u8"`` the map
and the image are u8 codes instead, dequantized to bf16 by the gather
(``build_gather_cache``). Outputs then come in the JAX package's dtypes:
colours and hit probabilities bf16, depths f32.

The eval drivers decide on the host which rays to render. A probe pass
at ``probe_sample_num`` samples scores every ray (``probe_chunk``) and,
for the focused render, also narrows its depth window
(``probe_chunk_focus``); only the kept rays go through a chunk loop, and
skipped rays are 0 (``render_frame_probe_skip``,
``render_frame_probe_focus``). ``render_frame_skip_empty`` gates the
fine pass on the exact coarse pass instead. ``render_frame_probe_auto``
audits the probe against that exact gate on a random sample of rays
(``estimate_false_skip``, ``estimate_window_clip``), doubles the probe's
samples when the audit fails, and falls back to the exact gate past
``max_probe_sample_num``. The JAX package pads kept rays into buckets of
chunks for jit's static shapes; here they go straight to the chunk loop,
whose last chunk ``chunk_coords`` pads, and no kept ray's output depends
on the padding.

With ``mesh`` (a ``parallel.sharding.Mesh`` of more than one rank) every
ray loop (``render_rays``, ``probe_rays``, ...) and so the drivers' probe,
audits and render phases shard the ray axis over the ranks
(``parallel.sharding.shard_rays``); every rank holds every ray's probe
result, so the compaction on the host is the same on each.

Dicts keep the JAX package's layouts and key names: ref fields
[rfn, h, w, c] / [rfn, 3, 4] / [rfn, 3, 3] / [rfn, 2], que fields
coords [qn, rn, 2], poses, Ks, depth_range; outputs [qn, rn, ...].
The frame drivers take one query view (qn = 1) and return numpy arrays.
"""
from __future__ import annotations

import copy
import dataclasses
import weakref
from typing import Any, Callable, Dict, Iterable, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from neuray_tpu_torch.models.agg_net import DefaultAggregationNet
from neuray_tpu_torch.models.cost_volume import CostVolumeInitNet
from neuray_tpu_torch.models.dist_decoder import MixtureLogisticsDistDecoder
from neuray_tpu_torch.models.init_net import DepthInitNet
from neuray_tpu_torch.models.resunet import ResUNetLight
from neuray_tpu_torch.models.vis_encoder import DefaultVisEncoder
from neuray_tpu_torch.ops import geometry as G
from neuray_tpu_torch.ops import sampling as S
from neuray_tpu_torch.ops import sh as SH
from neuray_tpu_torch.ops.compositing import (
    alpha_values2hit_prob, composite_colors)
from neuray_tpu_torch.ops.interpolate import (
    grid_sample_nhwc, image_to_u8, interpolate_feature_map, quantize_u8)
from neuray_tpu_torch.parallel import sharding as P
from neuray_tpu_torch.utils import graphs
from neuray_tpu_torch.utils.profiling import count, span

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static renderer configuration, the same fields as the JAX
    package's ``RenderConfig``. ``NeurayRenderer`` raises
    ``NotImplementedError`` on a value this port does not run yet.
    ``gather_quant="u8"`` takes effect only with ``use_bf16``."""
    vis_encoder_type: str = "default"
    dist_decoder_type: str = "mixture_logistics"
    agg_net_type: str = "default"
    init_net_type: str = "depth"

    use_vis: bool = True
    fine_use_vis: bool = True
    neuray_dim: int = 32
    cost_volume_sn: int = 64
    init_diff_scale: int = 1

    use_hierarchical_sampling: bool = False
    fine_depth_sample_num: int = 64
    fine_depth_use_all: bool = False
    ray_batch_num: int = 2048
    depth_sample_num: int = 64
    alpha_value_ground_state: float = -15.0
    use_dr_prediction: bool = False
    use_nr_color_for_dr: bool = False
    use_self_hit_prob: bool = False
    use_ray_mask: bool = True
    ray_mask_view_num: int = 2
    ray_mask_point_num: int = 8
    render_depth: bool = False

    use_depth_loss: bool = False
    depth_loss_coords_num: int = 8192

    probe_sample_num: int = 16
    focus_sample_num: int = 16
    focus_fine_sample_num: int = 32
    focus_margin: int = 1
    focus_quantile: float = 0.005

    use_bf16: bool = False
    gather_quant: str = "none"

    @classmethod
    def from_cfg(cls, cfg: Dict[str, Any]) -> "RenderConfig":
        """Build from a reference-style flat cfg dict (a parsed YAML of
        ``configs/``); keys that name no field are ignored."""
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in cfg.items() if k in known}
        dd = cfg.get("dist_decoder_cfg", {}) or {}
        fdd = cfg.get("fine_dist_decoder_cfg", {}) or {}
        if "use_vis" in dd:
            kwargs["use_vis"] = dd["use_vis"]
        kwargs["fine_use_vis"] = fdd.get(
            "use_vis", kwargs.get("use_vis", True))
        inc = cfg.get("init_net_cfg", {}) or {}
        if "cost_volume_sn" in inc:
            kwargs["cost_volume_sn"] = inc["cost_volume_sn"]
        if "diff_scale" in inc:
            kwargs["init_diff_scale"] = inc["diff_scale"]
        return cls(**kwargs)


# values the port runs; anything else raises until its slice lands
# (``use_depth_loss`` changes no render: the depth-loss head runs where the
# trainer passes depth_loss_coords, as in the JAX package; init_net_type ""
# builds no init net, as finetuning's renderer has none)
_SUPPORTED = {
    "vis_encoder_type": ("default",),
    "dist_decoder_type": ("mixture_logistics",),
    "agg_net_type": ("default",),
    "init_net_type": ("depth", "cost_volume", ""),
}


def u8_map_supported(h: int, w: int, fh: int, fw: int) -> bool:
    """Whether the JAX package builds its u8 map for an (h, w) image with
    an (fh, fw) feature grid (its ``fused_map_supported``: the fused
    row's 7-pixel rgb patch must cover a feature cell's span). The port
    keeps its codes unpacked, which fit any size, but takes the same
    route so both packages quantize the same scenes; elsewhere the u8
    route falls back to bf16 maps."""
    ratio = max((w - 1) / fw, (h - 1) / fh)
    return 1.5 * ratio + 1.0 <= 7


class NeurayRenderer(nn.Module):
    """All submodules of the generalization renderer; submodule names
    follow the flax parameter tree (``utils.params.flax_to_torch``)."""

    def __init__(self, cfg: RenderConfig):
        super().__init__()
        for field, values in _SUPPORTED.items():
            if getattr(cfg, field) not in values:
                raise NotImplementedError(
                    f"RenderConfig.{field}={getattr(cfg, field)!r} is not "
                    f"ported yet (only {' or '.join(map(repr, values))})")
        self.cfg = cfg
        dt = torch.bfloat16 if cfg.use_bf16 else None
        self.image_encoder = ResUNetLight(3, (1, 2, 6, 4), 32, 16, dt)
        self.vis_encoder = DefaultVisEncoder(dt)
        self.dist_decoder = MixtureLogisticsDistDecoder(cfg.use_vis, dtype=dt)
        self.agg_net = DefaultAggregationNet(cfg.neuray_dim,
                                             cfg.depth_sample_num, dt)
        if cfg.use_hierarchical_sampling:
            self.fine_dist_decoder = MixtureLogisticsDistDecoder(
                cfg.fine_use_vis, dtype=dt)
            self.fine_agg_net = DefaultAggregationNet(
                cfg.neuray_dim, cfg.fine_depth_sample_num, dt)
        if cfg.init_net_type == "depth":
            self.init_net = DepthInitNet(cfg.init_diff_scale, dt)
        elif cfg.init_net_type == "cost_volume":
            self.init_net = CostVolumeInitNet(cfg.cost_volume_sn, dt)
        # the direct rendering's SH regularizers (a buffer, not a weight)
        self.register_buffer("sh_regs", torch.from_numpy(SH.sh_regs(3)),
                             persistent=False)

    # ---------------- per-scene stages ----------------

    def initialize_ray_feats(self, ref: Tensors, src: Tensors | None = None,
                             is_train: bool = False) -> torch.Tensor:
        """Init net: raw visibility features G' [rfn, h/4, w/4, 32]. The
        cost-volume init net needs the source views ``src`` (imgs,
        poses, Ks, depth_range) and ``ref["nn_ids"]`` [rfn, nn], indices
        into them; ``is_train`` skips its eval-time resize."""
        if not self.cfg.init_net_type:
            raise ValueError("this renderer has no init net "
                             "(init_net_type=''): its ray features are given")
        if self.cfg.init_net_type == "cost_volume":
            if src is None:
                raise ValueError("the cost-volume init net needs src views")
            return self.init_net(ref, src, is_train)
        return self.init_net(ref)

    def encode_scene(self, ref: Tensors, ray_feats_raw: torch.Tensor):
        """Image encoder + vis encoder -> (img_feats, ray_feats), each
        [rfn, h/4, w/4, 32] f32."""
        img_feats = self.image_encoder(ref["imgs"]).float()
        ray_feats = self.vis_encoder(ray_feats_raw, img_feats).float()
        return img_feats, ray_feats

    @staticmethod
    def build_gather_cache(ref: Tensors, use_bf16: bool = False,
                           gather_quant: str = "none") -> Tensors:
        """Add the maps the per-chunk gathers sample: ``feats``, the
        [rfn, fh, fw, 64] map [ray_feats | img_feats] sampled once per
        (point, view), and ``rgb_map``, the [rfn, h, w, 3] image.

        Three routes, as the JAX package's config selects them: f32 (the
        f32 map, the image itself); ``use_bf16`` (both in bf16); and
        ``use_bf16`` with ``gather_quant="u8"`` where
        ``u8_map_supported`` (else bf16): the bf16-rounded map quantized
        per channel (``quantize_u8``) and the image as 8-bit codes,
        with their f32 dequantization ``feats_scale``, ``feats_offset``
        [64] and ``rgb_scale``, ``rgb_offset`` [3].

        ray_feats and img_feats at different resolutions (maps encoded
        elsewhere: ``encode_scene``'s vis encoder takes them at one) make
        no packed map: the chunk gathers the f32 image and each f32 map on
        its own, three launches, as the JAX package does on every route."""
        ref = dict(ref)
        if ref["ray_feats"].shape[1:3] != ref["img_feats"].shape[1:3]:
            for k in ("ray_feats", "img_feats"):
                ref[k] = ref[k].float().contiguous()
            ref["rgb_map"] = ref["imgs"]
            return ref
        feats = torch.cat([ref["ray_feats"], ref["img_feats"]], dim=-1)
        imgs = ref["imgs"]
        if not use_bf16:
            ref["feats"], ref["rgb_map"] = feats.contiguous(), imgs
            return ref
        feats = feats.to(torch.bfloat16)
        if gather_quant == "u8" and u8_map_supported(
                *imgs.shape[1:3], *feats.shape[1:3]):
            codes, scale, offset = quantize_u8(feats)
            ref["feats"], ref["rgb_map"] = codes, image_to_u8(imgs)
            ref["feats_scale"], ref["feats_offset"] = (scale.float(),
                                                       offset.float())
            ref["rgb_scale"] = torch.full((3,), 1.0 / 255.0,
                                          device=imgs.device)
            ref["rgb_offset"] = torch.zeros(3, device=imgs.device)
        else:
            ref["feats"] = feats.contiguous()
            ref["rgb_map"] = imgs.to(torch.bfloat16)
        return ref

    # ---------------- per-chunk rendering ----------------

    def _project_and_gather(self, ref: Tensors, que_pts: torch.Tensor):
        """Project sample points [qn, rn, dn, 3] into every ref view and
        gather rgb (full res, align_corners=True) and the 64-ch feature
        map (1/4 res, align_corners=False), both border-padded, in the
        maps' dtype (bf16 from u8 maps); without the packed map (two
        resolutions, ``build_gather_cache``) ray_feats and img_feats one
        after the other."""
        qn, rn, dn, _ = que_pts.shape
        rfn, h, w, _ = ref["imgs"].shape
        pts = que_pts.reshape(qn * rn * dn, 3)
        prj_dir, prj_pts, prj_depth, prj_mask = G.project_points_ref_views(
            ref["poses"], ref["Ks"], h, w, pts)
        maskf = prj_mask.float()

        def dequant(name):
            return ((ref[name + "_scale"], ref[name + "_offset"])
                    if name + "_scale" in ref else None)

        prj_rgb = interpolate_feature_map(ref["rgb_map"], prj_pts, maskf, h,
                                          w, dequant("rgb"))
        if "feats" in ref:
            out = interpolate_feature_map(ref["feats"], prj_pts, maskf, h, w,
                                          dequant("feats"))
            nf = ref["ray_feats"].shape[-1]
            prj_ray, prj_img = out[..., :nf], out[..., nf:]
        else:
            prj_ray, prj_img = (
                interpolate_feature_map(ref[k], prj_pts, maskf, h, w)
                for k in ("ray_feats", "img_feats"))

        def rs(x):
            return x.reshape(rfn, qn, rn, dn, -1)

        return {"dir": rs(prj_dir), "depth": rs(prj_depth),
                "mask": rs(maskf), "rgb": rs(prj_rgb),
                "ray_feats": rs(prj_ray), "img_feats": rs(prj_img)}

    def _predict_proj_ray_prob(self, prj: Tensors,
                               ref_depth_range: torch.Tensor,
                               que_dists: torch.Tensor, is_fine: bool):
        decoder = self.fine_dist_decoder if is_fine else self.dist_decoder
        with span("dist_decoder"):
            mean, var, vis, aw = decoder(prj["ray_feats"])
            alpha, visibility, hit_prob = decoder.compute_prob(
                prj["depth"][..., 0], que_dists[None], mean, var, vis, aw,
                True, ref_depth_range)
        mask = prj["mask"]
        if self.cfg.use_dr_prediction:
            gs = self.cfg.alpha_value_ground_state
            prj["alpha"] = alpha[..., None] * mask + (1.0 - mask) * gs
        prj["vis"] = visibility[..., None] * mask
        prj["hit_prob"] = hit_prob[..., None] * mask
        return prj

    def _network_rendering(self, prj: Tensors, que_dir: torch.Tensor,
                           is_fine: bool, pos: torch.Tensor | None = None):
        agg = self.fine_agg_net if is_fine else self.agg_net
        with span("agg_net"):
            density, colors = agg(prj, que_dir, pos=pos)
        alpha = 1.0 - torch.exp(-F.relu(density))
        hit_prob = alpha_values2hit_prob(alpha)
        return hit_prob, colors, composite_colors(hit_prob, colors)

    def _direct_rendering(self, prj: Tensors, que_dir: torch.Tensor,
                          colors_nr: torch.Tensor):
        """The direct-rendering branch (reference renderer.py:85-125):
        each sample's alpha is the visibility-weighted mean of the views'
        decoded alphas (the ground state where no view sees it), its
        colour the network's (``use_nr_color_for_dr``) or an SH fit of
        the views' colours weighted by their hit probabilities, evaluated
        along the query direction (``ops/sh.py``, f32). Returns
        (hit_prob, colors, pixel_colors)."""
        c = self.cfg
        alpha = ((prj["vis"] * prj["alpha"]).sum(dim=0)
                 / (prj["vis"].sum(dim=0) + 1e-5))[..., 0]   # qn,rn,dn
        invalid = (prj["mask"][..., 0].sum(dim=0) == 0).to(alpha.dtype)
        alpha = alpha * (1.0 - invalid) + invalid * c.alpha_value_ground_state
        if c.use_nr_color_for_dr:
            colors = colors_nr
        else:
            rfn, qn, rn, dn, _ = prj["rgb"].shape
            pn = qn * rn * dn
            hit = prj["hit_prob"].reshape(rfn, pn)
            w = hit / (hit.sum(dim=0, keepdim=True) + 1e-3)
            theta = SH.sh_fit(prj["dir"].reshape(rfn, pn, 3).transpose(0, 1),
                              prj["rgb"].reshape(rfn, pn, 3).transpose(0, 1),
                              w.transpose(0, 1), regs=self.sh_regs)
            colors = SH.sh_predict(que_dir.reshape(pn, 1, 3), theta)
            colors = colors[:, 0].reshape(qn, rn, dn, 3)
        hit_prob = alpha_values2hit_prob(torch.sigmoid(alpha))
        return hit_prob, colors, composite_colors(hit_prob, colors)

    def _predict_self_hit_prob(self, que: Tensors, que_depth: torch.Tensor,
                               que_dists: torch.Tensor,
                               is_fine: bool) -> torch.Tensor:
        """The query view's own hit probability along its rays, from its
        own vis-encoded ray features (finetuning's consistency path):
        ``que["ray_feats"]`` [qn, fh, fw, f] sampled at the query coords of
        the (h, w) image ``que["imgs"]`` through the fused gather (one
        launch; its backward reaches the map), decoded by the coarse or
        fine dist decoder, then ``compute_prob`` at the query's own depths
        -> [qn, rn, dn]."""
        qn, rn, _ = que["coords"].shape
        h, w = que["imgs"].shape[1:3]
        mask = torch.ones((qn, rn), device=que["coords"].device)
        feats = interpolate_feature_map(que["ray_feats"].contiguous(),
                                        que["coords"].contiguous(), mask, h, w)
        decoder = self.fine_dist_decoder if is_fine else self.dist_decoder
        mean, var, vis, aw = decoder(feats)

        def expand(x):
            return None if x is None else x[:, :, None]

        _, _, hit_prob = decoder.compute_prob(
            que_depth, que_dists, expand(mean), expand(var), expand(vis),
            expand(aw), False, que["depth_range"])
        return hit_prob

    def _render_by_depth(self, que_depth: torch.Tensor, que: Tensors,
                         ref: Tensors, is_fine: bool,
                         pos: torch.Tensor | None = None,
                         is_train: bool = False) -> Tensors:
        """One pass at the given depths [qn, rn, dn]; ``pos`` [qn, rn, dn]
        gives the focused render's attention positions. ``colors_nr``,
        the per-sample radiance [qn, rn, dn, 3], is in the outputs because
        the agg net computes it anyway; the chunk loops keep it only when
        asked (``estimate_window_clip`` reads it). In training with
        ``use_self_hit_prob`` the outputs carry ``hit_prob_self``
        (``_predict_self_hit_prob``; que then holds ``ray_feats``)."""
        with span("pass"):
            c = self.cfg
            que_dists = S.depth2inv_dists(que_depth, que["depth_range"])
            que_pts, que_dir = G.depth2points(
                que["coords"], que["poses"], que["Ks"], que_depth)
            prj = self._project_and_gather(ref, que_pts)
            prj = self._predict_proj_ray_prob(
                prj, ref["depth_range"], que_dists, is_fine)
            hit_prob_nr, colors_nr, pixel_colors_nr = self._network_rendering(
                prj, que_dir, is_fine, pos)
            outputs = {"pixel_colors_nr": pixel_colors_nr,
                       "hit_prob_nr": hit_prob_nr, "colors_nr": colors_nr}
            if c.use_dr_prediction:
                hit_prob_dr, _, pixel_colors_dr = self._direct_rendering(
                    prj, que_dir, colors_nr)
                outputs["pixel_colors_dr"] = pixel_colors_dr
                outputs["hit_prob_dr"] = hit_prob_dr
            if is_train and c.use_self_hit_prob:
                outputs["hit_prob_self"] = self._predict_self_hit_prob(
                    que, que_depth, que_dists, is_fine)
            if que.get("imgs") is not None:
                outputs["pixel_colors_gt"] = grid_sample_nhwc(
                    que["imgs"], que["coords"], align_corners=True)
            if c.use_ray_mask:
                # qn, rn, dn, 1
                rm = prj["mask"].sum(dim=0) > c.ray_mask_view_num
                outputs["ray_mask"] = (
                    rm.sum(dim=2) > c.ray_mask_point_num)[..., 0]
            if c.render_depth:
                outputs["render_depth"] = (hit_prob_nr * que_depth).sum(dim=-1)
            return outputs

    def _fine_depth(self, que_depth: torch.Tensor, hit_prob: torch.Tensor,
                    depth_range: torch.Tensor, fdn: int,
                    u: torch.Tensor | None = None) -> torch.Tensor:
        """fdn depths resampled from the coarse hit_prob (eval: at
        stratified u, monotone, no sort; training: at the random ``u``,
        sorted), merged with the coarse ones under fine_depth_use_all."""
        fine_depth = S.sample_fine_depth(que_depth, hit_prob, depth_range, fdn,
                                         u)
        if self.cfg.fine_depth_use_all:
            fine_depth = torch.sort(
                torch.cat([que_depth, fine_depth], dim=-1), dim=-1).values
        elif u is not None:
            fine_depth = torch.sort(fine_depth, dim=-1).values
        return fine_depth

    @staticmethod
    def draw_fine_u(shape, device: torch.device,
                    generator: torch.Generator | None) -> torch.Tensor:
        """The fine sampler's training draws, uniform in [0, 1), made on
        the generator's device (the default generator's: the CPU) and
        moved to ``device``: a CPU generator gives the same draws to a
        run on the card and one on the CPU."""
        gen_device = generator.device if generator is not None else "cpu"
        return torch.rand(shape, generator=generator,
                          device=gen_device).to(device)

    @staticmethod
    def _add_fine(outputs: Tensors, fine_out: Tensors) -> Tensors:
        for k, v in fine_out.items():
            outputs[k + "_fine"] = v
        return outputs

    def render_chunk(self, ref: Tensors, que: Tensors, is_train: bool = False,
                     generator: torch.Generator | None = None,
                     fine_u: torch.Tensor | None = None) -> Tensors:
        """Coarse + (optionally) fine render of one ray chunk. The coarse
        depths are deterministic in both modes (as in the JAX trainer);
        the fine ones are resampled from the detached coarse hit_prob at
        fixed u (eval) or at u drawn from ``generator`` and sorted
        (``is_train``, which also adds the self-hit outputs where
        configured). ``fine_u`` [qn, rn, fine_depth_sample_num]: training
        draws made by the caller (a rank's slice of a sharded batch's)."""
        c = self.cfg
        qn, rn, _ = que["coords"].shape
        que_depth, _ = S.sample_depth(que["depth_range"], qn, rn,
                                      c.depth_sample_num)
        outputs = self._render_by_depth(que_depth, que, ref, False, None,
                                        is_train)
        if c.use_hierarchical_sampling:
            u = None
            if is_train:
                u = (fine_u if fine_u is not None else self.draw_fine_u(
                    (qn, rn, c.fine_depth_sample_num), que_depth.device,
                    generator))
            fine_depth = self._fine_depth(
                que_depth, outputs["hit_prob_nr"].detach(),
                que["depth_range"], c.fine_depth_sample_num, u)
            self._add_fine(outputs, self._render_by_depth(
                fine_depth, que, ref, True, None, is_train))
        return outputs

    def render_chunk_fine(self, ref: Tensors, que: Tensors,
                          hit_prob_nr: torch.Tensor) -> Tensors:
        """The fine pass alone, from a known coarse hit_prob [qn, rn, dn]:
        the fine half of ``render_chunk`` (the coarse depths are
        recomputed). Outputs carry the ``_fine`` suffix."""
        c = self.cfg
        qn, rn, _ = que["coords"].shape
        que_depth, _ = S.sample_depth(que["depth_range"], qn, rn,
                                      c.depth_sample_num)
        fine_depth = self._fine_depth(que_depth, hit_prob_nr,
                                      que["depth_range"],
                                      c.fine_depth_sample_num)
        return self._add_fine({}, self._render_by_depth(
            fine_depth, que, ref, True))

    # ---------------- training ----------------

    def predict_mean_for_depth_loss(self, ray_feats: torch.Tensor,
                                    coords: torch.Tensor, h: int,
                                    w: int) -> Tensors:
        """The depth-loss head: the dist decoders' means at pixels coords
        [rfn, pn, 2] of the (h, w) reference images, sampled from
        ray_feats [rfn, fh, fw, f]. Returns ``depth_mean``,
        ``depth_mean_2`` (and ``_fine`` twins), each [rfn, pn]."""
        mask = torch.ones(coords.shape[:2], device=coords.device)
        feats = interpolate_feature_map(ray_feats.contiguous(),
                                        coords.contiguous(), mask, h, w)
        mean = self.dist_decoder.predict_mean(feats)
        outputs = {"depth_mean": mean[..., 0], "depth_mean_2": mean[..., 1]}
        if self.cfg.use_hierarchical_sampling:
            mean_fine = self.fine_dist_decoder.predict_mean(feats)
            outputs["depth_mean_fine"] = mean_fine[..., 0]
            outputs["depth_mean_fine_2"] = mean_fine[..., 1]
        return outputs

    def forward(self, ref: Tensors, que: Tensors, is_train: bool = True,
                depth_loss_coords: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                src: Tensors | None = None) -> Tensors:
        """The training forward on one ray chunk, with autograd: init net
        (on ``src`` too for the cost volume; MVSNet takes no gradient) ->
        image and vis encoders -> gather maps -> ``render_chunk`` (fine
        draws from ``generator``), and with ``depth_loss_coords`` [rfn,
        pn, 2] the depth-loss head. ``que`` carries ``imgs`` for
        ``pixel_colors_gt``. f32 only: the bf16 route's weight copies are
        detached (``blocks.ComputeCast``)."""
        if self.cfg.use_bf16 and is_train:
            raise NotImplementedError("training runs in f32 only "
                                      "(RenderConfig.use_bf16=True)")
        ray_feats_raw = self.initialize_ray_feats(ref, src, is_train)
        img_feats, ray_feats = self.encode_scene(ref, ray_feats_raw)
        ref_c = self.build_gather_cache(
            dict(ref, img_feats=img_feats, ray_feats=ray_feats))
        outputs = self.render_chunk(ref_c, que, is_train, generator)
        if depth_loss_coords is not None:
            h, w = ref["imgs"].shape[1:3]
            outputs.update(self.predict_mean_for_depth_loss(
                ray_feats, depth_loss_coords, h, w))
            outputs["depth_coords"] = depth_loss_coords
        return outputs

    def _probe_hit_prob(self, ref: Tensors, que: Tensors):
        """The coarse network pass at ``probe_sample_num`` samples, its
        attention positions strided to those of the full coarse grid
        (probe sample j sits where full coarse sample j*stride does).
        Returns (que_depth, hit_prob), each [qn, rn, probe_sample_num].

        The score must come from the agg net: a single view's decoded
        hit mass sums to ~1 along any ray, so only the cross-view
        aggregate separates empty rays from occupied ones."""
        c = self.cfg
        qn, rn, _ = que["coords"].shape
        que_depth, _ = S.sample_depth(que["depth_range"], qn, rn,
                                      c.probe_sample_num)
        que_dists = S.depth2inv_dists(que_depth, que["depth_range"])
        que_pts, que_dir = G.depth2points(
            que["coords"], que["poses"], que["Ks"], que_depth)
        prj = self._project_and_gather(ref, que_pts)
        prj = self._predict_proj_ray_prob(
            prj, ref["depth_range"], que_dists, False)
        stride = max(1, c.depth_sample_num // c.probe_sample_num)
        density, _ = self.agg_net(prj, que_dir, pos_stride=stride)
        return que_depth, alpha_values2hit_prob(
            1.0 - torch.exp(-F.relu(density)))

    def probe_chunk(self, ref: Tensors, que: Tensors) -> torch.Tensor:
        """Per-ray emptiness score [qn, rn]: the probe's aggregated hit
        probability summed over its samples."""
        return self._probe_hit_prob(ref, que)[1].sum(dim=-1)

    def probe_chunk_focus(self, ref: Tensors, que: Tensors):
        """The probe's score and each ray's depth window: the probe
        samples where the cumulative hit fraction first reaches q and
        1 - q (q = focus_quantile), widened by ``focus_margin`` samples
        on each side. Rays with score <= 1e-3 keep the full range, so
        focused sampling falls back to strided full-range sampling.

        Returns (score, near, far), each [qn, rn].
        """
        c = self.cfg
        que_depth, hit_prob = self._probe_hit_prob(ref, que)
        hit_prob = hit_prob.float()   # bf16 compute: score and windows in f32
        score = hit_prob.sum(dim=-1)
        frac = torch.cumsum(hit_prob, dim=-1) / (score[..., None] + 1e-12)
        q, pn = c.focus_quantile, c.probe_sample_num
        # argmax returns the first maximum: the first sample >= q (0 if none)
        lo = torch.argmax((frac >= q).to(torch.uint8), dim=-1)
        hi = torch.argmax((frac >= 1.0 - q).to(torch.uint8), dim=-1)
        lo = (lo - c.focus_margin).clamp(0, pn - 1)
        hi = (hi + c.focus_margin).clamp(0, pn - 1)
        near = torch.gather(que_depth, -1, lo[..., None])[..., 0]
        far = torch.gather(que_depth, -1, hi[..., None])[..., 0]
        dr = que["depth_range"]
        confident = score > 1e-3
        near = torch.where(confident, near, dr[:, 0:1].expand_as(near))
        far = torch.where(confident & (far > near), far,
                          dr[:, 1:2].expand_as(far))
        return score, near, far

    def focus_depths(self, que: Tensors, near: torch.Tensor,
                     far: torch.Tensor):
        """The focused coarse pass's depths [qn, rn, focus_sample_num],
        uniform in inverse depth across each ray's [near, far], and their
        fractional positions in the full coarse grid: the attention sees
        where each sample sits geometrically, the position distribution
        it was trained on."""
        c = self.cfg
        que_depth, _ = S.sample_depth_ranged(near, far, c.focus_sample_num)
        dr = que["depth_range"]
        inv_lo = (-1.0 / dr[:, 0])[:, None, None]
        inv_hi = (-1.0 / dr[:, 1])[:, None, None]
        t = (-1.0 / que_depth - inv_lo) / (inv_hi - inv_lo)
        return que_depth, t * (c.depth_sample_num - 1)

    def focus_fine_depths(self, que: Tensors, que_depth: torch.Tensor,
                          hit_prob: torch.Tensor):
        """The focused fine pass's depths, resampled from the focused
        coarse hit_prob, and their rank-scaled positions: spread evenly
        over the full fine grid's (fine positions are ranks in training,
        the surface sits mid-table wherever its depth is)."""
        c = self.cfg
        fine_depth = self._fine_depth(que_depth, hit_prob,
                                      que["depth_range"],
                                      c.focus_fine_sample_num)
        qn, rn, nf = fine_depth.shape
        nf_full = c.fine_depth_sample_num + (
            c.depth_sample_num if c.fine_depth_use_all else 0)
        pos = torch.linspace(0.0, float(nf_full - 1), nf,
                             device=fine_depth.device)
        return fine_depth, pos.expand(qn, rn, nf)

    def render_chunk_focus(self, ref: Tensors, que: Tensors,
                           near: torch.Tensor, far: torch.Tensor) -> Tensors:
        """Coarse + fine render of one chunk inside per-ray depth windows
        near, far [qn, rn]: ``focus_sample_num`` coarse and
        ``focus_fine_sample_num`` fine samples (``focus_depths``,
        ``focus_fine_depths``)."""
        que_depth, pos_c = self.focus_depths(que, near, far)
        outputs = self._render_by_depth(que_depth, que, ref, False, pos_c)
        if self.cfg.use_hierarchical_sampling:
            fine_depth, pos_f = self.focus_fine_depths(
                que, que_depth, outputs["hit_prob_nr"])
            self._add_fine(outputs, self._render_by_depth(
                fine_depth, que, ref, True, pos_f))
        return outputs


def chunk_coords(coords: torch.Tensor, chunk: int):
    """Pad per-ray [qn, rn, ...] (the coords [qn, rn, 2], or any tensor
    chunked alongside them) to a multiple of ``chunk`` by repeating the
    last ray and split into [n_chunks, qn, chunk, ...]. Returns (chunks,
    valid_rn)."""
    qn, rn = coords.shape[:2]
    n_chunks = -(-rn // chunk)
    pad = n_chunks * chunk - rn
    if pad:
        coords = torch.cat(
            [coords, coords[:, -1:].expand(qn, pad, *coords.shape[2:])], 1)
    return (coords.reshape(qn, n_chunks, chunk, *coords.shape[2:])
            .transpose(0, 1), rn)


DEFAULT_KEEP = ("pixel_colors_nr", "pixel_colors_nr_fine",
                "pixel_colors_dr", "pixel_colors_dr_fine",
                "render_depth", "render_depth_fine", "ray_mask")


@torch.inference_mode()
def encode_ref(renderer: NeurayRenderer, ref: Tensors,
               src: Tensors | None = None) -> Tensors:
    """Scene encode: ref dict (and for the cost-volume init net its src
    views) -> the ref dict plus img_feats, ray_feats and the packed
    gather map ``feats``."""
    ray_feats_raw = renderer.initialize_ray_feats(ref, src)
    img_feats, ray_feats = renderer.encode_scene(ref, ray_feats_raw)
    ref_c = dict(ref)
    ref_c["img_feats"] = img_feats
    ref_c["ray_feats"] = ray_feats
    return renderer.build_gather_cache(ref_c, renderer.cfg.use_bf16,
                                       renderer.cfg.gather_quant)


# ---------------- chunk loops ----------------

@torch.inference_mode()
def _chunk_loop(step: Callable[..., Tensors], que: Tensors, chunk: int,
                rows: Tuple[torch.Tensor, ...] = (), mesh=None) -> Tensors:
    """Run ``step(que_chunk, *row_chunks) -> {key: [qn, chunk, ...]}`` over
    ``chunk``-ray chunks of que's rays; ``rows`` are per-ray tensors
    [qn, rn, ...] chunked alongside the coords. The last chunk is padded
    with copies of the last ray, whose outputs are cut off. Returns each
    key concatenated over the chunks, [qn, rn, ...]. On a ``mesh`` of
    more than one rank, over this rank's part of the rays, and the parts
    gathered (``parallel.sharding.shard_rays``)."""
    if mesh is not None and mesh.size > 1:
        return P.shard_rays(lambda q, *r: _chunk_loop(step, q, chunk, r),
                            que, mesh, chunk, rows)
    rn = que["coords"].shape[1]
    parts: Dict[str, list] = {}
    for coords, *row in zip(*(chunk_coords(x, chunk)[0]
                              for x in (que["coords"], *rows))):
        for k, v in step(dict(que, coords=coords), *row).items():
            parts.setdefault(k, []).append(v)
    return {k: torch.cat(v, dim=1)[:, :rn] for k, v in parts.items()}


def _keep(out: Tensors, keep_keys: Iterable[str]) -> Tensors:
    return {k: v for k, v in out.items() if k in keep_keys}


# ---------------- the exact chunk from CUDA graphs ----------------

def _graphable(ref_c: Tensors, que: Tensors) -> bool:
    """Whether ``render_rays``' chunk may come from CUDA graphs: no
    autograd (inference mode, grad off) and every value of the scene and
    the query a tensor on the coords' CUDA device, or None."""
    dev = que["coords"].device
    return (dev.type == "cuda" and torch.is_inference_mode_enabled()
            and not torch.is_grad_enabled()
            and all(v is None or (isinstance(v, torch.Tensor)
                                  and v.device == dev)
                    for d in (ref_c, que) for v in d.values()))


def _graph_key(renderer: NeurayRenderer, ref_c: Tensors, que: Tensors):
    """What a captured chunk holds fixed beyond its inputs' values: the
    chunk's shape (``que`` is a chunk), each scene and query key with its
    tensor's shape and dtype (or None) and the first key it aliases, and
    each parameter's and buffer's address and version (a replaced weight
    moves the address; an in-place write bumps the version and so renews
    the bf16 route's cached casts, ``blocks.ComputeCast``)."""
    first: Dict[int, tuple] = {}

    def meta(i, d):
        return tuple((k, None) if v is None else
                     (k, tuple(v.shape), v.dtype,
                      first.setdefault(id(v), (i, k)))
                     for k, v in sorted(d.items()))

    state = tuple((t.data_ptr(), None if t.is_inference() else t._version)
                  for t in (*renderer.parameters(), *renderer.buffers()))
    return meta(0, ref_c), meta(1, que), state


class _ChunkGraph:
    """``render_chunk`` recorded for one key (``_graph_key``): static
    copies of a scene and a query chunk, and the outputs the graphs
    write (``utils/graphs.py``)."""

    def __init__(self, key, ref_c: Tensors, que: Tensors):
        self.key = key
        clones: Dict[int, torch.Tensor] = {}

        def static(d):
            for v in d.values():
                if v is not None and id(v) not in clones:
                    clones[id(v)] = v.clone()
            return {k: None if v is None else clones[id(v)]
                    for k, v in d.items()}

        self.ref, self.que = static(ref_c), static(que)
        self.graph = self.out = None

    def stage(self, ref_c: Tensors, que: Tensors) -> None:
        """Copy a frame's scene and query into the static copies."""
        seen = set()
        for static, d in ((self.ref, ref_c), (self.que, que)):
            for k, v in d.items():
                if v is not None and id(v) not in seen:
                    seen.add(id(v))
                    static[k].copy_(v)

    def run(self, renderer: NeurayRenderer, que: Tensors, keep,
            passes: int) -> Tensors:
        """The chunk's kept outputs: at the first chunk from an eager run,
        then captured; after that from a replay, copied out."""
        self.que["coords"].copy_(que["coords"])
        if self.graph is None:
            graph = graphs.SegmentedGraph()
            out, self.out = graph.record(
                lambda: renderer.render_chunk(self.ref, self.que))
            self.graph = graph
            count("render.eager_passes", passes)
            return _keep(out, keep)
        self.graph.replay()
        count("render.graph_passes", passes)
        return {k: v.clone() for k, v in _keep(self.out, keep).items()}


# each renderer's chunk recorded in CUDA graphs, for the last key it
# rendered; held beside the renderer, so that a copy of it (``copy.copy``,
# ``copy.deepcopy``) records its own
_GRAPHS: "weakref.WeakKeyDictionary[NeurayRenderer, _ChunkGraph]" = (
    weakref.WeakKeyDictionary())


def _chunk_graph(renderer: NeurayRenderer, ref_c: Tensors,
                 que: Tensors) -> "_ChunkGraph | None":
    """The renderer's ``_ChunkGraph`` for this scene and chunk, staged
    with them, recorded anew where the key changed; None where the chunk
    runs eagerly (``_graphable``)."""
    if not _graphable(ref_c, que):
        return None
    key = _graph_key(renderer, ref_c, que)
    entry = _GRAPHS.get(renderer)
    if entry is not None and entry.key == key:
        entry.stage(ref_c, que)
        return entry
    _GRAPHS.pop(renderer, None)     # its copies and pool go first
    entry = _GRAPHS[renderer] = _ChunkGraph(key, ref_c, que)
    return entry


class _ExactStep:
    """``render_rays``' chunk step. At its first chunk it takes the
    renderer's recorded chunk (``_chunk_graph``) or, where the chunk may
    not come from graphs, the eager ``render_chunk``; it counts the
    passes of each chunk as ``render.graph_passes`` (replayed) or
    ``render.eager_passes``."""

    def __init__(self, renderer: NeurayRenderer, ref_c: Tensors, keep):
        self.renderer, self.ref_c, self.keep = renderer, ref_c, keep
        self.passes = 1 + renderer.cfg.use_hierarchical_sampling
        self.graph, self.started = None, False

    def __call__(self, que: Tensors) -> Tensors:
        if not self.started:
            self.started = True
            self.graph = _chunk_graph(self.renderer, self.ref_c, que)
        if self.graph is not None:
            return self.graph.run(self.renderer, que, self.keep, self.passes)
        count("render.eager_passes", self.passes)
        return _keep(self.renderer.render_chunk(self.ref_c, que), self.keep)


def render_rays(renderer: NeurayRenderer, ref_c: Tensors, que: Tensors,
                keep_keys: Iterable[str] = DEFAULT_KEEP,
                mesh=None) -> Tensors:
    """Chunked ray loop over an encoded ref (from ``encode_ref``):
    renders ``ray_batch_num`` rays at a time and returns the kept
    outputs, each [qn, rn, ...]. ``mesh`` (here and in the other ray
    loops): shard the rays over its ranks (``_chunk_loop``). On CUDA,
    without autograd, a chunk is a replay of CUDA graphs cut at its spans
    (``_ExactStep``): the renderer's first chunk of a key runs eagerly and
    is recorded, and the renderer keeps the recording until the key
    changes."""
    return _chunk_loop(_ExactStep(renderer, ref_c, frozenset(keep_keys)),
                       que, renderer.cfg.ray_batch_num, mesh=mesh)


def render_full(renderer: NeurayRenderer, ref: Tensors, que: Tensors,
                keep_keys: Iterable[str] = DEFAULT_KEEP,
                src: Tensors | None = None) -> Tensors:
    """Scene encode (with ``src`` for the cost-volume init net) + the
    chunked ray loop."""
    return render_rays(renderer, encode_ref(renderer, ref, src), que,
                       keep_keys)


def render_coarse_rays(renderer: NeurayRenderer, ref_c: Tensors, que: Tensors,
                       keep_keys=("pixel_colors_nr", "hit_prob_nr"),
                       mesh=None) -> Tensors:
    """The coarse pass alone over que's rays (the exact gate of the
    two-phase render and of the audits)."""
    c = renderer.cfg

    def step(q):
        qn, rn, _ = q["coords"].shape
        depth, _ = S.sample_depth(q["depth_range"], qn, rn,
                                  c.depth_sample_num)
        return _keep(renderer._render_by_depth(depth, q, ref_c, False),
                     keep_keys)

    return _chunk_loop(step, que, c.ray_batch_num, mesh=mesh)


def render_fine_rays(renderer: NeurayRenderer, ref_c: Tensors, que: Tensors,
                     hit_prob: torch.Tensor,
                     keep_keys=("pixel_colors_nr_fine",),
                     mesh=None) -> Tensors:
    """The fine pass alone over que's rays, from their coarse hit_prob
    [qn, rn, dn]."""
    return _chunk_loop(
        lambda q, hp: _keep(renderer.render_chunk_fine(ref_c, q, hp),
                            keep_keys),
        que, renderer.cfg.ray_batch_num, (hit_prob,), mesh)


def probe_rays(renderer: NeurayRenderer, ref_c: Tensors,
               que: Tensors, mesh=None) -> torch.Tensor:
    """The probe's per-ray score [qn, rn] over que's rays."""
    return _chunk_loop(lambda q: {"score": renderer.probe_chunk(ref_c, q)},
                       que, renderer.cfg.ray_batch_num, mesh=mesh)["score"]


def focus_probe_rays(renderer: NeurayRenderer, ref_c: Tensors, que: Tensors,
                     mesh=None):
    """The focus probe over que's rays: (score, near, far), each [qn, rn]."""
    out = _chunk_loop(
        lambda q: dict(zip(("score", "near", "far"),
                           renderer.probe_chunk_focus(ref_c, q))),
        que, renderer.cfg.ray_batch_num, mesh=mesh)
    return out["score"], out["near"], out["far"]


def render_focus_rays(renderer: NeurayRenderer, ref_c: Tensors, que: Tensors,
                      near: torch.Tensor, far: torch.Tensor,
                      keep_keys: Iterable[str] = DEFAULT_KEEP,
                      mesh=None) -> Tensors:
    """The focused coarse + fine render over que's rays inside their
    windows near, far [qn, rn]."""
    keep = set(keep_keys)
    return _chunk_loop(
        lambda q, n, f: _keep(renderer.render_chunk_focus(ref_c, q, n, f),
                              keep),
        que, renderer.cfg.ray_batch_num, (near, far), mesh)


# ---------------- host helpers ----------------

def _host(x) -> np.ndarray:
    """A tensor on any device, or an array, as a numpy array (bf16 as
    f32, which holds every bf16 value)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def _take_rays(que: Tensors, idx: np.ndarray) -> Tensors:
    """que restricted to the rays idx [k] (numpy indices)."""
    coords = que["coords"]
    return dict(que, coords=coords[:, torch.from_numpy(idx).to(coords.device)])


def _with_probe_sample_num(renderer: NeurayRenderer,
                           psn: int) -> NeurayRenderer:
    """The renderer with ``probe_sample_num`` = psn: a shallow copy that
    shares every submodule and parameter (no weights copied or loaded)
    under the replaced config."""
    if psn == renderer.cfg.probe_sample_num:
        return renderer
    r = copy.copy(renderer)
    r.cfg = dataclasses.replace(renderer.cfg, probe_sample_num=psn)
    return r


def _check_frame(renderer: NeurayRenderer, que: Tensors) -> None:
    if not renderer.cfg.use_hierarchical_sampling:
        raise ValueError("the frame drivers need use_hierarchical_sampling")
    if que["coords"].shape[0] != 1:
        raise ValueError("the frame drivers take one query view")


def _dilate_keep_mask(keep_mask: np.ndarray, image_hw, dilate: int):
    """Iterated 8-neighbour (3x3 max) dilation of a row-major full-image
    keep mask. keep_mask [rn] bool -> [rn] bool."""
    h, w = image_hw
    m = keep_mask.reshape(h, w)
    for _ in range(dilate):
        g = m.copy()
        g[1:] |= m[:-1]
        g[:-1] |= m[1:]
        g[:, 1:] |= m[:, :-1]
        g[:, :-1] |= m[:, 1:]
        g[1:, 1:] |= m[:-1, :-1]
        g[1:, :-1] |= m[:-1, 1:]
        g[:-1, 1:] |= m[1:, :-1]
        g[:-1, :-1] |= m[1:, 1:]
        m = g
    return m.reshape(-1)


def _strided_focus_probe(renderer: NeurayRenderer, ref_c: Tensors,
                         que: Tensors, threshold: float, image_hw,
                         stride: int, mesh=None):
    """Run the focus probe on every stride-th pixel in x and y and give
    the full-resolution rays conservative windows: 3x3 min(near) /
    max(far) pooling and a 1-pixel keep dilation at probe resolution,
    then nearest upsampling. Returns (keep_mask [rn] bool, near [1, rn],
    far [1, rn]) as numpy arrays."""
    h, w = image_hw
    ys, xs = np.arange(0, h, stride), np.arange(0, w, stride)
    hs, ws = ys.size, xs.size
    sub_idx = (ys[:, None] * w + xs[None, :]).reshape(-1)
    score, near, far = (
        _host(x).astype(np.float32)[0].reshape(hs, ws)
        for x in focus_probe_rays(renderer, ref_c, _take_rays(que, sub_idx),
                                  mesh))

    def pool3(a, op):
        p = np.pad(a, 1, mode="edge")
        return op(np.stack([p[i:i + hs, j:j + ws]
                            for i in range(3) for j in range(3)]), axis=0)

    keep_s = _dilate_keep_mask((score > threshold).reshape(-1), (hs, ws), 1)
    yi = np.minimum(np.arange(h) // stride, hs - 1)[:, None]
    xi = np.minimum(np.arange(w) // stride, ws - 1)[None, :]
    return (keep_s.reshape(hs, ws)[yi, xi].reshape(-1),
            pool3(near, np.min)[yi, xi].reshape(1, -1),
            pool3(far, np.max)[yi, xi].reshape(1, -1))


def _merge_kept_outputs(keep_base, kept_out, keep, keep_mask, qn, rn):
    """Scatter kept-ray outputs into full-frame numpy arrays, zeros on
    skipped rays. With nothing kept the trailing shape of each key comes
    from a name map (render_depth per ray, the rest 3-channel)."""
    out = {"kept_rays": int(keep.size), "keep_mask": keep_mask}
    tails = {"render_depth": ()}
    for k in keep_base:
        for suffix in ("", "_fine"):
            if kept_out is not None:
                vals = _host(kept_out[k + suffix]).astype(np.float32)
                full = np.zeros((qn, rn) + vals.shape[2:], np.float32)
                full[0, keep] = vals[0]
            else:
                full = np.zeros((qn, rn) + tails.get(k, (3,)), np.float32)
            out[k + suffix] = full
    return out


# ---------------- frame drivers ----------------

def render_frame_probe_focus(renderer: NeurayRenderer, ref_c: Tensors,
                             que: Tensors, threshold: float = 0.005,
                             keep_base=("pixel_colors_nr",), image_hw=None,
                             dilate: int = 0, probe_out=None,
                             probe_stride: int = 1, mesh=None):
    """Three-phase render with focused sampling: the focus probe scores
    every ray and narrows its depth window; the rays scoring above
    ``threshold`` render coarse + fine at focus_sample_num /
    focus_fine_sample_num samples inside their windows; skipped rays are
    0. Kept rays are sampled denser across their surface interval at
    fewer samples, so they are not the full render's values.

    image_hw=(h, w) (row-major full-image rays) with dilate=d grows the
    keep mask by d pixels. probe_stride > 1 (needs image_hw) probes every
    stride-th pixel in x and y, stride^2 fewer probe rays, with
    conservative windows (``_strided_focus_probe``). probe_out: a probe
    result to reuse (``render_frame_probe_auto``): (score, near, far)
    tensors from ``focus_probe_rays`` at probe_stride 1, the (keep_mask,
    near, far) arrays of ``_strided_focus_probe`` above it. mesh: see the
    module's doc.

    Returns, per key k of keep_base, ``k`` and ``k + "_fine"`` [1, rn, ...]
    numpy arrays, plus ``kept_rays`` and ``keep_mask``.
    """
    _check_frame(renderer, que)
    keep_base = tuple(keep_base)
    keep_keys = keep_base + tuple(k + "_fine" for k in keep_base)
    qn, rn, _ = que["coords"].shape
    if probe_stride > 1:
        if image_hw is None:
            raise ValueError("probe_stride > 1 needs image_hw")
        keep_mask, near, far = (
            probe_out if probe_out is not None
            else _strided_focus_probe(renderer, ref_c, que, threshold,
                                      image_hw, probe_stride, mesh))
    else:
        score, near, far = (
            probe_out if probe_out is not None
            else focus_probe_rays(renderer, ref_c, que, mesh))
        keep_mask = _host(score)[0] > threshold
    if dilate > 0 and image_hw is not None:
        keep_mask = _dilate_keep_mask(keep_mask, image_hw, dilate)
    keep = np.nonzero(keep_mask)[0]
    kept_out = None
    if keep.size:
        que_k = _take_rays(que, keep)
        idx = torch.from_numpy(keep).to(que["coords"].device)
        near_k, far_k = (torch.as_tensor(x, device=idx.device)[:, idx]
                         for x in (near, far))
        kept_out = render_focus_rays(renderer, ref_c, que_k, near_k, far_k,
                                     keep_keys, mesh)
    return _merge_kept_outputs(keep_base, kept_out, keep, keep_mask, qn, rn)


def render_frame_probe_skip(renderer: NeurayRenderer, ref_c: Tensors,
                            que: Tensors, threshold: float = 0.005,
                            keep_base=("pixel_colors_nr",), image_hw=None,
                            dilate: int = 0, probe_out=None, mesh=None):
    """Three-phase render: the probe scores every ray, the exact coarse +
    fine render runs only on the rays scoring above ``threshold``, and
    skipped rays are 0 (compositing has no background term). Kept rays
    get the full render's values. image_hw and dilate grow the keep mask
    as in ``render_frame_probe_focus``; probe_out: a ``probe_rays``
    score to reuse; mesh: see the module's doc. Returns what
    ``render_frame_probe_focus`` returns."""
    _check_frame(renderer, que)
    keep_base = tuple(keep_base)
    keep_keys = keep_base + tuple(k + "_fine" for k in keep_base)
    qn, rn, _ = que["coords"].shape
    score = _host(probe_out if probe_out is not None
                  else probe_rays(renderer, ref_c, que, mesh))
    keep_mask = score[0] > threshold
    if dilate > 0 and image_hw is not None:
        keep_mask = _dilate_keep_mask(keep_mask, image_hw, dilate)
    keep = np.nonzero(keep_mask)[0]
    kept_out = (render_rays(renderer, ref_c, _take_rays(que, keep),
                            keep_keys, mesh) if keep.size else None)
    return _merge_kept_outputs(keep_base, kept_out, keep, keep_mask, qn, rn)


def render_frame_skip_empty(renderer: NeurayRenderer, ref_c: Tensors,
                            que: Tensors, threshold: float = 0.02,
                            keep_base=("pixel_colors_nr",), mesh=None):
    """Two-phase render: the exact coarse pass on every ray, then the fine
    pass only on rays whose coarse hit mass exceeds ``threshold``; the
    other rays' fine output is their coarse output. Kept rays get the
    full render's values. mesh: see the module's doc.

    Returns, per key k of keep_base, ``k`` (coarse) and ``k + "_fine"``
    [1, rn, ...] numpy arrays, plus ``kept_rays`` and ``keep_mask``.
    """
    _check_frame(renderer, que)
    keep_base = tuple(keep_base)
    coarse = render_coarse_rays(renderer, ref_c, que,
                                keep_base + ("hit_prob_nr",), mesh)
    hit_prob = coarse["hit_prob_nr"]
    keep_mask = _host(hit_prob.sum(dim=-1))[0] > threshold
    keep = np.nonzero(keep_mask)[0]
    fine = None
    if keep.size:
        idx = torch.from_numpy(keep).to(hit_prob.device)
        fine = render_fine_rays(renderer, ref_c, _take_rays(que, keep),
                                hit_prob[:, idx],
                                tuple(k + "_fine" for k in keep_base), mesh)
    out = {"kept_rays": int(keep.size), "keep_mask": keep_mask}
    for k in keep_base:
        base = _host(coarse[k]).astype(np.float32)
        merged = base.copy()
        if fine is not None:
            merged[0, keep] = _host(fine[k + "_fine"])[0]
        out[k] = base
        out[k + "_fine"] = merged
    return out


# ---------------- audits ----------------

def _audit_pick(idx: np.ndarray, sample_rays: int, seed: int) -> np.ndarray:
    return (idx if idx.size <= sample_rays else np.random.RandomState(
        seed).choice(idx, sample_rays, replace=False))


def estimate_false_skip(renderer: NeurayRenderer, ref_c: Tensors,
                        que: Tensors, skip_idx: np.ndarray,
                        threshold: float, sample_rays: int = 2048,
                        seed: int = 0, mesh=None) -> float:
    """The share of a random sample of the probe's skipped rays (at most
    ``sample_rays``) that the exact gate, the full coarse pass's hit mass
    > threshold, would have kept (on a mesh, the sample's coarse pass
    sharded: every rank audits the same numbers)."""
    if skip_idx.size == 0:
        return 0.0
    pick = _audit_pick(skip_idx, sample_rays, seed)
    hp = _host(render_coarse_rays(renderer, ref_c, _take_rays(que, pick),
                                  ("hit_prob_nr",), mesh)["hit_prob_nr"])
    return float((hp[0].sum(-1) > threshold).mean())


def estimate_window_clip(renderer: NeurayRenderer, ref_c: Tensors,
                         que: Tensors, keep_idx: np.ndarray, near, far,
                         threshold: float, sample_rays: int = 1024,
                         seed: int = 0, ref_psnr: float = 35.0, mesh=None):
    """Audit the focus windows near, far [1, rn] against the exact coarse
    pass on a random sample of the kept rays (at most ``sample_rays``).

    Returns ``clip_mass``, the mean share of a ray's exact hit mass that
    lies outside its window (rays with mass <= threshold left out), and
    ``clip_db``, the predicted PSNR cost of the windows: per audited ray
    the colour error of clipping, exact composite minus the composite of
    the samples inside the window, scaled by the kept fraction of the
    frame, under mse_total = mse_ref + mse_clip with
    mse_ref = 10^(-ref_psnr / 10):
    clip_db = 10 log10(1 + mse_clip * kept_frac / mse_ref). On a mesh the
    sample's coarse pass is sharded, as in ``estimate_false_skip``.
    """
    if keep_idx.size == 0:
        return {"clip_mass": 0.0, "clip_db": 0.0}
    pick = _audit_pick(keep_idx, sample_rays, seed)
    out = render_coarse_rays(renderer, ref_c, _take_rays(que, pick),
                             ("hit_prob_nr", "colors_nr"), mesh)
    hp = _host(out["hit_prob_nr"])[0]                           # n,dn
    cols = _host(out["colors_nr"]).astype(np.float32)[0]        # n,dn,3
    # the exact coarse depths, recomputed
    depth = _host(S.sample_depth(que["depth_range"], 1, pick.size,
                                 renderer.cfg.depth_sample_num)[0])[0]
    inside = ((depth >= _host(near)[0, pick][:, None])
              & (depth <= _host(far)[0, pick][:, None]))
    mass = hp.sum(-1)
    mass_in = (hp * inside).sum(-1)
    valid = mass > threshold
    clip_mass = 0.0
    if valid.any():
        clip_mass = float((1.0 - mass_in[valid]
                           / np.maximum(mass[valid], 1e-8)).mean())
    e = np.einsum("nd,ndc->nc", hp, cols)
    f = np.einsum("nd,ndc->nc", hp * inside, cols)
    mse_clip = float(np.mean((e - f) ** 2))
    kept_frac = keep_idx.size / que["coords"].shape[1]
    mse_ref = 10.0 ** (-ref_psnr / 10.0)
    clip_db = float(10.0 * np.log10(1.0 + mse_clip * kept_frac / mse_ref))
    return {"clip_mass": clip_mass, "clip_db": clip_db}


def render_frame_probe_auto(renderer: NeurayRenderer, ref_c: Tensors,
                            que: Tensors, threshold: float = 0.005,
                            keep_base=("pixel_colors_nr",), image_hw=None,
                            dilate: int = 1, focus: bool = False,
                            tol: float = 0.02,
                            max_probe_sample_num: int = 32,
                            validate_rays: int = 2048, seed: int = 0,
                            probe_stride: int = 1,
                            win_tol_db: float = 0.05,
                            win_ref_psnr: float = 35.0, mesh=None):
    """Self-validating probe render. Probe, then audit on random rays
    against the exact coarse gate: the false-skip rate on skipped rays
    (``estimate_false_skip``) and, with ``focus``, the windows' predicted
    PSNR cost on kept rays (``estimate_window_clip``). If the rate is
    <= tol and the cost <= win_tol_db dB, render with the probe
    (``render_frame_probe_focus`` with focus, else
    ``render_frame_probe_skip``); otherwise double probe_sample_num (the
    same modules, ``_with_probe_sample_num``) and audit again; past
    max_probe_sample_num fall back to ``render_frame_skip_empty``, whose
    gate cannot miss. probe_stride > 1 takes effect with focus and
    image_hw. mesh: see the module's doc (on a mesh the probe and the
    audits shard too).

    Returns the frame dict plus ``probe_sample_num`` (the accepted
    value), ``false_skip_rate`` (the last audit), ``fallback``
    ("two_phase" or None), ``audit_trail`` (one {probe_sample_num,
    false_skip_rate, window_clip_db, kept_fraction} record per rung
    tried) and, with focus, ``window_clip`` and ``window_clip_db`` of
    the last window audit.
    """
    psn = renderer.cfg.probe_sample_num
    use_stride = focus and probe_stride > 1 and image_hw is not None
    info = {"fallback": None, "audit_trail": []}
    while True:
        r = _with_probe_sample_num(renderer, psn)
        if use_stride:
            probe_out = _strided_focus_probe(r, ref_c, que, threshold,
                                             image_hw, probe_stride, mesh)
            keep_mask = probe_out[0]
        else:
            probe_out = (focus_probe_rays if focus else probe_rays)(
                r, ref_c, que, mesh)
            score = probe_out[0] if focus else probe_out
            keep_mask = _host(score)[0] > threshold
        if dilate > 0 and image_hw is not None:
            keep_mask = _dilate_keep_mask(keep_mask, image_hw, dilate)
        fs = estimate_false_skip(r, ref_c, que, np.nonzero(~keep_mask)[0],
                                 threshold, validate_rays, seed, mesh)
        info["false_skip_rate"] = fs
        info["probe_sample_num"] = psn
        wc_db = 0.0
        if focus and fs <= tol:
            wc = estimate_window_clip(
                r, ref_c, que, np.nonzero(keep_mask)[0], probe_out[1],
                probe_out[2], threshold, seed=seed, ref_psnr=win_ref_psnr,
                mesh=mesh)
            info["window_clip"] = wc["clip_mass"]
            info["window_clip_db"] = wc_db = wc["clip_db"]
        info["audit_trail"].append({
            "probe_sample_num": psn, "false_skip_rate": fs,
            "window_clip_db": wc_db if focus and fs <= tol else None,
            "kept_fraction": float(keep_mask.mean())})
        if fs <= tol and wc_db <= win_tol_db:
            kw = dict(threshold=threshold, keep_base=keep_base,
                      image_hw=image_hw, dilate=dilate, probe_out=probe_out,
                      mesh=mesh)
            if focus:
                out = render_frame_probe_focus(
                    r, ref_c, que, probe_stride=probe_stride if use_stride
                    else 1, **kw)
            else:
                out = render_frame_probe_skip(r, ref_c, que, **kw)
            out.update(info)
            return out
        if psn * 2 > max_probe_sample_num:
            out = render_frame_skip_empty(renderer, ref_c, que,
                                          threshold=threshold,
                                          keep_base=keep_base, mesh=mesh)
            info["fallback"] = "two_phase"
            out.update(info)
            return out
        psn *= 2
