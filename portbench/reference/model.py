"""The plain reference of NeuRay's generalization renderer: the forward
of ``configs/gen/neuray_gen_depth.yaml`` and
``configs/gen/neuray_gen_cost_volume.yaml`` (and the focus probe of the
bench route), written as plain PyTorch functions over the flat weight
dict (flax paths ``params/<module>/.../kernel`` as in the weight files),
f32 unless a ``Precision`` says otherwise.

It is a frozen copy of the published equations, kept apart from the
program under test: no kernel, no cache, no batching trick. Departures
from the program's arithmetic are on purpose and change only rounding:
the base MLP of the aggregation net takes the concatenated input in one
matrix product, the bilinear gathers are four index reads and a lerp, and
the fine sampler uses ``torch.searchsorted``.

Layouts: maps channels-last [n, h, w, c]; poses [n, 3, 4] world->camera;
Ks [n, 3, 3]; pixel coords (x, y); rays [qn, rn, ...].
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

Tensors = Dict[str, torch.Tensor]


# ---------------- precision ----------------

class Precision:
    """How the reference rounds the inputs of its matrix products and
    convolutions, which then compute in f32 (TF32 off): ``f32`` leaves
    them; ``tf32`` rounds each input and weight to TF32's 10-bit mantissa
    (round to nearest even), as the tensor cores' TF32 mode does: the
    control of an f32 configuration; ``fp8`` to float8 e4m3 (saturated
    at its largest value): the control of a bf16 one. Gradients pass the
    rounding unchanged."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "f32":
            return x
        with torch.no_grad():
            if self.name == "tf32":
                m, e = torch.frexp(x)
                r = torch.ldexp(torch.round(m * 2048.0) / 2048.0, e)
            else:
                r = x.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).float()
        # the rounded value forward, the identity backward
        return x + (r - x) if not x.requires_grad else x + (r - x).detach()


F32 = Precision("f32")


# ---------------- layers over the flat weight dict ----------------

def _leaf(W: Tensors, path: str, name: str):
    for p in (f"{path}/Conv_0/{name}", f"{path}/{name}"):
        if p in W:
            return W[p]
    return None


def dense(W, path, x, pr=F32):
    k = W[f"{path}/kernel"]                              # in, out
    b = W.get(f"{path}/bias")
    y = torch.matmul(pr(x), pr(k))
    return y if b is None else y + b


def conv(W, path, x, stride=1, pad=0, reflect=False, pr=F32):
    """NCHW conv; flax kernel [kh, kw, in, out]; zero or reflect pad."""
    k = _leaf(W, path, "kernel").permute(3, 2, 0, 1)
    b = _leaf(W, path, "bias")
    if reflect and pad:
        x = F.pad(x, (pad,) * 4, mode="reflect")
        pad = 0
    return F.conv2d(pr(x), pr(k), b, stride, pad)


def inorm(W, path, x):
    return F.instance_norm(x, weight=W[f"{path}/scale"],
                           bias=W[f"{path}/bias"], eps=1e-5)


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


# ---------------- encoders ----------------

def basic_block(W, p, x, stride, pr):
    out = F.relu(inorm(W, f"{p}/bn1", conv(W, f"{p}/conv1", x, stride, 1,
                                           True, pr)))
    out = inorm(W, f"{p}/bn2", conv(W, f"{p}/conv2", out, 1, 1, True, pr))
    if f"{p}/down_conv/kernel" in W:
        x = inorm(W, f"{p}/down_norm", conv(W, f"{p}/down_conv", x, stride,
                                            pr=pr))
    return F.relu(out + x)


def res_layer(W, p, x, stride, pr):
    i = 0
    while f"{p}/block{i}/conv1/Conv_0/kernel" in W:
        x = basic_block(W, f"{p}/block{i}", x, stride if i == 0 else 1, pr)
        i += 1
    return x


def upsample2x(x):
    """2x bilinear, align_corners=True (NCHW)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


def conv_elu(W, p, x, pr):
    return F.elu(inorm(W, f"{p}/bn", conv(W, f"{p}/conv", x, 1, 1, True,
                                          pr)))


def skip_cat(up, skip):
    dy, dx = up.shape[2] - skip.shape[2], up.shape[3] - skip.shape[3]
    skip = F.pad(skip, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
    return torch.cat([up, skip], 1)


def res_unet(W, p, x, stem_pad, pr):
    """ResUNetLight / the init net's ResEncoder: x [n, h, w, c] ->
    [n, h/4, w/4, 32]."""
    x = F.relu(inorm(W, f"{p}/bn1", conv(W, f"{p}/conv1", nchw(x), 2,
                                         stem_pad, True, pr)))
    x1 = res_layer(W, f"{p}/layer1", x, 2, pr)
    x2 = res_layer(W, f"{p}/layer2", x1, 2, pr)
    x3 = res_layer(W, f"{p}/layer3", x2, 2, pr)
    y = conv_elu(W, f"{p}/iconv3", skip_cat(
        conv_elu(W, f"{p}/upconv3/conv", upsample2x(x3), pr), x2), pr)
    y = conv_elu(W, f"{p}/iconv2", skip_cat(
        conv_elu(W, f"{p}/upconv2/conv", upsample2x(y), pr), x1), pr)
    return nhwc(conv(W, f"{p}/out_conv", y, pr=pr))


def residual_block(W, p, x, pr):
    h = conv(W, f"{p}/conv1", F.relu(inorm(W, f"{p}/norm1", x)), 1, 1, True,
             pr)
    h = conv(W, f"{p}/conv2", F.relu(inorm(W, f"{p}/norm2", h)), 1, 1, True,
             pr)
    return x + h


def vis_encoder(W, ray_feats_raw, img_feats, pr):
    x = nchw(torch.cat([img_feats, ray_feats_raw], -1))
    x = conv(W, "params/vis_encoder/conv_in", x, 1, 1, True, pr)
    x = residual_block(W, "params/vis_encoder/res0", x, pr)
    x = residual_block(W, "params/vis_encoder/res1", x, pr)
    return nhwc(conv(W, "params/vis_encoder/conv_out", x, pr=pr))


# ---------------- geometry and gathers ----------------

def inv_depth_norm(depth, near, far):
    """metric depth -> [0, 1] inverse depth between near and far."""
    return (-1.0 / depth - (-1.0 / near)) / ((-1.0 / far) - (-1.0 / near))


def bilinear_border(maps, px):
    """Border-clamped bilinear sample of maps [v, fh, fw, c] at map
    pixels px [v, p, 2] -> [v, p, c]."""
    v, fh, fw, c = maps.shape
    x = px[..., 0].clamp(0, fw - 1)
    y = px[..., 1].clamp(0, fh - 1)
    x0 = torch.floor(x).clamp(0, max(fw - 2, 0))
    y0 = torch.floor(y).clamp(0, max(fh - 2, 0))
    tx, ty = (x - x0)[..., None], (y - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    x1 = (x0 + 1).clamp(max=fw - 1)
    y1 = (y0 + 1).clamp(max=fh - 1)
    flat = maps.reshape(v, fh * fw, c)

    def tap(yy, xx):
        return torch.gather(flat, 1, (yy * fw + xx)[..., None].expand(
            -1, -1, c))

    top = tap(y0, x0) * (1 - tx) + tap(y0, x1) * tx
    bot = tap(y1, x0) * (1 - tx) + tap(y1, x1) * tx
    return top * (1 - ty) + bot * ty


def frame_to_map(pts, h, w, fh, fw):
    """(x, y) pixels of an (h, w) image -> pixels of an (fh, fw) map:
    the same pixel at full size (align_corners), half-pixel centres
    otherwise."""
    if (fh, fw) == (h, w):
        return pts
    xn = pts[..., 0] / (w - 1.0) * 2.0 - 1.0
    yn = pts[..., 1] / (h - 1.0) * 2.0 - 1.0
    return torch.stack([((xn + 1.0) * fw - 1.0) / 2.0,
                        ((yn + 1.0) * fh - 1.0) / 2.0], -1)


def affine(m, p):
    """m [..., 3, 3 or 4] applied to points p [..., 3] (and its last
    column added), written as products and sums."""
    out = m[..., 0] * p[..., 0:1] + m[..., 1] * p[..., 1:2] \
        + m[..., 2] * p[..., 2:3]
    return out + m[..., 3] if m.shape[-1] == 4 else out


def small_mm(a, b):
    """a [..., i, j] @ b [..., j, k] for small matrices, without a
    matrix product."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def project(poses, Ks, pts):
    """world points [p, 3] -> pixels [v, p, 2], z-depth [v, p, 1] (0 in z
    replaced as 1e-3), valid [v, p]."""
    uvz = affine(small_mm(Ks, poses)[:, None], pts[None])
    z = uvz[..., 2:]
    bad = z.abs() < 1e-4
    z = torch.where(bad, torch.full_like(z, 1e-3), z)
    return uvz[..., :2] / z, z, ~bad[..., 0]


def camera_centers(poses):
    return -affine(poses[:, :, :3].transpose(1, 2), poses[:, :, 3])


# ---------------- init nets ----------------

def diff_feats(ref):
    """The depth init net's cross-view rgb / depth consistency
    features [v, h, w, 8]."""
    imgs, depth = ref["imgs"], ref["depth"]
    v, h, w, _ = imgs.shape
    near = ref["depth_range"][:, 0][:, None, None, None]
    far = ref["depth_range"][:, 1][:, None, None, None]
    ys, xs = torch.meshgrid(torch.arange(h, device=imgs.device,
                                         dtype=torch.float32),
                            torch.arange(w, device=imgs.device,
                                         dtype=torch.float32), indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], -1)          # h,w,3
    cam = (pix[None] * depth).reshape(v, h * w, 3)
    cam = affine(torch.linalg.inv(ref["Ks"])[:, None], cam)
    rot, t = ref["poses"][:, :, :3], ref["poses"][:, :, 3]
    world = affine(rot.transpose(1, 2)[:, None], cam - t[:, None])
    uv, z, ok = project(ref["poses"], ref["Ks"], world.reshape(-1, 3))
    inside = ((uv[..., 0] >= -0.5) & (uv[..., 0] < w - 0.5)
              & (uv[..., 1] >= -0.5) & (uv[..., 1] < h - 0.5) & ok)
    taps = bilinear_border(torch.cat([depth, imgs], -1), uv)      # v,V*p,4
    rgb_diff = (taps[..., 1:] - imgs.reshape(1, v * h * w, 3)).abs()
    inv_span = (-1.0 / far) - (-1.0 / near)
    dpt_diff = (-1.0 / taps[..., :1].clamp_min(1e-5)
                + 1.0 / z.clamp_min(1e-5)).abs() / inv_span[:, 0]
    dpt_diff = dpt_diff.clamp_max(1.5)
    m = inside.float()[..., None]
    cnt = m.sum(0, keepdim=True).clamp_min(1e-4)

    def mean_var(x):
        mean = (x * m).sum(0, keepdim=True) / cnt
        return mean, ((x - mean) ** 2 * m).sum(0, keepdim=True) / cnt

    (rm, rv), (dm, dv) = mean_var(rgb_diff), mean_var(dpt_diff)
    return torch.cat([rm, rv, dm, dv], -1).reshape(v, h, w, 8)


def depth_init_net(W, ref, pr=F32, diff_scale=1):
    """G' of the depth init net; ``diff_scale`` s > 1 takes the diff
    features on every s-th pixel and row (the camera scaled to match)
    and upsamples them bilinearly with half-pixel centres."""
    near = ref["depth_range"][:, 0][:, None, None, None]
    far = ref["depth_range"][:, 1][:, None, None, None]
    dn = inv_depth_norm(ref["depth"].clamp_min(1e-5), near, far).clamp(0, 1)
    metric = -1.0 / (dn * ((-1.0 / far) - (-1.0 / near)) + (-1.0 / near))
    s = diff_scale
    if s > 1:
        k = ref["Ks"] * torch.tensor([1.0 / s, 1.0 / s, 1.0],
                                     device=dn.device)[:, None]
        sub = dict(ref, imgs=ref["imgs"][:, ::s, ::s],
                   depth=metric[:, ::s, ::s], Ks=k)
        h, w = ref["imgs"].shape[1:3]
        diff = F.interpolate(nchw(diff_feats(sub)), scale_factor=s,
                             mode="bilinear", align_corners=False)
        diff = nhwc(diff[..., :h, :w])
    else:
        diff = diff_feats(dict(ref, depth=metric))
    feats = nchw(res_unet(W, "params/init_net/res_net",
                          torch.cat([ref["imgs"], dn, diff], -1), 2, pr))
    skip = F.relu(conv(W, "params/init_net/depth_skip_0", nchw(dn), 2,
                       pr=pr))
    skip = conv(W, "params/init_net/depth_skip_1", skip, 2, pr=pr)
    return nhwc(conv(W, "params/init_net/conv_out",
                     torch.cat([skip, feats], 1), pr=pr))


def frozen_bn(W, p, x):
    shape = (-1,) + (1,) * (x.dim() - 2)
    y = ((x - W[f"{p}/mean"].view(shape))
         / torch.sqrt(W[f"{p}/var"].view(shape) + 1e-5)
         * W[f"{p}/scale"].view(shape) + W[f"{p}/bias"].view(shape))
    return F.leaky_relu(y, 0.01)


def conv3d(W, p, x, stride=1, pr=F32):
    k = W[f"{p}/kernel"].permute(4, 3, 0, 1, 2)
    return F.conv3d(pr(x), pr(k), W.get(f"{p}/bias"), stride, 1)


def deconv3d(W, p, x, pr=F32):
    # flax's transpose-kernel layout [kd, kh, kw, out, in] -> [in, out, ...]
    k = W[f"{p}/kernel"].permute(4, 3, 0, 1, 2)
    return F.conv_transpose3d(pr(x), pr(k), None, 2, 1, output_padding=1)


def feature_net(W, x, pr):
    p = "params/init_net/mvsnet/feature"
    for i, (s, pad) in enumerate([(1, 1), (1, 1), (2, 2), (1, 1), (1, 1),
                                  (2, 2), (1, 1)]):
        x = frozen_bn(W, f"{p}/conv{i}/bn",
                      conv(W, f"{p}/conv{i}/conv", x, s, pad, pr=pr))
    return conv(W, f"{p}/feature", x, 1, 1, pr=pr)


def cost_reg(W, x, pr):
    p = "params/init_net/mvsnet/cost_regularization"

    def cbr(name, x, s=1):
        return frozen_bn(W, f"{p}/{name}/bn", conv3d(W, f"{p}/{name}/conv",
                                                     x, s, pr))

    def dbn(name, x):
        return frozen_bn(W, f"{p}/{name}/bn", deconv3d(W, f"{p}/{name}/conv",
                                                       x, pr))

    c0 = cbr("conv0", x)
    c2 = cbr("conv2", cbr("conv1", c0, 2))
    c4 = cbr("conv4", cbr("conv3", c2, 2))
    y = cbr("conv6", cbr("conv5", c4, 2))
    y = c4 + dbn("conv7", y)
    y = c2 + dbn("conv9", y)
    y = c0 + dbn("conv11", y)
    return conv3d(W, f"{p}/prob", y, 1, pr)


def homo_warp(feat, src_prj, ref_prj_inv, depth_vals):
    """feat [1, c, h, w] warped onto the reference view's planes
    depth_vals [dn] -> [c, dn, h, w] (zeros outside, align_corners)."""
    _, c, h, w = feat.shape
    m = small_mm(src_prj, ref_prj_inv)
    ys, xs = torch.meshgrid(torch.arange(h, device=feat.device,
                                         dtype=torch.float32),
                            torch.arange(w, device=feat.device,
                                         dtype=torch.float32), indexing="ij")
    g = torch.stack([xs, ys, torch.ones_like(xs)], 0).reshape(3, 1, h * w)
    gd = (g * depth_vals[None, :, None]).permute(1, 2, 0)       # dn,hw,3
    pts = affine(m[:3], gd).permute(2, 0, 1)                      # 3,dn,hw
    z = pts[2].clamp_min(1e-4)
    px = (pts[0] / z).clamp(-2.0, w + 1.0)
    py = (pts[1] / z).clamp(-2.0, h + 1.0)
    grid = torch.stack([px / (w - 1.0) * 2 - 1, py / (h - 1.0) * 2 - 1], -1)
    out = F.grid_sample(feat, grid[None], mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out[0].reshape(c, -1, h, w)


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# MVSNet's input size for views of these sizes (h, w) at eval time
EVAL_RESIZE = {(768, 1024): (576, 768), (800, 800): (640, 640)}


def resize(x, h, w):
    down = h < x.shape[-2] or w < x.shape[-1]
    return F.interpolate(x, size=(h, w), mode="bilinear",
                         align_corners=False, antialias=down)


def project_matrix(Ks, poses, ratio):
    s = torch.tensor([ratio, ratio, 1.0], device=Ks.device)
    m = small_mm(Ks * s[:, None], poses)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=Ks.device)
    return torch.cat([m, bottom.expand(m.shape[0], 1, 4)], 1)


def cost_volume_init_net(W, ref, src, sn=64, pr=F32):
    """The MVSNet init net at eval time (the views resized for MVSNet as
    ``EVAL_RESIZE`` says)."""
    v, h, w, _ = ref["imgs"].shape
    ratio = 1.0
    r_imgs, s_imgs = nchw(ref["imgs"]), nchw(src["imgs"])
    if (h, w) in EVAL_RESIZE:
        rh, rw = EVAL_RESIZE[(h, w)]
        r_imgs, s_imgs = resize(r_imgs, rh, rw), resize(s_imgs, rh, rw)
        ratio = rh / h
    mean = torch.tensor(IMAGENET_MEAN, device=r_imgs.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=r_imgs.device)[:, None, None]
    near, far = ref["depth_range"][:, 0], ref["depth_range"][:, 1]
    step = (1 / far - 1 / near) / (sn - 1)
    depth_vals = torch.cat([1.0 / (1.0 / near[:, None] + torch.arange(
        sn - 1, device=near.device)[None] * step[:, None]), far[:, None]], 1)
    with torch.no_grad():
        r_feat = feature_net(W, (r_imgs - mean) / std, pr)
        s_feat = feature_net(W, (s_imgs - mean) / std, pr)
        r_prj = project_matrix(ref["Ks"], ref["poses"], 0.25 * ratio)
        s_prj = project_matrix(src["Ks"], src["poses"], 0.25 * ratio)
        logits = []
        for i in range(v):
            ids = ref["nn_ids"][i].tolist()
            s1 = r_feat[i][:, None]
            s2 = s1 * s1
            inv = torch.linalg.inv(r_prj[i])
            for j in ids:
                wv = homo_warp(s_feat[j:j + 1], s_prj[j], inv, depth_vals[i])
                s1, s2 = s1 + wv, s2 + wv * wv
            n = len(ids) + 1
            var = s2 / n - (s1 / n) ** 2
            logits.append(cost_reg(W, var[None], pr)[0, 0])
        logits = torch.nan_to_num(torch.stack(logits), nan=0.0)
        if ratio != 1.0:
            logits = resize(logits, h // 4, w // 4)
        prob = torch.softmax(logits, 1)
        depth = (prob * depth_vals[:, :, None, None]).sum(1)
    p = "params/init_net"
    feats = nchw(res_unet(W, f"{p}/res_net", ref["imgs"], 3, pr))

    def branch(name, x):
        x = conv(W, f"{p}/{name}_conv_in", x, 1, 1, True, pr)
        x = residual_block(W, f"{p}/{name}_res", x, pr)
        return conv(W, f"{p}/{name}_conv_out", x, pr=pr)

    dnorm = inv_depth_norm(depth.clamp_min(1e-5), near[:, None, None],
                           far[:, None, None]).clamp(0, 1)
    x = torch.cat([feats, branch("volume", prob),
                   branch("depth", dnorm[:, None])], 1)
    return nhwc(branch("out", x))


def encode(W, ref, src=None, pr=F32, diff_scale=1):
    """The scene encode: the ref dict plus ``img_feats`` and ``ray_feats``
    [v, h/4, w/4, 32]."""
    raw = (cost_volume_init_net(W, ref, src, pr=pr) if src is not None
           else depth_init_net(W, ref, pr, diff_scale))
    img = res_unet(W, "params/image_encoder", ref["imgs"], 3, pr)
    return dict(ref, img_feats=img, ray_feats=vis_encoder(W, raw, img, pr))


# ---------------- rays ----------------

def coarse_depths(depth_range, qn, rn, dn):
    near = depth_range[:, 0:1].expand(qn, rn)
    far = depth_range[:, 1:2].expand(qn, rn)
    return ranged_depths(near, far, dn)


def ranged_depths(near, far, dn):
    """dn depths uniform in inverse depth over [near, far] [qn, rn]."""
    span = (1.0 / far - 1.0 / near)[..., None]
    ticks = span / (dn - 1) * torch.arange(1, dn - 1, device=near.device,
                                           dtype=torch.float32)
    ticks = torch.cat([torch.zeros_like(span), ticks, span], -1)
    return 1.0 / (1.0 / near[..., None] + ticks)


def inv_dists(depth, depth_range):
    x = inv_depth_norm(depth, depth_range[:, 0][:, None, None],
                       depth_range[:, 1][:, None, None])
    return torch.cat([x[..., 1:] - x[..., :-1],
                      torch.full_like(x[..., :1], 1e6)], -1)


def ray_points(que, depth):
    """points [qn, rn, dn, 3] and unit directions to the camera."""
    center = camera_centers(que["poses"])
    m = small_mm(que["poses"][:, :, :3].transpose(1, 2),
                 torch.linalg.inv(que["Ks"]))
    pix = torch.cat([que["coords"], torch.ones_like(que["coords"][..., :1])],
                    -1)
    d = affine(m[:, None], pix)
    pts = center[:, None, None] + d[:, :, None] * depth[..., None]
    u = -d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return pts, u[:, :, None].expand(pts.shape)


def head(W, p, x, final, pr):
    x = F.elu(dense(W, f"{p}/fc1", F.elu(dense(W, f"{p}/fc0", x, pr)), pr))
    return final(dense(W, f"{p}/fc2", x, pr))


def mixture_prob(W, dec, feats, depth, interval, depth_range, pr):
    """The mixture-of-logistics decoder at each view's projected depth:
    feats [v, ..., 32]; depth [v, qn, rn, dn]; interval [qn, rn, dn] ->
    (visibility, hit_prob) [v, qn, rn, dn]."""
    mean = head(W, f"{dec}/mean_decoder", feats, F.softplus, pr)
    var = head(W, f"{dec}/var_decoder", feats, F.softplus, pr) + 0.05
    aw = head(W, f"{dec}/aw_decoder", feats, torch.sigmoid, pr)
    near = depth_range[:, 0][:, None, None, None]
    far = depth_range[:, 1][:, None, None, None]
    x = inv_depth_norm(depth.clamp_min(1e-5), near, far)
    half = torch.cat([interval[None, ..., :1], interval[None]], -1) / 2
    lo, hi = (x - half[..., :-1])[..., None], (x + half[..., 1:])[..., None]
    c0 = 0.5 + 0.5 * torch.tanh((lo - mean) * var)
    c1 = 0.5 + 0.5 * torch.tanh((hi - mean) * var)
    mix = torch.cat([aw, 1 - aw], -1)
    return ((1 - c0) * mix).sum(-1), ((c1 - c0) * mix).sum(-1)


def seq(W, p, x, n, final, pr):
    for i in range(n):
        x = dense(W, f"{p}/fc{i}", x, pr)
        x = F.elu(x) if i < n - 1 else final(x)
    return x


def sinusoid(pos, d=16):
    """sin / cos position code at (fractional) positions pos [...]."""
    i = torch.arange(d, device=pos.device)
    angle = pos[..., None] / torch.pow(10000.0, (2 * (i // 2) / d).float())
    return torch.where(i % 2 == 0, torch.sin(angle), torch.cos(angle))


def attention(W, p, x, mask, pr):
    """Post-LN 4-head self-attention over samples; masked positions
    blank their whole query row (the published network's behaviour)."""
    b, n, _ = x.shape

    def split(y):
        return y.reshape(b, n, 4, 4).transpose(1, 2)

    q = split(dense(W, f"{p}/w_qs", x, pr))
    k = split(dense(W, f"{p}/w_ks", x, pr))
    v = split(dense(W, f"{p}/w_vs", x, pr))
    a = torch.matmul(pr(q / 2.0), pr(k.transpose(-1, -2)))
    a = a.masked_fill(mask[:, None] == 0, -1e9).softmax(-1)
    o = torch.matmul(pr(a), pr(v)).transpose(1, 2).reshape(b, n, 16)
    return F.layer_norm(dense(W, f"{p}/fc", o, pr) + x, (16,),
                        W[f"{p}/layer_norm/scale"],
                        W[f"{p}/layer_norm/bias"], 1e-6)


def mean_var(x, wt):
    m = (x * wt).sum(0, keepdim=True)
    return m, (wt * (x - m) ** 2).sum(0, keepdim=True)


def aggregate(W, net, prj, que_dir, pos, pr):
    """The aggregation net: prj fields [v, b, n, .]; que_dir [b, n, 3];
    pos [b, n] sample positions -> density [b, n], colours [b, n, 3]."""
    p = f"params/{net}"
    emb = F.relu(dense(W, f"{p}/prob_embed_0", torch.cat(
        [prj["ray_feats"], (prj["hit"] - 0.5) * 2, (prj["vis"] - 0.5) * 2],
        -1), pr))
    emb = dense(W, f"{p}/prob_embed_1", emb, pr)
    q = f"{p}/agg_impl"
    mask = prj["mask"]
    ddir = prj["dir"] - que_dir[None]
    ray_diff = torch.cat([ddir, (prj["dir"] * que_dir[None]).sum(-1, True)],
                         -1)
    rgb_in = prj["rgb"]
    rgb_feat = torch.cat([rgb_in, prj["img_feats"]], -1) + seq(
        W, f"{q}/ray_dir_fc", ray_diff, 2, F.elu, pr)
    wt = mask / (mask.sum(0, keepdim=True) + 1e-8)
    wt0 = torch.sigmoid(seq(W, f"{q}/neuray_fc", emb, 2, lambda y: y, pr)) * wt
    m0, v0 = mean_var(rgb_feat, wt0)
    m1, v1 = mean_var(rgb_feat, wt)
    g = torch.cat([m0, v0, m1, v1], -1).expand(rgb_feat.shape[0], -1, -1, -1)
    x = seq(W, f"{q}/base_fc", torch.cat([g, rgb_feat, emb], -1), 2, F.elu,
            pr)
    xv = seq(W, f"{q}/vis_fc", x * wt, 2, F.elu, pr)
    vis = torch.sigmoid(xv[..., -1:]) * mask
    x = x + xv[..., :-1]
    vis = seq(W, f"{q}/vis_fc2", x * vis, 2, torch.sigmoid, pr) * mask
    wt = vis / (vis.sum(0, keepdim=True) + 1e-8)
    m, var = mean_var(x, wt)
    gf = seq(W, f"{q}/geometry_fc", torch.cat([m[0], var[0], wt.mean(0)], -1),
             2, F.elu, pr)
    gf = gf + sinusoid(pos)
    nobs = mask.sum(0)
    gf = attention(W, f"{q}/ray_attention", gf, (nobs > 1).float(), pr)
    sigma = seq(W, f"{q}/out_geometry_fc", gf, 2, F.relu, pr)
    sigma = torch.where(nobs < 1, torch.zeros_like(sigma), sigma)
    blend = seq(W, f"{q}/rgb_fc", torch.cat([x, vis, ray_diff], -1), 3,
                lambda y: y, pr)
    blend = blend.masked_fill(mask == 0, -1e9).softmax(0)
    return sigma[..., 0], (rgb_in * blend).sum(0)


def hit_probs(alpha):
    """hit[i] = alpha[i] prod_{j<i} (1 - alpha[j] + 1e-10)."""
    t = torch.cumprod(1 - alpha + 1e-10, -1)
    return alpha * torch.cat([torch.ones_like(t[..., :1]), t[..., :-1]], -1)


def render_pass(W, ec, que, depth, fine, pos, pr=F32):
    """One pass over rays at depths [qn, rn, dn]: returns (pixel colours
    [qn, rn, 3], hit_prob [qn, rn, dn], colours [qn, rn, dn, 3])."""
    qn, rn, dn = depth.shape
    v, h, w, _ = ec["imgs"].shape
    fh, fw = ec["ray_feats"].shape[1:3]
    pts, que_dir = ray_points(que, depth)
    flat = pts.reshape(-1, 3)
    uv, z, ok = project(ec["poses"], ec["Ks"], flat)
    mask = (ok & (uv[..., 0] >= -0.5) & (uv[..., 0] < w - 0.5)
            & (uv[..., 1] >= -0.5) & (uv[..., 1] < h - 0.5)).float()[..., None]
    cams = camera_centers(ec["poses"])
    d = flat[None] - cams[:, None]
    pdir = -d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp_min(1e-5)
    rgb = bilinear_border(ec["imgs"], uv) * mask
    feats = bilinear_border(torch.cat([ec["ray_feats"], ec["img_feats"]], -1),
                            frame_to_map(uv, h, w, fh, fw)) * mask

    def rs(x):
        return x.reshape(v, qn * rn, dn, -1)

    dec = "params/fine_dist_decoder" if fine else "params/dist_decoder"
    vis, hit = mixture_prob(W, dec,
                            feats[..., :32].reshape(v, qn, rn, dn, 32),
                            z.reshape(v, qn, rn, dn),
                            inv_dists(depth, que["depth_range"]),
                            ec["depth_range"], pr)
    prj = {"ray_feats": rs(feats[..., :32]), "img_feats": rs(feats[..., 32:]),
           "rgb": rs(rgb), "dir": rs(pdir), "mask": rs(mask),
           "vis": vis.reshape(v, qn * rn, dn, 1) * rs(mask),
           "hit": hit.reshape(v, qn * rn, dn, 1) * rs(mask)}
    density, colors = aggregate(W, "fine_agg_net" if fine else "agg_net",
                                prj, que_dir.reshape(qn * rn, dn, 3),
                                pos.reshape(qn * rn, dn), pr)
    alpha = 1 - torch.exp(-F.relu(density))
    hp = hit_probs(alpha).reshape(qn, rn, dn)
    colors = colors.reshape(qn, rn, dn, 3)
    return (hp[..., None] * colors).sum(-2), hp, colors


def fine_depths(depth, hit, depth_range, n, u=None):
    """n depths drawn from the coarse hit_prob by the inverse CDF (at
    stratified u without ``u``; the given draws, sorted, with it)."""
    near, far = -1.0 / depth_range[0, 0], -1.0 / depth_range[0, 1]
    x = (-1.0 / depth - near) / (far - near)
    edges = torch.cat([x[..., :1], (x[..., 1:] + x[..., :-1]) / 2,
                       x[..., -1:]], -1)
    pdf = (hit + 1e-5) / (hit + 1e-5).sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), torch.cumsum(pdf, -1)],
                    -1)
    train = u is not None
    if not train:
        u = ((torch.arange(n, device=depth.device, dtype=torch.float32)
              + 0.5) / n).expand(*cdf.shape[:-1], n).contiguous()
    hi = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    lo = hi - 1
    hi = hi.clamp(max=cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(-1, lo), cdf.gather(-1, hi)
    e0, e1 = edges.gather(-1, lo), edges.gather(-1, hi)
    den = c1 - c0
    den = torch.where(den < 1e-5, torch.ones_like(den), den)
    y = e0 + (u - c0) / den * (e1 - e0)
    out = -1.0 / (y * (far - near) + near)
    return torch.sort(out, -1).values if train else out


def grid_positions(qn, rn, n, device):
    return torch.arange(n, device=device, dtype=torch.float32).expand(qn, rn,
                                                                      n)


def render_rays(W, ec, que, dn=64, fdn=64, pr=F32, u=None):
    """The exact coarse + fine render of que's rays: (coarse, fine) pixel
    colours [qn, rn, 3] and, with ``u`` (training draws), the coarse and
    fine passes' hit_prob."""
    qn, rn, _ = que["coords"].shape
    dev = que["coords"].device
    depth = coarse_depths(que["depth_range"], qn, rn, dn)
    col, hit, _ = render_pass(W, ec, que, depth, False,
                              grid_positions(qn, rn, dn, dev), pr)
    fd = fine_depths(depth, hit.detach(), que["depth_range"], fdn, u)
    col_f, hit_f, _ = render_pass(W, ec, que, fd, True,
                                  grid_positions(qn, rn, fdn, dev), pr)
    return col, col_f


# ---------------- the focus route ----------------

def focus_probe(W, ec, que, psn=16, dn=64, q=0.005, margin=1, pr=F32):
    """The probe at psn samples (attention positions those of every
    (dn / psn)-th coarse sample): (score, near, far) [qn, rn]."""
    qn, rn, _ = que["coords"].shape
    depth = coarse_depths(que["depth_range"], qn, rn, psn)
    stride = max(1, dn // psn)
    pos = grid_positions(qn, rn, psn, depth.device) * stride
    _, hit, _ = render_pass(W, ec, que, depth, False, pos, pr)
    hit = hit.float()
    score = hit.sum(-1)
    frac = torch.cumsum(hit, -1) / (score[..., None] + 1e-12)
    lo = torch.argmax((frac >= q).to(torch.uint8), -1)
    hi = torch.argmax((frac >= 1 - q).to(torch.uint8), -1)
    lo = (lo - margin).clamp(0, psn - 1)
    hi = (hi + margin).clamp(0, psn - 1)
    near = depth.gather(-1, lo[..., None])[..., 0]
    far = depth.gather(-1, hi[..., None])[..., 0]
    dr = que["depth_range"]
    ok = score > 1e-3
    near = torch.where(ok, near, dr[:, 0:1].expand_as(near))
    far = torch.where(ok & (far > near), far, dr[:, 1:2].expand_as(far))
    return score, near, far


def strided_keep(score, near, far, hw, stride, threshold):
    """Probe results on every stride-th pixel [hs*ws] -> per-pixel keep
    mask [h*w] (threshold, 1-pixel dilation at probe resolution, nearest
    upsampling) and windows (3x3 min(near) / max(far), upsampled)."""
    h, w = hw
    hs, ws = -(-h // stride), -(-w // stride)
    s = score.reshape(hs, ws)

    def pool(a, op):
        pad = F.pad(a[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
        st = torch.stack([pad[i:i + hs, j:j + ws] for i in range(3)
                          for j in range(3)])
        return op(st, 0)

    keep = pool((s > threshold).float(), lambda x, d: x.amax(d)) > 0
    yi = torch.clamp(torch.arange(h, device=s.device) // stride, max=hs - 1)
    xi = torch.clamp(torch.arange(w, device=s.device) // stride, max=ws - 1)

    def up(a):
        return a[yi][:, xi].reshape(-1)

    return (up(keep), up(pool(near.reshape(hs, ws), lambda x, d: x.amin(d))),
            up(pool(far.reshape(hs, ws), lambda x, d: x.amax(d))))


def dilate(keep, hw):
    """One 8-neighbour dilation of a row-major [h*w] mask."""
    m = keep.reshape(1, 1, *hw).float()
    return (F.max_pool2d(m, 3, 1, 1) > 0).reshape(-1)


def focus_render(W, ec, que, near, far, nc=12, nf=24, dn=64, fdn=64,
                 pr=F32):
    """Coarse + fine render inside per-ray windows [qn, rn]: nc and nf
    samples, the coarse ones at their fractional grid positions, the fine
    ones spread evenly over the fine grid. -> (coarse, fine) colours."""
    qn, rn = near.shape
    depth = ranged_depths(near, far, nc)
    dr = que["depth_range"]
    lo, hi = (-1.0 / dr[:, 0])[:, None, None], (-1.0 / dr[:, 1])[:, None,
                                                                  None]
    pos = ((-1.0 / depth) - lo) / (hi - lo) * (dn - 1)
    col, hit, _ = render_pass(W, ec, que, depth, False, pos, pr)
    fd = fine_depths(depth, hit, dr, nf)
    pos_f = torch.linspace(0.0, float(fdn - 1), nf,
                           device=depth.device).expand(qn, rn, nf)
    col_f, _, _ = render_pass(W, ec, que, fd, True, pos_f, pr)
    return col, col_f


# ---------------- weights ----------------

def load_weights(path: str, device, scale: Dict[str, float] | None = None
                 ) -> Tensors:
    """The flat weight file as f32 tensors on ``device``, each leaf named
    by its flax path; ``scale`` multiplies named leaves (the cost-volume
    configuration's sharpened MVSNet)."""
    with np.load(path) as z:
        out = {k: torch.from_numpy(np.asarray(z[k], np.float32)).to(device)
               for k in z.files}
    for k, s in (scale or {}).items():
        out[k] = out[k] * s
    return out


def count_params(W: Tensors) -> int:
    return int(sum(math.prod(v.shape) for v in W.values()))
