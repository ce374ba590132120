"""The yardstick's arithmetic: the model's operations and the gather
kernel's bytes, counted from the configuration's widths (the weight
file's shapes) and the shapes the inputs need, whatever implements them.

FLOPs are those of the matrix products and convolutions (two a
multiply-add), the terms ``torch.utils.flop_counter.FlopCounterMode``
counts; the elementwise work, the gathers and the plane-sweep warp are
left out. A training step counts three times its forward (the backward's
two products a forward one).

The gather bytes are ``chip_smoke.py: gather_bound``'s and
``gather_backward_bound``'s terms: each input byte read once, each output
byte written once. The forward's map reads are left out (only the
coordinates say which map pixels the taps touch, and the benchmark does
not see them), so ``gather_roofline`` is a lower bound of the kernel's
share; the backward writes its whole map, which is counted.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

# NVIDIA H100 SXM, published dense peaks (data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}

Shapes = Dict[str, Tuple[int, ...]]


def shapes_of(W) -> Shapes:
    return {k: tuple(v.shape) for k, v in W.items()}


def file_shapes(path) -> Shapes:
    """The leaves' shapes of a weight file (flax paths)."""
    import numpy as np
    with np.load(path) as z:
        return {k: tuple(z[k].shape) for k in z.files}


def _kernel(S: Shapes, path: str):
    for p in (f"{path}/Conv_0/kernel", f"{path}/kernel"):
        if p in S:
            return S[p]
    raise KeyError(path)


def conv2d(S, path, n, h, w, stride=1, pad=0):
    """FLOPs of one conv over n maps of h x w -> (flops, ho, wo)."""
    kh, kw, cin, cout = _kernel(S, path)
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (w + 2 * pad - kw) // stride + 1
    return 2 * n * ho * wo * kh * kw * cin * cout, ho, wo


def resunet(S, p, n, h, w, stem_pad):
    """A ResUNet (the image encoder, the init net's encoders) on n
    images of h x w -> (flops, h/4, w/4)."""
    f, h, w = conv2d(S, f"{p}/conv1", n, h, w, 2, stem_pad)
    for layer in ("layer1", "layer2", "layer3"):
        i = 0
        while f"{p}/{layer}/block{i}/conv1/Conv_0/kernel" in S:
            b = f"{p}/{layer}/block{i}"
            s = 2 if i == 0 else 1
            g, ho, wo = conv2d(S, f"{b}/conv1", n, h, w, s, 1)
            f += g + conv2d(S, f"{b}/conv2", n, ho, wo, 1, 1)[0]
            if f"{b}/down_conv/kernel" in S:
                f += conv2d(S, f"{b}/down_conv", n, h, w, s)[0]
            h, w, i = ho, wo, i + 1
    for up, icv in (("upconv3", "iconv3"), ("upconv2", "iconv2")):
        h, w = 2 * h, 2 * w
        f += conv2d(S, f"{p}/{up}/conv/conv", n, h, w, 1, 1)[0]
        f += conv2d(S, f"{p}/{icv}/conv", n, h, w, 1, 1)[0]
    f += conv2d(S, f"{p}/out_conv", n, h, w)[0]
    return f, h, w


def residual(S, p, n, h, w):
    return (conv2d(S, f"{p}/conv1", n, h, w, 1, 1)[0]
            + conv2d(S, f"{p}/conv2", n, h, w, 1, 1)[0])


def vis_encoder(S, n, h, w):
    p = "params/vis_encoder"
    return (conv2d(S, f"{p}/conv_in", n, h, w, 1, 1)[0]
            + residual(S, f"{p}/res0", n, h, w)
            + residual(S, f"{p}/res1", n, h, w)
            + conv2d(S, f"{p}/conv_out", n, h, w)[0])


def conv3d(S, path, d, h, w, stride=1, transposed=False):
    """FLOPs of one k3 pad-1 3-D (transposed, x2) conv -> (flops, size)."""
    kd, kh, kw, a, b = S[f"{path}/kernel"]
    if transposed:
        # counted over the input, as FlopCounterMode counts a transposed conv
        return 2 * d * h * w * kd * kh * kw * a * b, (2 * d, 2 * h, 2 * w)
    do, ho, wo = ((x - 1) // stride + 1 for x in (d, h, w))
    return 2 * do * ho * wo * kd * kh * kw * a * b, (do, ho, wo)


MVS_INPUT = {(768, 1024): (576, 768), (800, 800): (640, 640)}


def cost_volume_init(S, n, h, w, sn=64):
    """The MVSNet init net at eval time on n refs (each its own src view
    set: FeatureNet on the refs and on the srcs, as published)."""
    mh, mw = MVS_INPUT.get((h, w), (h, w))
    p = "params/init_net/mvsnet"
    f, fh, fw = 0, mh, mw
    for i, (s, pad) in enumerate([(1, 1), (1, 1), (2, 2), (1, 1), (1, 1),
                                  (2, 2), (1, 1)]):
        g, fh, fw = conv2d(S, f"{p}/feature/conv{i}/conv", 2 * n, fh, fw, s,
                           pad)
        f += g
    f += conv2d(S, f"{p}/feature/feature", 2 * n, fh, fw, 1, 1)[0]
    c = f"{p}/cost_regularization"
    size = (sn, fh, fw)
    reg = 0
    for name, s in (("conv0", 1), ("conv1", 2), ("conv2", 1), ("conv3", 2),
                    ("conv4", 1), ("conv5", 2), ("conv6", 1)):
        g, size = conv3d(S, f"{c}/{name}/conv", *size, s)
        reg += g
    for name in ("conv7", "conv9", "conv11"):
        g, size = conv3d(S, f"{c}/{name}/conv", *size, transposed=True)
        reg += g
    reg += conv3d(S, f"{c}/prob", *size)[0]
    f += n * reg
    g, h4, w4 = resunet(S, "params/init_net/res_net", n, h, w, 3)
    f += g
    for b in ("volume", "depth", "out"):
        q = f"params/init_net/{b}"
        f += (conv2d(S, f"{q}_conv_in", n, h4, w4, 1, 1)[0]
              + residual(S, f"{q}_res", n, h4, w4)
              + conv2d(S, f"{q}_conv_out", n, h4, w4)[0])
    return f


def depth_init(S, n, h, w):
    g, h4, w4 = resunet(S, "params/init_net/res_net", n, h, w, 2)
    s0, h2, w2 = conv2d(S, "params/init_net/depth_skip_0", n, h, w, 2)
    s1, _, _ = conv2d(S, "params/init_net/depth_skip_1", n, h2, w2, 2)
    return g + s0 + s1 + conv2d(S, "params/init_net/conv_out", n, h4, w4)[0]


def encode(S, n, h, w, cost_volume: bool):
    """The scene encode of n views of h x w."""
    init = (cost_volume_init(S, n, h, w) if cost_volume
            else depth_init(S, n, h, w))
    img, h4, w4 = resunet(S, "params/image_encoder", n, h, w, 3)
    return init + img + vis_encoder(S, n, h4, w4)


def _dense(S, prefixes):
    return sum(2 * math.prod(v) for k, v in S.items()
               if k.endswith("/kernel") and len(v) == 2
               and any(k.startswith(p + "/") for p in prefixes))


def per_sample(S, fine: bool):
    """(FLOPs a sample and view, FLOPs a sample) of one render pass."""
    dec = "params/fine_dist_decoder" if fine else "params/dist_decoder"
    agg = "params/fine_agg_net" if fine else "params/agg_net"
    a = f"{agg}/agg_impl"
    view = _dense(S, [dec, f"{agg}/prob_embed_0", f"{agg}/prob_embed_1"]
                  + [f"{a}/{m}" for m in ("ray_dir_fc", "neuray_fc",
                                          "base_fc", "vis_fc", "vis_fc2",
                                          "rgb_fc")])
    point = _dense(S, [f"{a}/{m}" for m in ("geometry_fc", "out_geometry_fc",
                                            "ray_attention")])
    return view, point


def render_pass(S, rays, samples, views, fine: bool):
    """One pass over ``rays`` at ``samples`` each: the dist decoder and
    the aggregation net at every (sample, view), the per-sample layers,
    and the along-ray attention's two products (4 heads of 4)."""
    view, point = per_sample(S, fine)
    attn = 2 * 2 * 4 * 4 * samples * samples
    return rays * (samples * (views * view + point) + attn)


def depth_head(S, views, pixels):
    """The depth-loss head: each decoder's mean head at every pixel."""
    return views * pixels * (_dense(S, ["params/dist_decoder/mean_decoder"])
                             + _dense(S, ["params/fine_dist_decoder/"
                                          "mean_decoder"]))


# ---------------- the gather's bytes ----------------

def gather_bytes(points, out_channels, out_elem, masked=True):
    """A forward gather of ``points`` (sample, view) pairs: the
    coordinates (8 bytes), the mask (4) and the output, the map's reads
    left out (see the module's doc)."""
    return points * (8 + (4 if masked else 0) + out_channels * out_elem)


def gather_backward_bytes(views, points, channels, fh, fw, masked=True):
    """One backward of the f32 gather: grad_out, the coordinates and the
    mask read once, the [views, fh, fw, channels] gradient written once."""
    return (views * points * (channels * 4 + 8 + (4 if masked else 0))
            + views * fh * fw * channels * 4)
