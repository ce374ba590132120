"""The finetuning step's yardstick: its matrix-product and convolution
FLOPs from the configuration's widths (the weight file's shapes) and the
step's shapes, by ``pb/counts.py``'s rules (the terms
``torch.utils.flop_counter.FlopCounterMode`` counts; a training step
counts three times its forward).

A step's forward: the image encoder and the vis encoder on its reference
views and on the query view (the self-hit path encodes the query's own
row), the coarse and the fine render pass over the reference views, and
the self-hit decoder's heads on every ray of each pass. The init net runs
only when the state is made, not in a step.
"""
from __future__ import annotations

from pb import counts


def self_hit(S, fine: bool) -> int:
    """The coarse or fine dist decoder's heads on one ray."""
    return counts._dense(S, ["params/fine_dist_decoder" if fine
                             else "params/dist_decoder"])


def forward(S, views: int, h: int, w: int, rays: int, dn: int,
            fdn: int) -> int:
    """One step's forward FLOPs from ``views`` reference views of h x w,
    ``rays`` rays at dn coarse and fdn fine samples."""
    img, h4, w4 = counts.resunet(S, "params/image_encoder", views + 1, h,
                                 w, 3)
    return (img + counts.vis_encoder(S, views + 1, h4, w4)
            + counts.render_pass(S, rays, dn, views, False)
            + counts.render_pass(S, rays, fdn, views, True)
            + rays * (self_hit(S, False) + self_hit(S, True)))

