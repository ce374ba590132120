"""The whole finetuning step's share of the card's peak: the step's
matrix-product and convolution FLOPs (pb/ft_counts.py: the image and vis
encoders on the reference views and the query, the coarse and fine
passes, the self-hit heads; three times the forward) of the window's
steps over the traced window's seconds and the peak of the
configuration's precision, in %."""
from pb.readers import mfu_pct


def read(readout):
    return mfu_pct(readout)
