"""The whole frame's share of the card's peak: the model's FLOPs of the
window's frames (pb/counts.py) over the traced window's seconds and
the peak of the configuration's precision, in %."""
from pb.readers import mfu_pct


def read(readout):
    return mfu_pct(readout)
