"""The gather kernel's backward share of its bytes roofline in the
training cell: the bytes the window's backward gathers need
(pb/counts.py: grad_out, coordinates and mask read, the whole map
gradient written) over 3.35 TB/s, against the summed device time of its
binning and accumulation kernels and the window's memsets, in %."""
from pb.readers import BACKWARD, roofline_pct


def read(readout):
    return roofline_pct(readout, "gather_bwd_bytes", BACKWARD)
