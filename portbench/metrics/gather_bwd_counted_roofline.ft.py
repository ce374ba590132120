"""The gather kernel's backward share of its bytes roofline in the
finetuning cell, from the bytes the program counted at each launch
(``gather.bwd_bytes``: grad_out, coordinates and mask read, the whole map
gradient written; here the reference views' [200, 200, 64] maps and the
query's own [1, 200, 200, 32] one) over 3.35 TB/s, against the summed
device time of its binning and accumulation kernels and the window's
memsets, in %."""
from pb.program_spans import counted_roofline_pct
from pb.readers import BACKWARD


def read(readout):
    return counted_roofline_pct(readout, "gather.bwd_bytes", BACKWARD)
