"""The gather kernel's forward share of its bytes roofline from the bytes
the program counted at each launch (``gather.bytes``: coordinates, mask
and output, the map reads left out), over 3.35 TB/s, against the summed
device time of its rows, in %."""
from pb.program_spans import counted_roofline_pct
from pb.readers import FORWARD


def read(readout):
    return counted_roofline_pct(readout, "gather.bytes", FORWARD)
