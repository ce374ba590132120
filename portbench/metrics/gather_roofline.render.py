"""The gather kernel's forward share of its bytes roofline in the render
cells: the bytes the window's gathers need (pb/counts.py, the map reads
left out) over 3.35 TB/s, against the summed device time of its rows,
in %."""
from pb.readers import FORWARD, roofline_pct


def read(readout):
    return roofline_pct(readout, "gather_bytes", FORWARD)
