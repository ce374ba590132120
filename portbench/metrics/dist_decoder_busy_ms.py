"""The device's busy time inside the program's ``dist_decoder`` spans
(the visibility decoder's heads and ``compute_prob`` of every pass;
pb/program_spans.py), in ms a frame."""
from pb.program_spans import busy_ms


def read(readout):
    return busy_ms(readout, "dist_decoder", "frames")
