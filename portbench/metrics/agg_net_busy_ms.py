"""The device's busy time inside the program's ``agg_net`` spans (the
aggregation net of every coarse and fine pass; pb/program_spans.py), in
ms a frame."""
from pb.program_spans import busy_ms


def read(readout):
    return busy_ms(readout, "agg_net", "frames")
