"""The device's idle time in gaps that began while the host was inside a
render pass (the program's ``pass`` spans, the spans inside them
included; pb/program_spans.py), in ms a frame."""
from pb.program_spans import idle_ms


def read(readout):
    return idle_ms(readout, "pass", "frames")
