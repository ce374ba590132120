"""The device's idle time in gaps that began while the host was inside
the training step's ``step.backward`` span:
the backward and the zero gradients' fill (the spans inside it included;
pb/program_spans.py), in ms a step."""
from pb.program_spans import idle_ms


def read(readout):
    return idle_ms(readout, "step.backward", "steps")
