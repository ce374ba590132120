"""The device's idle share of the traced finetuning window: one minus the
union of its device rows over the window, in %."""
from pb.readers import idle_pct


def read(readout):
    return idle_pct(readout)
