"""The 95th percentile of the window's training step times, each step
timed on the host from its call to its return (the step reads its loss
values back, so it ends when the card has), in ms."""
from pb.core import p95


def read(readout):
    steps = readout.spans.get("step")
    return 1e3 * p95(steps) if steps and len(steps) >= 20 else None
