"""The optimizer update's share of its bytes roofline: the bytes the
program counted at each Adam step (``adam.bytes``: 24 a parameter, the
parameter and its two f32 moments read and written once) over
3.35 TB/s, against the device's busy time inside the training step's
``step.update`` spans (pb/program_spans.py), in %."""
from pb import counts
from pb.program_spans import read as program


def read(readout):
    ps = program(readout)
    if ps is None:
        return None
    nbytes, busy = ps.counters.get("adam.bytes"), ps.busy_ns("step.update")
    if not nbytes or not busy:
        return None
    return 100.0 * nbytes / counts.HBM_BYTES_PER_S / (busy / 1e9)
