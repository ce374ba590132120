"""The arithmetic the per-layer readers share. Each returns None where
the run has nothing to read, and the reader then leaves its metric out
of the line; none returns 0 for a share."""
from __future__ import annotations

from pb import counts

# the gather kernel's device rows (csrc/gather_bilinear_border.cu): the
# forward, and the backward's binning and accumulation kernels; the
# backward's count memset is one of the window's memsets, all of which
# are charged to the backward (its time can only be overstated)
FORWARD = ("gather_lanes",)
BACKWARD = ("bin_points", "accumulate_tiles", "Memset")


def idle_pct(readout):
    tr = readout.trace
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def mfu_pct(readout):
    flops = readout.counters.get("flops")
    if not flops:
        return None
    peak = counts.PEAK_FLOPS[readout.workload.get(
        "precision", readout.config["precision"])]
    return 100.0 * flops / readout.trace.window_s / peak


def roofline_pct(readout, bytes_key, kernels):
    nbytes = readout.counters.get(bytes_key)
    busy = readout.trace.kernel_s(*kernels)
    if not nbytes or busy <= 0:
        return None
    return 100.0 * nbytes / counts.HBM_BYTES_PER_S / busy
