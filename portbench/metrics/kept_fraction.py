"""The share of a focus frame's rays that the probe keeps and the focus
passes render, over the window's frames (a fraction, 1 = every ray)."""


def read(readout):
    rays = readout.counters.get("rays")
    return readout.counters["kept_rays"] / rays if rays else None
