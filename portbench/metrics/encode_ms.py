"""The mean device span of a frame's scene encode (``encode_ref``: the
init net, the image and vis encoders and the gather map), from CUDA
events around the benchmark's calls, in ms."""
import statistics


def read(readout):
    spans = readout.spans.get("encode")
    return 1e3 * statistics.fmean(spans) if spans else None
