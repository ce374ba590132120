"""The share of the render passes that the program replayed from CUDA
graphs: 100 x ``render.graph_passes`` / (``render.graph_passes`` +
``render.eager_passes``), the program's counters of its exact chunk
step, in %. None where the window counted neither (a program without
them)."""
from pb.program_spans import read as program


def read(readout):
    ps = program(readout)
    if ps is None:
        return None
    graph = ps.counters.get("render.graph_passes", 0)
    eager = ps.counters.get("render.eager_passes", 0)
    return 100.0 * graph / (graph + eager) if graph + eager else None
