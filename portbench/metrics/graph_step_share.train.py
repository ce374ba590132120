"""The share of the training steps that the program replayed from CUDA
graphs: 100 x ``train.graph_steps`` / (``train.graph_steps`` +
``train.eager_steps``), the program's counters of its training step, in
%. None where the window counted neither (a program without them)."""
from pb.program_spans import read as program


def read(readout):
    ps = program(readout)
    if ps is None:
        return None
    graph = ps.counters.get("train.graph_steps", 0)
    eager = ps.counters.get("train.eager_steps", 0)
    return 100.0 * graph / (graph + eager) if graph + eager else None
