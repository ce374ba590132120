"""The device's busy time inside the program's ``ft.encode`` spans (a
finetuning step's encode of its reference views' selected ``ray_feats``
with their images, their gather maps, and the query view's own encode
for the self-hit path; pb/program_spans.py), in ms a step."""
from pb.program_spans import busy_ms


def read(readout):
    return busy_ms(readout, "ft.encode", "steps")
