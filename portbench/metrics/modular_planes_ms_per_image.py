"""modular_planes_ms_per_image: a Modular frame's planes on the card a
decode, in ms: the program's render.modular_planes spans
(render/simple.py:frame_planes: the integer planes' upload and their
conversion to float queued), summed inside the window's decodes, over the
decodes."""

from portbench.spans import span_ms_per_decode

UNIT = "ms"


def read(run):
    return span_ms_per_decode(run, ("render.modular_planes",))
