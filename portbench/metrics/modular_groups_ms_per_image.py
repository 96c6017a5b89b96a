"""modular_groups_ms_per_image: the group sections of a Modular frame a
decode, in ms: the program's frame.modular_groups spans
(api/frame.py:_decode_modular_sections: each group's entropy decode,
prediction and inverse transforms, over the host pool), summed inside the
window's decodes, over the decodes."""

from portbench.spans import span_ms_per_decode

UNIT = "ms"


def read(run):
    return span_ms_per_decode(run, ("frame.modular_groups",))
