"""parse_ms_per_image: the host parse a decode, in ms: the file's and
each frame's headers and TOC (decode_image.headers), LfGlobal
(frame.lf_global), the LF groups (frame.lf_groups) and HfGlobal with the
LF smoothing (frame.hf_global), the program's own spans, summed inside
the window's decodes, over the decodes."""

from portbench.spans import span_ms_per_decode

UNIT = "ms"
SPANS = ("decode_image.headers", "frame.lf_global", "frame.lf_groups", "frame.hf_global")


def read(run):
    return span_ms_per_decode(run, SPANS)
