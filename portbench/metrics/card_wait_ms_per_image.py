"""card_wait_ms_per_image: the time a decode's host is blocked on the
card inside the program, in ms: the read of K3's lane flags
(render.ac_wait), which waits for K3 and the render queued before it,
summed inside the window's decodes, over the decodes."""

from portbench.spans import span_ms_per_decode

UNIT = "ms"


def read(run):
    return span_ms_per_decode(run, ("render.ac_wait",))
