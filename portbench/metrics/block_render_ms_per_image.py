"""block_render_ms_per_image: the host's side of the chroma-subsampled
block render a decode, in ms: the program's render.blocks (the block
tables) and render.transforms (their upload and the dequant, chroma from
luma and inverse transforms queued) spans of
vardct/device_frame.py:render_vardct_frame_device_subsampled, summed
inside the window's decodes, over the decodes."""

from portbench.spans import span_ms_per_decode

UNIT = "ms"


def read(run):
    return span_ms_per_decode(run, ("render.blocks", "render.transforms"))
