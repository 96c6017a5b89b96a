"""chroma_upsample_ms_per_image: the chroma upsampling a decode, in ms:
the program's render.chroma_upsample spans (one a call of a stage of
render/pipeline.py:chroma_upsample_stage, 4 a 4:2:0 frame), summed
inside the window's decodes, over the decodes."""

from portbench.spans import span_ms_per_decode

UNIT = "ms"


def read(run):
    return span_ms_per_decode(run, ("render.chroma_upsample",))
