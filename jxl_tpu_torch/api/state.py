"""Cross-frame decoder state: reference frames, LF frames, frame counters.

Capability reference: jxl/src/frame/mod.rs (DecoderState) — 4 reference
slots + 4 LF-frame slots carried across frames; visible/nonvisible frame
indices seed the noise RNG.
"""

from __future__ import annotations

MAX_STORED_FRAMES = 4


class DecoderState:
    def __init__(self, file_header, options=None):
        self.file_header = file_header
        # each slot: {"frame": [np planes], "saved_before_color_transform": bool}
        self.reference_frames = [None] * MAX_STORED_FRAMES
        self.lf_frames = [None] * MAX_STORED_FRAMES  # [3] planes each
        self.visible_frame_index = 0
        self.nonvisible_frame_index = 0
        self.options = options
        self.render_spotcolors = True
        self.premultiply_output = False
        self.high_precision = False

    @property
    def extra_channel_info(self):
        return self.file_header.image_metadata.extra_channel_info
