"""Cross-frame decoder state: reference frames, LF frames, frame counters.

Capability reference: jxl/src/frame/mod.rs (DecoderState) — 4 reference
slots + 4 LF-frame slots carried across frames; visible/nonvisible frame
indices seed the noise RNG. A reference slot holds its planes as one
(C, H, W) float32 tensor on the decode's device, a copy that no later
stage or frame writes; an LF slot holds an LF frame's three colour planes
as one (3, H, W) float32 tensor there, before the colour transform.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_STORED_FRAMES = 4


class DecoderState:
    def __init__(self, file_header, options=None):
        self.file_header = file_header
        # each slot: {"frame": (C, H, W) tensor, "saved_before_color_transform": bool}
        self.reference_frames = [None] * MAX_STORED_FRAMES
        self.lf_frames = [None] * MAX_STORED_FRAMES  # (3, H, W) tensors
        self.visible_frame_index = 0
        self.nonvisible_frame_index = 0
        self.options = options
        self.render_spotcolors = True
        self.premultiply_output = False
        self.high_precision = False

    @property
    def extra_channel_info(self):
        return self.file_header.image_metadata.extra_channel_info

    def save_reference(self, slot: int, planes, before_ct: bool) -> None:
        """Keep `planes` (a list of same-shape 2-D tensors) in reference
        slot `slot`. torch.stack copies them, so the slot shares no storage
        with the frame's planes, which later stages write in place."""
        self.reference_frames[slot] = {
            "frame": torch.stack(list(planes)).to(torch.float32),
            "saved_before_color_transform": before_ct,
        }

    def save_lf_frame(self, lf_level: int, planes) -> None:
        """Keep an LF frame's first three planes (before the colour
        transform) in LF slot lf_level - 1, a copy on their device (ref
        jxl_tpu/api/simple.py:174-175)."""
        self.lf_frames[lf_level - 1] = torch.stack(list(planes[:3])).to(torch.float32)


def state_from_numpy(ref_state, device) -> DecoderState:
    """This package's DecoderState carrying the reference and LF slots and
    the frame counters of `ref_state`, a jxl_tpu DecoderState (numpy
    planes), with each slot's planes stacked into one float32 tensor on
    `device`: the decoder's counterpart of carrying weights across, so
    that the patch, blend and LF steps can run on the reference's own
    state."""
    state = DecoderState(ref_state.file_header)
    for i, rf in enumerate(ref_state.reference_frames):
        if rf is None:
            continue
        planes = np.stack([np.asarray(p, dtype=np.float32) for p in rf["frame"]])
        state.reference_frames[i] = {
            "frame": torch.from_numpy(planes).to(device),
            "saved_before_color_transform": bool(rf["saved_before_color_transform"]),
        }
    for i, lf in enumerate(ref_state.lf_frames):
        if lf is not None:
            planes = np.stack([np.asarray(p, dtype=np.float32) for p in lf[:3]])
            state.lf_frames[i] = torch.from_numpy(planes).to(device)
    state.visible_frame_index = ref_state.visible_frame_index
    state.nonvisible_frame_index = ref_state.nonvisible_frame_index
    return state
