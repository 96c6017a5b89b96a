"""Per-band VarDCT dequant + CfL + IDCT on the coefficient buffer's device.

The counterpart of jxl_tpu/vardct/device_band.py (BandRenderer :110,
_band_blocks :65): one GROUP ROW of a 4:4:4 frame at a time, for the
banded decode (api/banded.py). A band's pixels come from the same
per-block functions as the whole frame's
(vardct/device_frame.py:render_block_rows), so they are the frame's
pixels in those rows. The band's coefficients are a
band-sized dense buffer (the band's groups in order, gx_count * 3 * GD *
GD int32), and only the band's rows of the LF, the raw quant and the
colour tiles go up, so the card holds O(band), not O(image). The JAX
package pads its index arrays to power-of-two buckets so that XLA
compiles a few static shapes; torch runs each band at its own shapes.
"""

from __future__ import annotations

import numpy as np

from .device_frame import BLOCK_DIM, _matrices, render_block_rows
from .group import BLOCK_SIZE, GROUP_DIM
from .transform_map import covered_blocks_x, covered_blocks_y

BAND_BLOCKS = GROUP_DIM // BLOCK_DIM  # block rows a band (32)


def band_groups(frame, gy: int) -> list:
    """The groups of group row gy, left to right: slot i of a band's
    coefficient buffer holds group band_groups(frame, gy)[i]."""
    gx_count = frame.header.size_groups()[0]
    return list(range(gy * gx_count, (gy + 1) * gx_count))


def band_block_rows(frame, gy: int) -> tuple:
    """Block rows [by0, by1) of group row gy."""
    bh = frame.header.size_blocks()[1]
    return gy * BAND_BLOCKS, min((gy + 1) * BAND_BLOCKS, bh)


class BandRenderer:
    """Renders a frame's bands: render(gy, flat) -> (3, rows8, bw*8)
    float32 planes on flat's device, rows8 = 8 * the band's block rows
    (256 but for the last band), the coded rows of group row gy before
    the visible crop. The dequant weights of the frame's transform types
    are made once, at the first band that uses each type."""

    def __init__(self, frame):
        self.frame = frame
        self._mats = {}

    def _matrices(self, gy: int) -> dict:
        frame = self.frame
        tmap = frame.hf_meta["transform"]
        by0, by1 = band_block_rows(frame, gy)
        band = tmap[by0:by1]
        for t in set(np.unique(band[band >= 128] & 127).tolist()) - set(self._mats):
            nc = covered_blocks_x(t) * covered_blocks_y(t) * BLOCK_SIZE
            self._mats[t] = _matrices(frame, t, nc)
        return self._mats

    def render(self, gy: int, flat):
        """Group row gy's planes from `flat`, its dense band buffer."""
        return render_block_rows(self.frame, flat, band_groups(self.frame, gy),
                                 *band_block_rows(self.frame, gy), self._matrices(gy))
