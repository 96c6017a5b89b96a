"""Group-sharded render with halo exchange over torch.distributed.

Counterpart of jxl_tpu/parallel/sharded_render.py, whose shard_map
programs run one shard a TPU chip and exchange halos with `ppermute`.
Here each rank of a process group (parallel/__init__.py:World) holds its
shard on its own device and trades edge rows and columns with its
neighbours through World.exchange. A ShardGrid lays the ranks out as
jxl_tpu's meshes do: 1-D over rows (`make_grid`, its ("groups",) mesh) or
2-D (`make_grid_2d`, gy <= sqrt(n) rows of gx ranks, rank = sy * gx + sx).

A shard is extended by HALO = 8 rows (or columns) of its neighbours' real
pixels, then filtered by one launch of kernel K1 on the slab [halo |
shard | halo], and the halo is cropped. At the image's edges there is no
neighbour and no halo: K1 mirrors at the slab's edge, which is then the
image's, as it mirrors for the whole image. The filters' support is 7
pixels (gaborish 1, EPF 3 + 2 + 1), so an 8-pixel halo gives the shard's
pixels exactly, and keeps the slab on the 8x8 block grid that K1 reads
EPF's block phase from. jxl_tpu extends by 9 rows and shifts the phase
(`pos`) in its stage math instead; and it mirrors the halo at the edges
before filtering, which rounds a few pixels apart from the whole image
(its dry run's 1e-5 check fails, ROADMAP queue 3). Here the sharded
result equals the whole image's bit for bit.

sharded_vardct_frame gives each rank a rectangle of whole groups of a
4:4:4 VarDCT frame, with the group grid padded to tile the rank grid as
jxl_tpu pads it. A rank renders its groups' blocks from its own
coefficients (vardct/device_frame.py:render_block_rows, the whole frame's
per-block math, its transforms in the frame's fixed-size chunks), crops
its tile to the visible frame, exchanges rows and then columns (so the
corners come along), filters, and runs the colour transform and the
output conversion with the dither tile at its corner. A tile beyond the
visible edge is cut at it, so K1 mirrors exactly where the whole frame
mirrors: jxl_tpu's visible-edge gather maps (`_edge_map`) have no
counterpart. Every rank then holds the whole frame (all_gather), as
jxl_tpu's result is replicated.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..errors import NotSupported
from ..render.stages import core as st

HALO = 8  # filter support 7 (gaborish 1 + EPF 3+2+1), rounded to the block grid


class ShardGrid:
    """The ranks of `world` as ny rows of nx: this rank sits at (sy, sx),
    rank = sy * nx + sx."""

    def __init__(self, world, ny: int, nx: int):
        if ny * nx != world.size:
            raise ValueError(f"a {ny}x{nx} grid needs {ny * nx} ranks, not {world.size}")
        self.world = world
        self.ny, self.nx = ny, nx
        self.sy, self.sx = divmod(world.rank, nx)

    def rank_at(self, sy: int, sx: int) -> int:
        return sy * self.nx + sx


def make_grid(world) -> ShardGrid:
    """Every rank a row shard (jxl_tpu's make_mesh, axis "groups")."""
    return ShardGrid(world, world.size, 1)


def make_grid_2d(world) -> ShardGrid:
    """gy rows of n // gy ranks, gy the largest divisor of n at most
    sqrt(n) (jxl_tpu's make_mesh_2d): 1x1, 1x2, 2x2, 2x4 ..."""
    n = world.size
    gy = max(d for d in range(1, int(n ** 0.5) + 1) if n % d == 0)
    return ShardGrid(world, gy, n // gy)


def _halos(grid: ShardGrid, x, halo: int, axis: int, extents: list) -> tuple:
    """The neighbours' edge lines of this rank's tile `x` (..., rows, cols)
    along grid axis `axis` (0: rows, from the ranks above and below; 1:
    columns, from the left and right). extents[i] is the length of shard
    i along the axis (0 for a shard past the image). Returns (before,
    after): `halo` lines each (all a shorter neighbour has), or None where
    there is no neighbour. A shard that is not the last with lines must
    hold at least `halo` of them."""
    for i in range(len(extents) - 1):
        if extents[i + 1] and extents[i] < halo:
            raise ValueError(f"shard {i} holds {extents[i]} lines, fewer than the halo {halo}")
    i, count = (grid.sy, grid.ny) if axis == 0 else (grid.sx, grid.nx)
    dim = x.dim() - 2 + axis
    if x.shape[dim] != extents[i]:
        raise ValueError(f"tile of {x.shape[dim]} lines where the grid says {extents[i]}")

    def peer(j):
        return grid.rank_at(j, grid.sx) if axis == 0 else grid.rank_at(grid.sy, j)

    mine = extents[i]
    sends, recvs, where = [], [], []
    if mine and x.numel():
        k = min(halo, mine)
        for j, start in ((i - 1, 0), (i + 1, mine - k)):
            if 0 <= j < count and extents[j]:
                sends.append((peer(j), x.narrow(dim, start, k)))
                shape = list(x.shape)
                shape[dim] = min(halo, extents[j])
                recvs.append((peer(j), shape, x.dtype))
                where.append(j < i)
    got = grid.world.exchange(sends, recvs)
    before = next((t for t, b in zip(got, where) if b), None)
    after = next((t for t, b in zip(got, where) if not b), None)
    return before, after


def _extend(grid, x, halo: int, axis: int, extents: list) -> tuple:
    """x with its neighbours' halos joined along `axis`; and the count of
    lines joined before it."""
    before, after = _halos(grid, x, halo, axis, extents)
    dim = x.dim() - 2 + axis
    parts = [p for p in (before, x, after) if p is not None]
    return torch.cat(parts, dim=dim), 0 if before is None else before.shape[dim]


def exchange_halo_rows(x, halo: int, grid: ShardGrid):
    """jxl_tpu's exchange_halo_rows: x (..., rows, cols), this rank's row
    shard (every shard the same height), extended by `halo` rows from the
    shards above and below, mirrored (x[:halo] reversed) at the first and
    last shard. Returns (..., rows + 2 * halo, cols)."""
    before, after = _halos(grid, x, halo, 0, [x.shape[-2]] * grid.ny)
    top = before if before is not None else x[..., :halo, :].flip(-2)
    bottom = after if after is not None else x[..., -halo:, :].flip(-2)
    return torch.cat([top, x, bottom], dim=-2)


def exchange_halo_cols(x, halo: int, grid: ShardGrid):
    """jxl_tpu's exchange_halo_cols: the column counterpart, from the
    shards to the left and right."""
    before, after = _halos(grid, x, halo, 1, [x.shape[-1]] * grid.nx)
    left = before if before is not None else x[..., :halo].flip(-1)
    right = after if after is not None else x[..., -halo:].flip(-1)
    return torch.cat([left, x, right], dim=-1)


def row_spans(rows: int, n: int) -> list:
    """The rows [a, b) of each of n row shards of an image `rows` high:
    ceil(rows / n) rounded up to whole 8x8 blocks a shard, the last one
    the rest (jxl_tpu asks rows to split evenly into whole blocks)."""
    per = -(-(-(-rows // n)) // st.BLOCK_DIM) * st.BLOCK_DIM
    return [(min(i * per, rows), min((i + 1) * per, rows)) for i in range(n)]


def _row_extents(grid: ShardGrid, rows: int, shard_rows: int) -> tuple:
    """A 1-D grid's row extents for an image `rows` high, and this rank's
    first row; checks that its shard holds its span's rows."""
    if grid.nx != 1:
        raise ValueError(f"row shards take a grid of one column, not {grid.ny}x{grid.nx}")
    spans = row_spans(rows, grid.ny)
    a, b = spans[grid.sy]
    if shard_rows != b - a:
        raise ValueError(f"rank {grid.world.rank} holds {shard_rows} rows, not rows {a}:{b}")
    return [y1 - y0 for y0, y1 in spans], a


def sharded_render(grid: ShardGrid, params, planes, sigma_block, rows: int):
    """jxl_tpu's sharded_render on this rank's row shard of an image
    `rows` high: planes (3, r, W) float32 XYB, the rank's rows of
    row_spans(rows, grid.ny), and sigma_block (ceil(r / 8), W / 8) their
    1/sigma blocks. The 1/sigma travels with the planes, expanded to one
    value a pixel (4 planes of HALO rows each way). Returns the shard's
    sRGB (3, r, W) from ops/device_render.py:render_block on [halo | shard
    | halo]: the rows of render_block of the whole image, bit for bit."""
    from ..ops.device_render import _filter_px, _to_srgb

    r, w = planes.shape[1:]
    ext, _ = _row_extents(grid, rows, r)
    sig = st._expand_sigma(sigma_block, r, w, (0, 0))
    slab, top = _extend(grid, torch.cat([planes, sig[None]]), HALO, 0, ext)
    return _to_srgb(_filter_px(slab[:3], slab[3], params)[:, top : top + r], params)


def sharded_filters_and_color(grid: ShardGrid, frame, planes, sigma_px, rows: int,
                              pixel_format: str = "f32"):
    """jxl_tpu's sharded_filters_and_color on this rank's row shard of an
    image `rows` high: planes (3, r, W) float32 in the frame's colour
    space, the rank's rows of row_spans(rows, grid.ny), and sigma_px (r,
    W) their per-pixel 1/sigma. The 1/sigma travels with the planes (4
    planes of HALO rows each way), K1 filters the slab with the frame's
    weights (render/device_filters.py:filter_planes), then the colour
    transform and the output conversion with the dither tile at the
    shard's row. Returns the shard's (3, r, W) in `pixel_format`."""
    from ..render.device_band_filters import color_and_convert
    from ..render.device_filters import filter_planes

    r = planes.shape[1]
    ext, y0 = _row_extents(grid, rows, r)
    rf = frame.header.restoration_filter
    out = planes
    if rf.gab or rf.epf_iters:
        slab, top = _extend(grid, torch.cat([planes, sigma_px[None]]), HALO, 0, ext)
        out = filter_planes(frame, slab[:3], slab[3])[:, top : top + r]
    return torch.stack(color_and_convert(frame, out.contiguous().unbind(0), y0, pixel_format))


def gather_rows(grid: ShardGrid, shard):
    """The row shards of every rank joined in order: (..., sum of rows, W)
    on every rank."""
    return torch.cat(grid.world.all_gather(shard), dim=-2)


# -- the group-sharded VarDCT frame --------------------------------------------


@dataclass(frozen=True)
class Tile:
    """A rank's rectangle of a VarDCT frame: its groups in raster order
    (slot i of its coefficient buffer holds groups[i]), its block rect
    [by0, by1) x [bx0, bx1) and its visible pixels [y0, y1) x [x0, x1)
    (empty past the frame)."""

    groups: tuple
    blocks: tuple
    pixels: tuple

    @property
    def empty(self) -> bool:
        y0, y1, x0, x1 = self.pixels
        return y1 <= y0 or x1 <= x0


def _spans(n_groups: int, parts: int, blocks_per_group: int, n_blocks: int, n_px: int) -> list:
    """Each part's (groups, blocks, pixels) ranges along one axis: the
    group count padded to a multiple of `parts` (jxl_tpu's padded grid),
    each part ceil(n_groups / parts) groups, clipped to the frame."""
    per = -(-n_groups // parts)
    out = []
    for i in range(parts):
        g0, g1 = min(i * per, n_groups), min((i + 1) * per, n_groups)
        b0, b1 = g0 * blocks_per_group, min(g1 * blocks_per_group, n_blocks)
        p0, p1 = min(b0 * st.BLOCK_DIM, n_px), min(b1 * st.BLOCK_DIM, n_px)
        out.append(((g0, g1), (b0, b1), (p0, p1)))
    return out


def frame_tiles(grid: ShardGrid, frame) -> list:
    """Every rank's Tile of `frame`, in rank order."""
    header = frame.header
    gw, gh = header.size_groups()
    bw, bh = header.size_blocks()
    wv, hv = header.size()
    gb = header.group_dim // st.BLOCK_DIM
    rows = _spans(gh, grid.ny, gb, bh, hv)
    cols = _spans(gw, grid.nx, gb, bw, wv)
    tiles = []
    for (gy, by, py) in rows:
        for (gx, bx, px) in cols:
            groups = tuple(y * gw + x for y in range(*gy) for x in range(*gx))
            tiles.append(Tile(groups, by + bx, py + px))
    return tiles


def check_frame(frame) -> None:
    """Raise NotSupported for a frame sharded_vardct_frame cannot take: it
    takes a 4:4:4 VarDCT frame with no upsampling, extra channels,
    patches, splines or noise (stages that are not per-tile)."""
    from ..io.headers.frame import Encoding

    h = frame.header
    if h.encoding != Encoding.VARDCT or not h.is444:
        raise NotSupported("the sharded frame takes a 4:4:4 VarDCT frame")
    if h.upsampling != 1 or h.num_extra_channels or h.has_patches or h.has_splines \
            or h.has_noise:
        raise NotSupported("the sharded frame takes no upsampling, extra channels, "
                           "patches, splines or noise")


def sharded_vardct_frame(grid: ShardGrid, frame, coeffs, pixel_format: str = "f32"):
    """Coefficients -> dequant + CfL + IDCT -> halo exchange -> gaborish +
    EPF -> colour -> `pixel_format`, over the grid (jxl_tpu's
    sharded_vardct_frame). coeffs: this rank's dense int32 coefficient
    buffer on its device, slot i for group frame_tiles(grid,
    frame)[rank].groups[i] (api/banded.py:BandSource.coefficients gives
    it: K3 over the rank's own lanes on the card). Returns the visible
    frame (3, H, W) on every rank, equal bit for bit to decode_image's."""
    from ..render.device_band_filters import color_and_convert
    from ..render.device_filters import run_filters
    from ..render.pipeline import sigma_source
    from ..vardct.device_frame import render_block_rows

    check_frame(frame)
    tiles = frame_tiles(grid, frame)
    tile = tiles[grid.world.rank]
    y0, y1, x0, x1 = tile.pixels
    dev = grid.world.device
    row_ext = [t.pixels[1] - t.pixels[0] for t in tiles[:: grid.nx]]  # grid column 0
    col_ext = [t.pixels[3] - t.pixels[2] for t in tiles[: grid.nx]]  # grid row 0
    if tile.empty:
        planes = torch.zeros((3, y1 - y0, x1 - x0), device=dev)
    else:
        by0, by1, bx0, bx1 = tile.blocks
        planes = render_block_rows(frame, coeffs, list(tile.groups), by0, by1,
                                   bx0=bx0, bx1=bx1)[:, : y1 - y0, : x1 - x0]
    rf = frame.header.restoration_filter
    if rf.gab or rf.epf_iters:
        # rows, then the row-extended tile's columns (the corners come
        # along); an empty tile's neighbours on each axis are empty too
        planes, top = _extend(grid, planes, HALO, 0, row_ext)
        planes, left = _extend(grid, planes, HALO, 1, col_ext)
        if not tile.empty:
            planes = run_filters(frame, planes, y0 - top, sigma_source(frame), x0 - left)
            planes = planes[:, top : top + y1 - y0, left : left + x1 - x0]
    out = torch.stack(color_and_convert(frame, planes.contiguous().unbind(0), y0, pixel_format,
                                        x0=x0))
    full = torch.empty((3, frame.header.size()[1], frame.header.size()[0]),
                       dtype=out.dtype, device=dev)
    for t, part in zip(tiles, grid.world.all_gather(out)):
        if not t.empty:
            ty0, ty1, tx0, tx1 = t.pixels
            full[:, ty0:ty1, tx0:tx1] = part
    return full


def decode_sharded(data: bytes, grid: ShardGrid, pixel_format: str = "f32"):
    """Decode a file of one 4:4:4 VarDCT frame (an ICC profile read, a
    preview skipped) over the grid, on each rank's device: every rank
    parses the headers, LfGlobal, LF groups and HfGlobal (host work, the
    same on every rank), decodes the AC of its own groups only (K3 over
    their lanes into a rank-sized buffer on the card; the native host
    decoder with JXL_TPU_AC=host), then sharded_vardct_frame. Returns the
    (H, W, 3) frame in `pixel_format` on every rank, decode_image's frame
    bit for bit; raises NotSupported for any other file, and the lane
    decoder's error on a corrupt section."""
    from ..api.banded import BandSource, decode_lf_sections
    from ..api.simple import PIXEL_FORMATS, parse_frame
    from ..io.bit_reader import BitReader
    from ..io.container import extract_codestream
    from ..io.headers import FileHeader
    from ..io.headers.frame import FrameType
    from ..render.simple import apply_orientation

    if pixel_format not in PIXEL_FORMATS:
        raise ValueError(f"unknown pixel format {pixel_format!r}")
    br = BitReader(extract_codestream(data))
    fh = FileHeader.read(br)
    meta = fh.image_metadata
    if meta.color_encoding.want_icc:
        from ..icc.decode import read_icc

        read_icc(br)
    if meta.preview is not None:
        pframe = parse_frame(br, fh, None, preview=True)
        br.jump_to_byte_boundary()
        br.skip_bits(pframe.toc.total_size * 8)
    br.jump_to_byte_boundary()
    frame = parse_frame(br, fh)
    h = frame.header
    if (h.frame_type != FrameType.REGULAR or not h.is_last or h.needs_blending()
            or h.x0 or h.y0 or tuple(h.size()) != (fh.xsize, fh.ysize)):
        raise NotSupported("the sharded decode takes a file of one whole frame")
    check_frame(frame)
    dev = grid.world.device
    sections = frame.split_sections(br)
    decode_lf_sections(frame, sections.__getitem__)
    source = BandSource(frame, sections.__getitem__, dev)
    tile = frame_tiles(grid, frame)[grid.world.rank]
    coeffs = source.coefficients(list(tile.groups))[0] if tile.groups else \
        torch.zeros(0, dtype=torch.int32, device=dev)
    out = sharded_vardct_frame(grid, frame, coeffs, pixel_format)
    source.check()
    return apply_orientation(out.permute(1, 2, 0), meta.orientation)
