"""The plain reference of the rgb_lossless configurations: the 8-bit RGB
image of a lossless Modular frame, rebuilt from what the benchmark's
writer put in the stream (writers/rgb_lossless.py: each group's residuals
and RCT, the MA tree and the weighted predictor's header), in plain torch
int64 on one device. Nothing here reads the stream's bits or imports the
decoder.

The steps, as ISO/IEC 18181-1 defines them for such a frame (Annex H,
modular image decoding):

- each group's channels (the RCT's coded channels 0, 1, 2) in turn, each
  sample the prediction of the leaf the MA tree gives it plus its
  residual (offset 0, multiplier 1);
- the tree reads property 0 (the channel), 10-14 (W - NW, NW - N, N -
  NE, N - NN, W - WW) and 15 (the weighted predictor's max error); the
  neighbours follow the edge rules: W of the first column is N (0 in
  the first row), N, NW and NE of the first row are W, NW of the first
  column is W, NE past the last column is N, NN of the first two rows is
  N, WW of the first two columns is W;
- Gradient is W + N - NW clamped to [min(W, N), max(W, N)];
- the weighted predictor runs on every sample of a channel from a fresh
  state: four sub-predictions from the neighbours and the true errors
  at W, N, NW and NE, weighted by the sub-predictors' summed errors at
  N, W, NW, WW and NE (the first column's NW and the last column's NE
  being N's, and W's errors adding to the column east of each sample's
  N; libjxl's weighted.h keeps these sums in a row buffer), clamped to
  the neighbours' range unless the errors' signs differ, rounded from 3
  fractional bits;
- the inverse RCT of each group (permutation 0; types 1-5 add channel 0
  back, type 6 is YCoCg), then the groups placed on the image.

Every sample of a channel depends on earlier samples only through W, N,
NW, NE, NN and WW, so the reference steps along the wavefronts x + 2y,
all groups and channels of one wavefront at once. No departure from the
format: the result is the image exactly, returned as float32 for the
benchmark's comparison.

precision="int32" is the control of the benchmark's comparison: the
weighted predictor's weighted sum times its reciprocal computed in 32-bit
integers (wrapping), the precision below the 64-bit products the format's
predictor takes.
"""

from __future__ import annotations

import numpy as np
import torch

D = 256  # the group side
EXTRA = 3  # the weighted predictor's fractional bits
DIV = [(1 << 24) // (i + 1) for i in range(64)]


def _floor_log2(v):
    """floor(log2 v) of positive int64 values."""
    out = torch.zeros_like(v)
    for b in (32, 16, 8, 4, 2, 1):
        big = v >= (1 << b)
        v = torch.where(big, v >> b, v)
        out = out + big.to(v.dtype) * b
    return out


def _walk(node, props: dict):
    """(predictor (L, n)) of the leaf each sample reaches."""
    if node[0] == "leaf":
        return torch.full_like(props[15], node[1])
    return torch.where(props[node[1]] > node[2], _walk(node[3], props), _walk(node[4], props))


def _inverse_rct(v0, v1, v2, op: int):
    if op == 0:
        return v0, v1, v2
    if op == 6:  # YCoCg
        y = v0 - (v2 >> 1)
        g = v2 + y
        b = y - (v1 >> 1)
        return b + v1, g, b
    if op in (1, 3, 5):
        v2 = v2 + v0
    if op in (2, 3):
        v1 = v1 + v0
    if op in (4, 5):
        v1 = v1 + ((v0 + v2) >> 1)
    return v0, v1, v2


def reconstruct(coded, device, precision: str = "int64") -> torch.Tensor:
    """Each group's coded channels (G, 3, D, D) int64, from its residuals
    through the tree's predictions."""
    res = torch.from_numpy(np.asarray(coded["residuals"], np.int64)).to(device)
    G = res.shape[0]
    L = G * 3
    res = res.reshape(L, D, D)
    widths = torch.tensor([r[2] for r in coded["rects"] for _ in range(3)], device=device)
    chan = torch.arange(L, device=device) % 3
    tree = coded["tree"]
    p1c, p2c, p3a, p3b, p3c, p3d, p3e = coded["wp"][:7]
    wts = torch.tensor(coded["wp"][7:], dtype=torch.int64, device=device)[:, None, None]
    div = torch.tensor(DIV, dtype=torch.int64, device=device)
    val = torch.zeros((L, D, D), dtype=torch.int64, device=device)
    terr = torch.zeros_like(val)  # true errors, << EXTRA
    serr = torch.zeros((4, L, D, D), dtype=torch.int64, device=device)  # sub-predictors'
    rows = max(r[3] for r in coded["rects"])
    z = 0
    for d in range(D + 2 * rows - 2):
        lo, hi = max(0, (d - D + 2) // 2), min(rows - 1, d // 2)
        y = torch.arange(lo, hi + 1, device=device)
        x = d - 2 * y
        up, lf = y > 0, x > 0
        ym, xm = (y - 1).clamp(min=0), (x - 1).clamp(min=0)
        xp = torch.minimum(x[None, :] + 1, widths[:, None] - 1)  # (L, n): NE's column
        last = x[None, :] + 1 >= widths[:, None]
        lanes = torch.arange(L, device=device)[:, None]

        def at(plane, yy, xx):
            return plane[lanes, yy, xx] if xx.dim() == 2 else plane[:, yy, xx]

        # the neighbourhood with the edge rules
        w = torch.where(lf, val[:, y, xm], torch.where(up, val[:, ym, x], z))
        n = torch.where(up, val[:, ym, x], w)
        nw = torch.where(up & lf, val[:, ym, xm], w)
        ne = torch.where(up, torch.where(last, n, at(val, ym[None, :].expand(L, -1), xp)), w)
        nn = torch.where(y > 1, val[:, (y - 2).clamp(min=0), x], n)
        ww = torch.where(x > 1, val[:, y, (x - 2).clamp(min=0)], w)
        # the weighted predictor
        e_w = torch.where(lf, terr[:, y, xm], z)
        e_n = torch.where(up, terr[:, ym, x], z)
        e_nw = torch.where(up, terr[:, ym, xm], z)
        e_ne = torch.where(up, at(terr, ym[None, :].expand(L, -1), xp), z)

        def t_sum(xx):  # the sub-predictors' errors at (xx, y - 1) and (xx - 1, y)
            above = torch.where(up, serr[:, :, ym, xx], z)
            return above + torch.where(xx > 0, serr[:, :, y, (xx - 1).clamp(min=0)], z)

        here = t_sum(x)
        ne_above = torch.where(up, serr[:, lanes, ym[None, :].expand(L, -1), xp], z)
        e_sum = here + t_sum(xm) + torch.where(last, here, ne_above)
        sh = (_floor_log2(e_sum + 1) - 5).clamp(min=0)
        ws = 4 + ((wts * div[e_sum >> sh]) >> sh)
        n8, w8, ne8, nw8, nn8 = (v << EXTRA for v in (n, w, ne, nw, nn))
        sub = torch.stack([
            w8 + ne8 - n8,
            n8 - (((e_w + e_n + e_ne) * p1c) >> 5),
            w8 - (((e_w + e_n + e_nw) * p2c) >> 5),
            n8 - ((e_nw * p3a + e_n * p3b + e_ne * p3c + (nn8 - n8) * p3d
                   + (nw8 - w8) * p3e) >> 5)])
        ws = ws >> (_floor_log2(ws.sum(0)) - 4)
        wsum = ws.sum(0)
        acc = (wsum >> 1) - 1 + (ws * sub).sum(0)
        if precision == "int32":
            wp = ((acc.to(torch.int32) * div[wsum - 1].to(torch.int32)) >> 24).to(torch.int64)
        else:
            wp = (acc * div[wsum - 1]) >> 24
        lo_b = torch.minimum(torch.minimum(w8, ne8), n8)
        hi_b = torch.maximum(torch.maximum(w8, ne8), n8)
        wp = torch.where(((e_n ^ e_w) | (e_n ^ e_nw)) <= 0,
                         torch.minimum(torch.maximum(wp, lo_b), hi_b), wp)
        mx = e_w
        for e in (e_n, e_nw, e_ne):
            mx = torch.where(e.abs() > mx.abs(), e, mx)
        # the tree and the sample
        props = {0: chan[:, None].expand(L, len(y)), 10: w - nw, 11: nw - n, 12: n - ne,
                 13: n - nn, 14: w - ww, 15: mx}
        pred = _walk(tree, props)
        grad = torch.minimum(torch.maximum(w + n - nw, torch.minimum(w, n)), torch.maximum(w, n))
        v = torch.where(pred == 6, (wp + ((1 << EXTRA) >> 1) - 1) >> EXTRA, grad) + res[:, y, x]
        val[:, y, x] = v
        terr[:, y, x] = wp - (v << EXTRA)
        serr[:, :, y, x] = ((sub - (v << EXTRA)[None]).abs() + ((1 << EXTRA) >> 1) - 1) >> EXTRA
    return val.reshape(G, 3, D, D)


def render(coded, width: int, height: int, device, precision: str = "int64") -> torch.Tensor:
    """The (height, width, 3) float32 image on `device`: each sample's
    8-bit value exactly (with precision="int64")."""
    if precision not in ("int64", "int32"):
        raise ValueError(f"precision: int64 or int32, not {precision!r}")
    lanes = reconstruct(coded, device, precision)
    out = torch.zeros((height, width, 3), dtype=torch.float32, device=device)
    rcts = [int(r) for r in np.asarray(coded["rct"]).tolist()]
    for g, (x0, y0, w, h) in enumerate(coded["rects"]):
        rgb = _inverse_rct(*lanes[g, :, :h, :w].unbind(0), rcts[g])
        out[y0 : y0 + h, x0 : x0 + w] = torch.stack(rgb, -1).to(torch.float32)
    return out
