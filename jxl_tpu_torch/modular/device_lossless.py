"""Reconstruction lanes for channel-static lossless Modular.

Counterpart of jxl_tpu/modular/device_lossless.py. Most lossless pixels
flow through channel-split trees whose leaves are static simple
predictors (Zero, West, North or Gradient, offset 0, multiplier 1;
modular/tree.py:is_channel_static). The native decoder can emit such a
stream's raw residuals (residual mode) and leave the prediction to a lane
chosen per channel:

- Zero: identity, the residuals are the pixels.
- West and North: two cumsums each (ops/lossless_lanes.py:cumsum_west,
  cumsum_north), exact for any residuals (int32 sums wrap alike in any
  order).
- Gradient: the clamped-gradient wavefront, K4 on the card
  (csrc/lossless_lanes.cu; ops/lossless_lanes.py:gradient_wavefront),
  its plain torch version on the CPU. By induction along the diagonals a
  sample's magnitude grows by at most max|r| a diagonal, so with
  3 * (h + w - 1) * max|r| < 2^31 no sum overflows and the lane equals the
  native loop. A channel over that gate is reconstructed on the host
  (native.gradient_reconstruct) before anything is submitted: the gate is
  a choice made from the residuals, never a retry.

The host entropy loop emits the residuals; channels collect in buckets
by predictor, and a full bucket goes to the decode's device at once
(int16 on the wire when the residuals fit, one copy from a page-locked
buffer) while the host decodes later sections; flush() brings the samples
back into the channels' views. Unlike jxl_tpu nothing falls back: an error
on the card raises.

Only the whole-frame decode takes the lanes: api/frame.py:
decode_all_sections activates a BatchContext around a Modular frame's
sections, flushes it, then runs the transforms. The streaming decoder's
section-by-section path and decode_banded's band frame decode outside it
and keep the host path. JXL_TPU_DEV_LOSSLESS (the variable jxl_tpu
reads): 1 takes the lanes on the decode's device, 0 never, auto (the
default) as `enabled` says.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading

import numpy as np
import torch

MAX_DIM = 2048
MIN_STREAM_PX = 2048  # tiny streams decode faster fully on host
# a bucket goes to the device at this many lanes or int32 bytes
MAX_CHUNK_LANES = 128
MAX_CHUNK_BYTES = 128 << 20

_PRED_ZERO, _PRED_WEST, _PRED_NORTH, _PRED_GRADIENT = 0, 1, 2, 5

# the BatchContext of the section decode running in this context;
# api/frame.py:run_parallel runs each group in a copy of the caller's
# context, so a frame's worker threads see its BatchContext and no other
# decode's
_active: contextvars.ContextVar = contextvars.ContextVar("jxl_lossless_batch", default=None)


@contextlib.contextmanager
def activate(ctx: "BatchContext | None"):
    """Route eligible modular sub-bitstreams through `ctx` within the
    `with` body (decode_modular_subbitstream consults the active context;
    None routes none). Call ctx.flush() after the body, before
    run_transforms."""
    token = _active.set(ctx)
    try:
        yield ctx
    finally:
        _active.reset(token)


class BatchContext:
    """Collects the channels of residual-decoded channel-static streams
    and reconstructs them on `device` a bucket at a time; flush() writes
    the samples back into the submitted channel views."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._lock = threading.Lock()
        # predictor -> [(channel view, max |residual|)] not yet dispatched
        self._buckets: dict = {}
        self._inflight: list = []  # (samples on the device, [(view, offset)])
        self.lanes_device = 0
        self.lanes_host = 0
        self.lanes_identity = 0  # Zero predictor: the residuals are the pixels
        self.px_device = 0
        self.px_identity = 0
        self.px_host = 0
        self.px_ineligible = 0  # streams the lanes cannot take (WP etc.)
        self.upload_bytes = 0
        self.download_bytes = 0
        self.cumsum_calls = 0  # torch cumsum lanes run, one a shape a dispatch

    # -- submission (called from decode_modular_subbitstream) ----------

    def submit(self, local_buffers, tree, header, transform_steps, br,
               stream_id, image_width, partial_out) -> bool:
        """Residual-decode one eligible stream and enqueue its channels.
        Returns False (the caller decodes normally) when ineligible;
        raises bitstream errors as the normal path does."""
        from .. import native
        from ..errors import JxlError
        from ..utils import trace

        if transform_steps:
            return False
        if not tree.is_channel_static:
            return False
        live = [(ci, b) for ci, b in enumerate(local_buffers) if b.data.size > 0]
        if not live:
            return False
        if any(b.data.shape[0] > MAX_DIM or b.data.shape[1] > MAX_DIM for _, b in live):
            return False
        if sum(b.data.size for _, b in live) < MIN_STREAM_PX:
            return False

        preds = [tree.leaf_predictor_for_channel(ci) for ci, _ in live]
        try:
            with trace.span("lossless.residual_decode"):
                native.decode_modular_native(
                    local_buffers, stream_id, header, tree, br, image_width,
                    partial_out, residuals=True,
                )
        except JxlError:
            # the channels decoded before the error hold residuals (complete
            # ones): reconstruct them, so a partial render sees pixels
            if partial_out is not None:
                done = dict(zip((ci for ci, _ in live), preds))
                for ci, b in enumerate(local_buffers[: partial_out[0]]):
                    if b.data.size:
                        _reconstruct_host(b.data, done.get(ci, _PRED_GRADIENT))
            raise

        with self._lock, trace.span("lossless.enqueue"):
            for (_, b), pred in zip(live, preds):
                if pred == _PRED_ZERO:
                    self.lanes_identity += 1
                    self.px_identity += b.data.size
                    continue
                h, w = b.data.shape
                amax = int(np.abs(b.data).max(initial=0))
                if pred == _PRED_GRADIENT and amax >= (1 << 31) // (3 * (h + w - 1)):
                    # the overflow gate (module docstring)
                    _reconstruct_host(b.data, pred)
                    self.lanes_host += 1
                    self.px_host += b.data.size
                    continue
                self.px_device += b.data.size
                pend = self._buckets.setdefault(pred, [])
                pend.append((b.data, amax))
                if (len(pend) >= MAX_CHUNK_LANES
                        or 4 * sum(v.size for v, _ in pend) >= MAX_CHUNK_BYTES):
                    self._dispatch(pred, pend)
                    self._buckets[pred] = []
        return True

    # -- dispatch ------------------------------------------------------

    def _dispatch(self, pred: int, pend) -> None:
        """Pack one bucket's residuals back to back, lanes of one shape
        together, upload them and queue their reconstruction."""
        from ..utils import trace

        with trace.span("lossless.dispatch"):
            pend = sorted(pend, key=lambda p: p[0].shape)
            amax = max(a for _, a in pend)
            n = sum(v.size for v, _ in pend)
            card = self.device.type == "cuda"
            host = torch.empty(n, dtype=torch.int16 if amax < 32768 else torch.int32,
                               pin_memory=card)
            view = host.numpy()
            targets, pos = [], 0
            for v, _ in pend:
                view[pos : pos + v.size].reshape(v.shape)[...] = v
                targets.append((v, pos))
                pos += v.size
            res = host.to(self.device, non_blocking=True) if card else host
            self.upload_bytes += host.numel() * host.element_size()
            dims = [v.shape for v, _ in pend]
            out = reconstruct_lanes(pred, res, dims)
            if pred != _PRED_GRADIENT:
                self.cumsum_calls += len({tuple(d) for d in dims})
            self._inflight.append((out, targets))
            self.lanes_device += len(pend)

    def flush(self) -> None:
        """Dispatch what the buckets hold, wait for every dispatch, and
        write the samples back into the submitted channel views."""
        from ..utils import trace

        with self._lock:
            for pred, pend in list(self._buckets.items()):
                if pend:
                    self._dispatch(pred, pend)
            self._buckets.clear()
            inflight, self._inflight = self._inflight, []
        card = self.device.type == "cuda"
        back = []
        with trace.span("lossless.flush_wait"):
            for out, targets in inflight:
                host = out
                if card:
                    host = torch.empty(out.numel(), dtype=torch.int32, pin_memory=True)
                    host.copy_(out, non_blocking=True)
                self.download_bytes += out.numel() * 4
                back.append((host, targets))
            if card and back:
                torch.cuda.current_stream(self.device).synchronize()
        with trace.span("lossless.write_back"):
            for host, targets in back:
                flat = host.numpy()
                for v, pos in targets:
                    v[...] = flat[pos : pos + v.size].reshape(v.shape)
        for name, value in (("lossless_device_lanes", self.lanes_device),
                            ("lossless_identity_lanes", self.lanes_identity),
                            ("lossless_host_lanes", self.lanes_host),
                            ("lossless_px_device", self.px_device),
                            ("lossless_px_identity", self.px_identity),
                            ("lossless_px_host", self.px_host),
                            ("lossless_px_ineligible", self.px_ineligible),
                            ("lossless_upload_bytes", self.upload_bytes),
                            ("lossless_download_bytes", self.download_bytes),
                            ("lossless_cumsum_calls", self.cumsum_calls)):
            if value:
                trace.metrics.add(name, value)


def reconstruct_lanes(pred: int, res: torch.Tensor, dims) -> torch.Tensor:
    """The samples of lanes of one predictor on res's device: `res` (N,)
    int16 or int32 holds the lanes' residuals back to back, each
    row-major, lanes of one shape next to each other, and `dims` their (h,
    w). Gradient lanes go to K4 (ops/lossless_lanes.py:gradient_wavefront)
    in one launch; West and North lanes to one cumsum a shape. Returns
    (N,) int32 in the same layout."""
    from ..ops import lossless_lanes as LL

    if pred == _PRED_GRADIENT:
        return LL.gradient_wavefront(res, dims)
    lane = LL.cumsum_west if pred == _PRED_WEST else LL.cumsum_north
    out = torch.empty(res.numel(), dtype=torch.int32, device=res.device)
    pos = 0
    for (h, w), same in itertools.groupby(map(tuple, dims)):
        k = len(list(same))
        out[pos : pos + k * h * w] = lane(res[pos : pos + k * h * w].view(k, h, w)).view(-1)
        pos += k * h * w
    return out


def split_lanes(world, pred: int, res: torch.Tensor, dims) -> torch.Tensor:
    """reconstruct_lanes with the lanes split across the ranks of `world`
    (parallel/__init__.py): jxl_tpu's _program(..., mesh=) shards its
    lanes over devices, and every lane is independent, so no halo. Rank r
    takes the r-th of `world.size` runs of consecutive lanes of about
    equal counts, reconstructs them on its device, and the samples of all
    ranks are gathered in order: every rank returns the (N,) int32 samples
    of every lane, those of one rank's reconstruct_lanes bit for bit.
    `res` and `dims` are the whole set, the same on every rank; each rank
    reads only its share of `res`."""
    dims = [tuple(d) for d in dims]
    sizes = [h * w for h, w in dims]
    cuts = [len(dims) * r // world.size for r in range(world.size + 1)]
    a, z = cuts[world.rank], cuts[world.rank + 1]
    lo, hi = sum(sizes[:a]), sum(sizes[:z])
    if z > a:
        mine = reconstruct_lanes(pred, res[lo:hi].to(world.device), dims[a:z])
    else:
        mine = torch.zeros(0, dtype=torch.int32, device=world.device)
    return torch.cat(world.all_gather(mine))


def _reconstruct_host(data: np.ndarray, pred: int) -> None:
    """In-place host reconstruction of one channel's raw residuals."""
    if pred == _PRED_ZERO:
        return
    if pred == _PRED_WEST:
        col0 = np.cumsum(data[:, 0], dtype=np.int32)
        r0 = data[:, 0].copy()
        data[...] = np.cumsum(data, axis=1, dtype=np.int32)
        data += (col0 - r0)[:, None]
        return
    if pred == _PRED_NORTH:
        row0 = np.cumsum(data[0], dtype=np.int32)
        r0 = data[0].copy()
        data[...] = np.cumsum(data, axis=0, dtype=np.int32)
        data += (row0 - r0)[None, :]
        return
    from .. import native

    native.gradient_reconstruct(data)


def maybe_submit(local_buffers, tree, header, transform_steps, br,
                 stream_id, image_width, partial_out) -> bool:
    """The hook of decode_modular_subbitstream: True when the active
    BatchContext took the stream."""
    ctx = _active.get()
    if ctx is None:
        return False
    taken = ctx.submit(local_buffers, tree, header, transform_steps, br,
                       stream_id, image_width, partial_out)
    if not taken:
        # a stream the lanes cannot take (WP or context trees, local
        # transforms, oversize channels, tiny streams): the host decodes it
        with ctx._lock:
            ctx.px_ineligible += sum(b.data.size for b in local_buffers)
    return taken


def enabled(device) -> bool:
    """Whether a whole-frame Modular decode on `device` takes the lanes:
    JXL_TPU_DEV_LOSSLESS=1 yes on either device; 0 and auto (the default)
    no. auto is off on the card as on the CPU because the lanes lost there:
    chip_smoke.py's lossless phase decodes a 4K lane stream both ways on
    the H100, and the lanes' host steps (the amax scan, the packing, the
    write-back) cost more than the native loop's prediction (PERF.md §5).
    A later measurement that shows them winning gives auto its rule. The
    card probe (utils/devhealth.py) is not consulted: jxl_tpu routes here
    by device_fast and device_wins (jxl_tpu/modular/device_lossless.py:
    355-363), which on a card on the bus would take the lanes, and the
    card's own measurement found them losing."""
    return os.environ.get("JXL_TPU_DEV_LOSSLESS", "auto") == "1"
